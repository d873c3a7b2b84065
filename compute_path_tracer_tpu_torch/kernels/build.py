"""Build and load the port's CUDA kernels.

Every ``kernels/csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes``; no PyTorch
headers are compiled, so a cold build takes seconds.  The library lands in
``build/kernels/<hash>/libcpt_kernels.so`` under the repository root, keyed
by a hash of the sources and flags, and is written through a temporary file
and a rename so that concurrent first uses do not clash.

The floating-point flags are part of the kernels' semantics: no FMA
contraction and IEEE division and square root, so the kernels round like
their plain torch versions (see the note in each source).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from functools import lru_cache
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libcpt_kernels.so"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "-fmad=false", "-prec-div=true", "-prec-sqrt=true", "-ftz=false",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise FileNotFoundError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels are "
            "built on a machine with the CUDA toolkit")
    return str(path)


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / LIB_NAME


def build(verbose: bool = False) -> Path:
    """Compile the sources if their library is not built yet; returns its
    path.  ``verbose`` prints nvcc's register and spill report."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               *[str(s) for s in _sources() if s.suffix == ".cu"]]
        res = subprocess.run(cmd, capture_output=True, text=True, check=False)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
        if verbose:
            print(res.stdout + res.stderr, end="")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load once, and declare every entry point."""
    lib = ctypes.CDLL(str(build()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.cpt_megakernel_analytic
    fn.argtypes = [p, p, p, i, p, i, p, i, i, i, i, i, f, f, i, p]
    fn.restype = ctypes.c_int
    return lib
