"""Build and load the port's CUDA kernels.

Every ``kernels/csrc/*.cu`` is compiled by its own ``nvcc`` for ``sm_90a``,
all started together, and the objects are linked into one shared library
with a plain C interface, loaded with ``ctypes``; no PyTorch headers are
compiled, so a cold build takes seconds.  The library lands in
``build/kernels/<hash>/libcpt_kernels.so`` under the repository root, keyed
by a hash of the sources and flags, and is written through a temporary file
and a rename so that concurrent first uses do not clash.

The floating-point flags are part of the kernels' semantics: no FMA
contraction and IEEE division and square root, so the kernels round like
their plain torch versions (see the note in each source).

``ptxas -v``'s report (registers, stack frame, spills of every function)
is kept beside the library as ``ptxas.log``; ``ptxas_figures`` reads it,
and ``sass`` lists each kernel's machine code (``cuobjdump``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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
    "-Xcompiler", "-fPIC",
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
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        jobs = []
        for src in (s for s in _sources() if s.suffix == ".cu"):
            obj = os.path.join(tmp, src.stem + ".o")
            jobs.append((src.name, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs = [(name, proc.communicate()[0], proc.returncode)
                for name, _, proc in jobs]
        failed = [f"{name} ({rc}):\n{log}" for name, log, rc in logs if rc]
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        text = "".join(log for _, log, _ in logs)
        if verbose:
            print(text, end="")
        with open(os.path.join(tmp, "ptxas.log"), "w") as f:
            f.write(text)
        lib = os.path.join(tmp, LIB_NAME)
        res = subprocess.run([nvcc, "-shared", "-o", lib,
                              *[obj for _, obj, _ in jobs]],
                             capture_output=True, text=True, check=False)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        os.replace(os.path.join(tmp, "ptxas.log"), out.parent / "ptxas.log")
        os.replace(lib, out)
    return out


def ptxas_figures(lib: Path = None) -> dict:
    """:func:`parse_ptxas` of the report kept beside ``lib`` (the built
    library by default); empty when there is none."""
    log = Path(lib or library_path()).parent / "ptxas.log"
    return parse_ptxas(log.read_text()) if log.exists() else {}


def parse_ptxas(text: str) -> dict:
    """{kernel's mangled name: {"registers", "stack", "spill_stores",
    "spill_loads"}} from ``ptxas -v``'s report."""
    out, props = {}, {}
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            props[name] = dict(zip(("stack", "spill_stores", "spill_loads"),
                                   map(int, m.groups())))
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[entry] = {"registers": int(m.group(1))}
    for k, v in out.items():
        v.update(props.get(k, {}))
    return out


def sass(lib: Path = None) -> dict:
    """{kernel's mangled name: [its SASS instructions, in order]} of the
    built library (``lib`` by default), by ``cuobjdump -sass`` from nvcc's
    directory."""
    dump = subprocess.run(
        [str(Path(_nvcc()).parent / "cuobjdump"), "-sass",
         str(lib or library_path())],
        capture_output=True, text=True, check=True).stdout
    funcs, name = {}, None
    for line in dump.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if m and name:
            funcs[name].append(m.group(1).strip())
    return funcs


@lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load once, and declare every entry point."""
    lib = ctypes.CDLL(str(build()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.cpt_megakernel_analytic
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, f, f, i, p, p, i, p]
    fn.restype = ctypes.c_int
    fn = lib.cpt_quotient_check
    fn.argtypes = [p, p, p, i, p, p, p, p]
    fn.restype = ctypes.c_int
    fn = lib.cpt_megakernel_march
    fn.argtypes = ([p, i, p, i, i, i, i, i, i, f, p, i, i, i, i, i, i, i, f, f, i]
                   + [p, p, i, i, i, p, i, i, f, p, i, p, i, i, p])
    fn.restype = ctypes.c_int
    fn = lib.cpt_march_rays
    fn.argtypes = [p, i, p, i, i, i, i, i, i] + [p] * 11 + [i, p]
    fn.restype = ctypes.c_int
    fn = lib.cpt_march_dense
    fn.argtypes = [p, i, p, i, i, i] + [p] * 8 + [i, p]
    fn.restype = ctypes.c_int
    fn = lib.cpt_march_capped
    fn.argtypes = [p, i, p, i, i, i, i] + [p] * 8 + [i, p]
    fn.restype = ctypes.c_int
    fn = lib.cpt_march_ilp
    fn.argtypes = [p, i, p, i, i, i, i] + [p] * 7 + [i, p]
    fn.restype = ctypes.c_int
    fn = lib.cpt_vpu_chains
    fn.argtypes = [p, i, i, i, p, p]
    fn.restype = ctypes.c_int
    fn = lib.cpt_gather
    fn.argtypes = [i, i, p, p, i, i, p, p]
    fn.restype = ctypes.c_int
    fn = lib.cpt_bf16_march
    fn.argtypes = [i, p, p, p, i, i, i, i, p, p]
    fn.restype = ctypes.c_int
    fn = lib.cpt_bf16_roots
    fn.argtypes = [i, p, p, p]
    fn.restype = ctypes.c_int
    fn = lib.cpt_mxu_scalar
    fn.argtypes = [p, p, p, i, i, i, i, p, p]
    fn.restype = ctypes.c_int
    fn = lib.cpt_mxu_tensor
    fn.argtypes = [p, p, p, p, i, i, i, i, i, p, p]
    fn.restype = ctypes.c_int
    fn = lib.cpt_gather_root_check
    fn.argtypes = [p, p]
    fn.restype = ctypes.c_int
    fn = lib.cpt_mxu_rcp_check
    fn.argtypes = [p, p]
    fn.restype = ctypes.c_int
    fn = lib.cpt_wavefront_bounce
    fn.argtypes = [p, i, p, i, i, i, p, i, p, p, p, p, p, p, i, p]
    fn.restype = ctypes.c_int
    fn = lib.cpt_fused_bwd
    fn.argtypes = [p, i, p, i, i, i, i, i, i, i, i, i, i, f, f, p, p, i, p, i,
                   p]
    fn.restype = ctypes.c_int
    fn = lib.cpt_segsum
    fn.argtypes = [p, p, i, i, i, i, p, p, i, i, i, p]
    fn.restype = ctypes.c_int
    fn = lib.cpt_train_fused
    fn.argtypes = ([p, i, i, p, i, p, i, i, i, p, i, p, p, p, p, i] + [p] * 10
                   + [i] * 7 + [f] * 3 + [i, f, f, i, p, p])
    fn.restype = ctypes.c_int
    return lib
