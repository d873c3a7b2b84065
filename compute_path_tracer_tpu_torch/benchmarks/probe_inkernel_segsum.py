"""The segment sum of the fused step's material cotangents on the card (JAX
package: ``benchmarks/probe_inkernel_segsum.py``).

The JAX probe asked whether Mosaic lowers an in-kernel one-hot matmul
accumulated over a sequential grid into one revisited (S, C) block: the
step that would let the fused train kernel reduce its per-bounce cotangent
planes itself instead of writing them out for XLA's one-hot matmuls.  On
this card the blocks run in no order, and the question is what the
reduction costs as a kernel of its own against the library call the fused
step makes today (``kernels/train.py:_segment_matmul``, ``index_add_`` per
bounce): segsum (kernels/grad_probes.py) against one
``Tensor.index_add_`` over the same elements, in three rows:

* the probe's: S = 64 segments, C = 28 channels, one 64x256 plane (B = 1),
  idx uniform in [-1, S) and cot normal from numpy's seed 0, as the probe
  makes them;
* K4's main configuration: B = 9 bounces, C = 13 material channels
  (``MAT_CHANNELS``), n = 1920x1080 lanes, S = the shapes of
  ``benchmark_scene(64)``; idx uniform in [-1, S) and cot normal, made on
  the card from a seed;
* K4's shape with clustered ids (``K4 clustered``): an id drawn uniform in
  [-1, S) once a run of 64 consecutive lanes of a plane, as a frame's
  winners come in runs along a row; the same cotangents.

Times by CUDA events over the repeats (the probe's shape queued behind a
sleep, ``common.queued_ms``), in one process; each call's allocations
and kernels count in its time (``index_add_``'s zeroed output too).  Run on a machine with an NVIDIA GPU:

    python -m compute_path_tracer_tpu_torch.benchmarks.probe_inkernel_segsum
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..kernels.grad_probes import segsum
from ..kernels.train import MAT_CHANNELS
from ..scene import benchmark_scene, compile_scene
from .common import cuda_ms, queued_ms, require_card

PROBE = dict(n_seg=64, n_ch=28, n_b=1, h=64, w=256)
K4_BOUNCES = 8
REPS = 20


def k4_shape() -> dict:
    """K4's main-configuration shape: (bounces + 1) planes of the 1080p
    frame, its material channels, the benchmark scene's shapes."""
    spec = compile_scene(benchmark_scene(64)).spec
    return dict(n_seg=spec.n_shapes, n_ch=len(MAT_CHANNELS),
                n_b=K4_BOUNCES + 1, h=1080, w=1920)


def inputs(shape, device="cuda", seed: int = 0):
    """idx (B, n) int32 uniform in [-1, S) and cot (B, C, n) float32
    standard normal; numpy's generator (the probe's) for a plane of at most
    a million elements, torch's on ``device`` above."""
    n_b, n_ch, n_seg = shape["n_b"], shape["n_ch"], shape["n_seg"]
    n = shape["h"] * shape["w"]
    if n_b * n_ch * n <= 1 << 20:
        r = np.random.default_rng(seed)
        idx = r.integers(-1, n_seg, size=(n_b, n)).astype(np.int32)
        cot = r.normal(size=(n_b, n_ch, n)).astype(np.float32)
        return torch.from_numpy(idx).to(device), torch.from_numpy(cot).to(device)
    g = torch.Generator(device=device).manual_seed(seed)
    idx = torch.randint(-1, n_seg, (n_b, n), generator=g, device=device,
                        dtype=torch.int32)
    cot = torch.randn((n_b, n_ch, n), generator=g, device=device)
    return idx, cot


def inputs_clustered(shape, device="cuda", seed: int = 0):
    """idx (B, n) int32 drawn uniform in [-1, S) once a run of 64
    consecutive lanes, and :func:`inputs`' cot."""
    _, cot = inputs(shape, device, seed)
    n_b, n_seg, n = shape["n_b"], shape["n_seg"], shape["h"] * shape["w"]
    g = torch.Generator(device=device).manual_seed(seed + 1)
    runs = torch.randint(-1, n_seg, (n_b, -(-n // 64)), generator=g,
                         device=device, dtype=torch.int32)
    return runs.repeat_interleave(64, dim=1)[:, :n].contiguous(), cot


def index_add_call(idx, cot, n_seg):
    """The library call: ``index_add_`` of every element's row into an
    (S + 1, C) zero block whose row 0 takes the dropped ids, given its
    inputs laid out as it takes them; returns a function of no arguments."""
    n_ch = cot.shape[1]
    rows = (idx.reshape(-1) + 1).to(torch.int64)
    src = cot.permute(0, 2, 1).reshape(-1, n_ch).contiguous()
    return lambda: torch.zeros((n_seg + 1, n_ch), device=cot.device
                               ).index_add_(0, rows, src)


def measure(reps: int = REPS, device="cuda") -> dict:
    """segsum and ``index_add_`` at the probe's shape and K4's, its ids
    uniform and clustered."""
    rows = {}
    k4 = k4_shape()
    for name, shape, make in (("probe", PROBE, inputs), ("K4", k4, inputs),
                              ("K4 clustered", k4, inputs_clustered)):
        idx, cot = make(shape, device)
        timer = queued_ms if name == "probe" else cuda_ms
        lib = index_add_call(idx, cot, shape["n_seg"])
        kern = timer(lambda: segsum(idx, cot, shape["n_seg"]), reps)
        ref = lib()[1:]
        got = segsum(idx, cot, shape["n_seg"])
        rows[name] = dict(shape, ms=kern, index_add_ms=timer(lib, reps),
                          rel_err=float((got - ref).abs().max()
                                        / ref.abs().max()))
        rows[name]["speedup_vs_index_add"] = rows[name]["index_add_ms"] / kern
        del idx, cot, lib
    return {"rows": rows}


def main() -> int:
    gpu = require_card("probe_inkernel_segsum")
    out = measure()
    for name, row in out["rows"].items():
        print(json.dumps(dict(row, shape_of=name, gpu=gpu)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
