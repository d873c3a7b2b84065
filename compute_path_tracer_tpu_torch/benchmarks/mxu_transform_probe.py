"""Tensor-core transform probe on the card (JAX package:
``benchmarks/mxu_transform_probe.py``): do the box shapes' row transforms
pay on the matrix unit?

For 32 box shapes, three row transforms each (oq = M ro + c, dq = M rd) and
the slab fold to the nearest hit, summed over 64 identical reps
(kernels/hw_probes.py), two ways:

  A. as float32 multiply-adds, the matrix in shared memory (``mxu_scalar``);
  B. on the tensor cores inside the kernel (``mxu_tensor``): WMMA TF32
     fragments in the 3xTF32 split for float32 accuracy, the product staged
     through shared memory, each thread folding its ray.

Reports both times, B's speed-up over A, the largest difference of their
sums and the share of rays off by ``mxu_tensor_diff``'s tolerance, and each
kernel's time at 64 reps over its time at 32 (about 2: no rep is hoisted
away).  16 tiles of (64, 128) rays, by CUDA events over the repeats
queued behind a sleep (``common.queued_ms``), in one process.  Run on a
machine with an NVIDIA GPU:

    python -m compute_path_tracer_tpu_torch.benchmarks.mxu_transform_probe
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..kernels.hw_probes import (
    LANES,
    MXU_H,
    MXU_REPS,
    MXU_SHAPES,
    mxu_matrices,
    mxu_scalar,
    mxu_tensor,
    mxu_tensor_diff,
)
from .common import queued_ms, require_card

TILES = 16
REPS = 20


def inputs(tiles: int = TILES, device="cuda", seed: int = 0, h: int = MXU_H,
           n_shapes: int = MXU_SHAPES):
    """The probe's normal ro, rd (tiles, 3, h, 128) and m (tiles, 10
    n_shapes), per tile in its rng order (one tile is
    mxu_transform_probe.main's), with its (128, 3) row matrices and offsets
    per tile: (ro, rd, m, mat, off)."""
    r = np.random.default_rng(seed)
    ro, rd, m = [], [], []
    for _ in range(tiles):
        ro.append(r.normal(size=(3, h, LANES)).astype(np.float32))
        rd.append(r.normal(size=(3, h, LANES)).astype(np.float32))
        m.append(r.normal(size=(n_shapes * 10,)).astype(np.float32))
    ro, rd, m = (torch.from_numpy(np.stack(a)).to(device) for a in (ro, rd, m))
    return (ro, rd, m, *mxu_matrices(m))


def measure(tiles: int = TILES, reps: int = REPS) -> dict:
    """JAX's rows for both kernels, with their rep ratios."""
    ro, rd, m, mat, off = inputs(tiles)
    calls = {"scalar": lambda r=MXU_REPS: mxu_scalar(ro, rd, m, r),
             "tensor": lambda r=MXU_REPS: mxu_tensor(ro, rd, mat, off,
                                                     MXU_SHAPES, r)}
    ms = {k: queued_ms(fn, reps) for k, fn in calls.items()}
    ratio = {k: ms[k] / queued_ms(lambda fn=fn: fn(MXU_REPS // 2), reps)
             for k, fn in calls.items()}
    a, b = calls["scalar"](), calls["tensor"]()
    err, off_share, flips = mxu_tensor_diff(b, a, MXU_REPS)
    rows = [{"variant": "scalar-closure FMAs", "ms": ms["scalar"],
             "reps_ratio_64_over_32": ratio["scalar"]},
            {"variant": "tensor-core batched transforms (3xTF32)",
             "ms": ms["tensor"], "reps_ratio_64_over_32": ratio["tensor"],
             "speedup_vs_scalar": ms["scalar"] / ms["tensor"],
             "max_abs_delta": float((b - a).abs().max()),
             "max_abs_delta_agreeing": err, "share_off": off_share,
             "hit_flip_share": flips}]
    return {"rows": rows, "ms": ms, "reps_ratio": ratio,
            "summary": {"tiles": tiles, "tile": [MXU_H, LANES],
                        "shapes": MXU_SHAPES, "reps": MXU_REPS}}


def main() -> int:
    gpu = require_card("mxu_transform_probe")
    out = measure()
    for row in out["rows"]:
        print(json.dumps(row), flush=True)
    print(json.dumps(dict(out["summary"], gpu=gpu)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
