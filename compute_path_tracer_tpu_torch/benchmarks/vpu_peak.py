"""FP32 throughput probe on the card (JAX package: ``benchmarks/vpu_peak.py``):
how many float32 operations a second does a hand-written kernel retire?

Each element of ``TILES`` (64, 128) tiles runs ``width`` independent chains
of two fused multiply-adds, ``K`` times (kernels/hw_probes.py:vpu_chains).
With enough chains per thread the schedulers always find an independent
FMA, and the rate is the card's attainable FP32 rate, against the datasheet
peak ``app/profiling.py:fp32_peak`` reads off the card (SMs x 128 lanes x 2
x the max SM clock).  The JAX probe ran one tile, which on this card is two
warps per SM and would time latency, so the main path runs 16 tiles (about
31 warps per SM).

The inputs are x in [1, 2) from a seed (the JAX probe's are ones; values of
at least 1 keep the plain version's float64 multiply-add exact).  Times by
CUDA events over the repeats queued behind a sleep (``common.queued_ms``),
in one process.  Run on a machine with an NVIDIA GPU:

    python -m compute_path_tracer_tpu_torch.benchmarks.vpu_peak
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..app.profiling import fp32_peak
from ..kernels.hw_probes import LANES, VPU_H, VPU_ITERS, VPU_WIDTHS, vpu_chains
from .common import queued_ms, require_card

TILES = 16
REPS = 20


def inputs(tiles: int = TILES, device="cuda", seed: int = 0, h: int = VPU_H):
    """x (tiles, h, 128) float32 in [1, 2)."""
    r = np.random.default_rng(seed)
    return torch.from_numpy(
        (1.0 + r.random((tiles, h, LANES))).astype(np.float32)).to(device)


def measure(tiles: int = TILES, reps: int = REPS) -> dict:
    """Per chain width its time and rate; the best rate is the attainable
    one (JAX's fields)."""
    x = inputs(tiles)
    rows = {}
    for width in VPU_WIDTHS:
        ms = queued_ms(lambda w=width: vpu_chains(x, w, VPU_ITERS), reps)
        fma = 2 * width * VPU_ITERS * x.numel()
        rows[width] = {"chains": width, "ms": ms,
                       "gfma_per_s": fma / ms / 1e6,
                       "tflops": 2 * fma / ms / 1e9}
    best = max(rows.values(), key=lambda r: r["tflops"])
    peak = fp32_peak() / 1e12
    return {"rows": rows, "summary": {
        "attainable_tflops": best["tflops"], "best_chains": best["chains"],
        "fp32_peak_tflops": peak, "share_of_peak": best["tflops"] / peak,
        "tile": [VPU_H, LANES], "tiles": tiles, "fori_iters": VPU_ITERS}}


def main() -> int:
    gpu = require_card("vpu_peak")
    out = measure()
    for row in out["rows"].values():
        print(json.dumps(row), flush=True)
    print(json.dumps(dict(out["summary"], gpu=gpu)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
