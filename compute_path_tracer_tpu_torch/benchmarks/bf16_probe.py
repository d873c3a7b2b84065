"""bf16 march probe on the card (JAX package: ``benchmarks/bf16_probe.py``):
does bf16 arithmetic in the map buy the march anything?

A 12-sphere union marched 64 steps from t = 0.01 r for 64 reps r, the mean
landing t per ray (kernels/hw_probes.py:bf16_march), three ways:

  A. float32 map and t;
  B. a bf16 map (distances and min fold) with float32 t and hit test;
  C. bf16 end to end.

Every bf16 operation rounds to bf16 (scalar ``__nv_bfloat16``, one ray a
thread); the root is float32's, rounded.  Reports each variant's time, B's
and C's speed-up over A and their landing-t error against A, and each
variant's time at 64 reps over its time at 32 (about 2: no rep is hoisted
away).  4 tiles of (256, 128) rays (131,072 threads; the JAX probe's one
tile is 8 warps per SM here), by CUDA events over the repeats queued
behind a sleep (``common.queued_ms``), in one process.  Run on a machine
with an NVIDIA GPU:

    python -m compute_path_tracer_tpu_torch.benchmarks.bf16_probe
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..kernels.hw_probes import (
    BF16_H, BF16_REPS, BF16_VARIANTS, LANES, bf16_march)
from .common import queued_ms, require_card

TILES = 4
REPS = 10
NAMES = {"f32": "f32 map, f32 t", "map": "bf16 map, f32 t",
         "all": "bf16 end-to-end"}


def inputs(tiles: int = TILES, device="cuda", seed: int = 0, h: int = BF16_H):
    """The probe's rays from (0, 0, -3) into z > 0 and its spheres, per tile
    in its rng order (one tile of height h is bf16_probe.main's at H = h):
    ro, rd (tiles, 3, h, 128), spheres (tiles, 12, 4)."""
    r = np.random.default_rng(seed)
    ro = np.broadcast_to(np.array([0.0, 0.0, -3.0], np.float32).reshape(
        1, 3, 1, 1), (tiles, 3, h, LANES))
    rds, sphs = [], []
    for _ in range(tiles):
        d = r.normal(size=(3, h, LANES)).astype(np.float32)
        d[2] = np.abs(d[2]) + 0.5
        d /= np.linalg.norm(d, axis=0, keepdims=True)
        sph = np.zeros((12, 4), np.float32)
        sph[:, :3] = r.uniform(-4, 4, (12, 3))
        sph[:, 2] += 4.0
        sph[:, 3] = r.uniform(0.4, 1.0, 12)
        rds.append(d)
        sphs.append(sph)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (ro, np.stack(rds), np.stack(sphs)))


def measure(tiles: int = TILES, reps: int = REPS) -> dict:
    """JAX's rows per variant, with each variant's rep ratio."""
    ro, rd, sph = inputs(tiles)
    ms, outs, ratio = {}, {}, {}
    for v in BF16_VARIANTS:
        ms[v] = queued_ms(lambda v=v: bf16_march(ro, rd, sph, v), reps)
        half = queued_ms(lambda v=v: bf16_march(ro, rd, sph, v,
                                              reps=BF16_REPS // 2), reps)
        ratio[v] = ms[v] / half
        outs[v] = bf16_march(ro, rd, sph, v)
    rows = []
    for v in BF16_VARIANTS:
        row = {"variant": NAMES[v], "ms": ms[v],
               "reps_ratio_64_over_32": ratio[v]}
        if v != "f32":
            err = (outs[v] - outs["f32"]).abs().flatten()
            p50, p99 = torch.quantile(err, torch.tensor(
                [0.5, 0.99], device=err.device)).tolist()
            row.update(speedup_vs_f32=ms["f32"] / ms[v],
                       landing_t_err_p50=p50, landing_t_err_p99=p99,
                       landing_t_err_max=float(err.max()))
        rows.append(row)
    return {"rows": rows, "ms": ms, "reps_ratio": ratio,
            "summary": {"tiles": tiles, "tile": [BF16_H, LANES]}}


def main() -> int:
    gpu = require_card("bf16_probe")
    out = measure()
    for row in out["rows"]:
        print(json.dumps(row), flush=True)
    print(json.dumps(dict(out["summary"], gpu=gpu)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
