"""Dense-map march probe on the card (JAX package:
``benchmarks/dense_probe.py``): what does evaluating every leaf at every tap
cost, with no branch on a guard?

    r = t(dense march) / t(t-culled march)

The JAX probe decided, with this ratio, whether moving the dense map's
transforms onto the TPU's matrix unit could pay: below 1.5 a stage 2 was
worth building, above 2.5 it could not reach the 1.5x bar.  On this card it
asks whether K3's guard branches are worth their cost.  The dense kernel
(kernels/probes.py:march_dense) walks the whole program staged in shared
memory, as K3 walks its per-warp lists, and gives the exact march's t and
id; it is held to them, and K3's exact march is timed beside it for
context.

Times the march only (one primary-ray cast at 1920x1080 on the 64-primitive
benchmark scene, t and id out), by CUDA events over the repeats after a
warm-up, in one process.  Run on a machine with an NVIDIA GPU:

    python -m compute_path_tracer_tpu_torch.benchmarks.dense_probe
"""

from __future__ import annotations

import json

import torch

from ..constants import FP
from ..kernels.march import march_rays
from ..kernels.probes import march_dense
from ..render.program import build_program, program_table
from .common import bench_scene, cuda_ms, probe_rays, require_card

W, H, N_PRIMS = 1920, 1080, 64
REPS = 20


def measure(reps: int = REPS) -> dict:
    """The probe's rows and summary on the card (JAX's fields)."""
    dev = torch.device("cuda")
    spec, params = bench_scene(N_PRIMS, dev)
    ro, rd = probe_rays(W, H, dev)
    prog = build_program(spec, "baked")
    table = program_table(prog, params, True)

    def cull():
        return march_rays(prog, table, ro, rd, t_cull=True, with_normal=False)

    def exact():
        return march_rays(prog, table, ro, rd, t_cull=False, with_normal=False)

    def dense():
        return march_dense(prog, table, ro, rd)

    rows = {"t_cull (current)": cuda_ms(cull, reps),
            "exact (K3, context)": cuda_ms(exact, reps),
            "dense plain-map": cuda_ms(dense, reps)}
    (t_c, i_c), (t_d, i_d) = cull(), dense()
    ratio = rows["dense plain-map"] / rows["t_cull (current)"]
    return {"rows": rows, "summary": {
        "ratio_dense_over_cull": ratio,
        "t_mismatch_frac": float(((t_c - t_d).abs() > 1e-3).float().mean()),
        "idx_mismatch_frac": float((i_c != i_d).float().mean()),
        "hit_frac": float((t_d <= FP).float().mean()),
        "verdict_hint": ("stage-2 MXU worth building" if ratio < 1.5 else
                         "MXU cannot reach 1.5x bar" if ratio > 2.5
                         else "borderline"),
    }}


def main() -> int:
    gpu = require_card("dense_probe")
    out = measure()
    for name, ms in out["rows"].items():
        print(json.dumps({"march": name, "ms": ms}), flush=True)
    print(json.dumps(dict(out["summary"], gpu=gpu)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
