"""Analytic-intersection probe on the card (JAX package:
``benchmarks/analytic_probe.py``): what do the guard-less shapes cost the
march?

The benchmark scene's guard-less shapes (the ground plane and two lamp
spheres) are evaluated at every map tap of every ray, and they are the only
primitives with trivial closed forms.  Variant: per ray, the nearest closed-
form hit t_cap over those shapes, the march of the map without them, and
each ray stopped at min(march hit, t_cap) (kernels/probes.py:march_capped,
K2b's cap on K3's march).  The JAX probe adopted the design above 1.15x;
K2b (``analytic_unboxed``) is that design on this card.

Prints the t-culled march (K3, the baseline) and the capped march times,
K3's exact march for context, the mismatch statistics and the mean length
of the capped kernel's per-warp lists (its ``walk_stats``) beside the plain
model's (``capped_list_lengths``); one primary-ray cast at 1920x1080 on
the 64-primitive benchmark scene, by CUDA events over the repeats after a
warm-up, in one process.  Run on a machine with an
NVIDIA GPU:

    python -m compute_path_tracer_tpu_torch.benchmarks.analytic_probe
"""

from __future__ import annotations

import json

import torch

from ..constants import FP
from ..kernels.march import march_rays
from ..kernels.probes import (capped_list_lengths, capped_program,
                              march_capped)
from ..render.program import build_program, program_table
from .common import bench_scene, cuda_ms, probe_rays, require_card

W, H, N_PRIMS = 1920, 1080, 64
REPS = 40


def measure(reps: int = REPS) -> dict:
    """The probe's rows and summary on the card (JAX's fields)."""
    dev = torch.device("cuda")
    spec, params = bench_scene(N_PRIMS, dev)
    ro, rd = probe_rays(W, H, dev)
    prog = build_program(spec, "baked")
    table = program_table(prog, params, True)
    cprog = capped_program(spec)
    ctable = program_table(cprog, params, True)

    def base():
        return march_rays(prog, table, ro, rd, t_cull=True,
                          with_normal=False)[0]

    def exact():
        return march_rays(prog, table, ro, rd, t_cull=False,
                          with_normal=False)[0]

    def capped():
        return march_capped(cprog, ctable, ro, rd)

    rows = {"t_cull march (baseline)": cuda_ms(base, reps),
            "exact march (K3, context)": cuda_ms(exact, reps),
            "analytic-capped march": cuda_ms(capped, reps)}
    # Clamp at the far plane: both marches agree a ray missed, but their
    # past-FP t are arbitrary.
    d = (torch.clamp(base(), max=FP + 1.0)
         - torch.clamp(capped(), max=FP + 1.0)).abs()
    q = torch.quantile(d, torch.tensor([0.5, 0.99], device=dev))
    ratio = rows["t_cull march (baseline)"] / rows["analytic-capped march"]
    walk = torch.zeros(2, dtype=torch.int64, device=dev)
    march_capped(cprog, ctable, ro, rd, walk_stats=walk)
    lengths = capped_list_lengths(cprog, ctable, ro, rd)
    return {"rows": rows, "summary": {
        "speedup": ratio,
        "t_diff_p50": float(q[0]), "t_diff_p99": float(q[1]),
        "t_diff_over_5mhd_frac": float((d > 5e-3).float().mean()),
        "verdict_hint": ("adopt for round-4 integration" if ratio > 1.15
                         else "joins the measured negatives"),
        "walk_stats": walk.tolist(),
        "mean_list": float(walk[0]) / float(walk[1]),
        "mean_list_model": float(lengths.double().mean()),
        "n_ops": int(cprog.ops.shape[0]),
    }}


def main() -> int:
    gpu = require_card("analytic_probe")
    out = measure()
    for name, ms in out["rows"].items():
        print(json.dumps({"variant": name, "ms": ms}), flush=True)
    print(json.dumps(dict(out["summary"], gpu=gpu)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
