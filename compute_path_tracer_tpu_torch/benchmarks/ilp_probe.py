"""ILP probe on the card (JAX package: ``benchmarks/ilp_probe.py``): does a
second independent dependency chain per thread pay?

The JAX probe marched two (32, 128) half-tiles per program, one after the
other or interleaved in one loop, to see whether two chains close the
TPU's scheduling gap.  Here each thread marches two rays, ray i and ray i
+ 128 of a 256-ray block (kernels/probes.py:march_ilp): one after the other
(A, seq) or in one loop whose map walks the program once for both (B,
fused).  The thread count halves, so occupancy falls as the instruction-level
parallelism rises.  Both are the exact march (bit for bit K3's, which is
timed beside them for context, one ray per thread) over K3's per-warp walk
of the program staged in shared memory: seq walks K3's list of each 32
rays, fused one list per warp over the union of its two rays' guards; the
summary gives the mean length of both (``ilp_list_lengths``, the plain
model).

ratio = t(A) / t(B); the JAX probe integrated above 1.2 and closed the
hypothesis below 1.1.  One primary-ray cast at 1920x1080 on the
64-primitive benchmark scene, by CUDA events over the repeats after a
warm-up, in one process.  Run on a machine with an NVIDIA GPU:

    python -m compute_path_tracer_tpu_torch.benchmarks.ilp_probe
"""

from __future__ import annotations

import json

import torch

from ..kernels.march import march_rays
from ..kernels.probes import ilp_list_lengths, march_ilp
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
    table = program_table(prog, params, False)

    def seq():
        return march_ilp(prog, table, ro, rd, interleave=False)

    def fused():
        return march_ilp(prog, table, ro, rd, interleave=True)

    def exact():
        return march_rays(prog, table, ro, rd, t_cull=False,
                          with_normal=False)[0]

    rows = {"sequential rays (dep-chain baseline)": cuda_ms(seq, reps),
            "fused interleaved rays": cuda_ms(fused, reps),
            "one ray per thread (K3 exact, context)": cuda_ms(exact, reps)}
    ratio = (rows["sequential rays (dep-chain baseline)"]
             / rows["fused interleaved rays"])
    return {"rows": rows, "summary": {
        "speedup_fused_over_seq": ratio,
        "t_mismatch_frac": float(((seq() - fused()).abs() > 1e-3)
                                 .float().mean()),
        "verdict_hint": ("integrate in round 4" if ratio > 1.2 else
                         "ILP hypothesis closed negative" if ratio < 1.1
                         else "borderline"),
        "mean_list": ilp_list_lengths(prog, table, ro, rd),
        "n_ops": int(prog.ops.shape[0]),
    }}


def main() -> int:
    gpu = require_card("ilp_probe")
    out = measure()
    for name, ms in out["rows"].items():
        print(json.dumps({"variant": name, "ms": ms}), flush=True)
    print(json.dumps(dict(out["summary"], gpu=gpu)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
