"""March diagnostics on the card (JAX package: ``benchmarks/diagnose.py``):
where do the marching kernel's cycles go?

Renders the benchmark scene at 1920x1080 with debug 4 (baked, t_cull) for a
range of bounce budgets: K2's STATS kernel writes each warp's statistics
(kernels/megakernel.py:MarchStats; JAX's are per tile), and this prints
their distributions over the warps: steps per warp (x), active shapes per
step (y / x), march work (y) and aux work (z, the normal taps' shapes), and
the work each added bounce costs.  A warp's cost is about the sum over its
steps of its active shapes.

``--relax`` measures the over-relaxed march (RELAX, ``omega`` 1.6) instead,
at 1920x1080, 8 bounces: a plain frame on the card counts its work
(``count=``) and its per-warp lists (``MarchStats``); the kernel's frame
must equal it bit for bit and the kernel's list lengths (``walk_stats``)
the plain model's; it prints RELAX's bound (``app/profiling.py:march_ops``,
``bound_ms``: the accumulator read and written and the table over the
memory rate, the counted FP32 work over the FP32 peak) beside the
kernel's time and K2's (omega 1) in the same process, and a JSON line.
Run on a machine with an NVIDIA GPU:

    python -m compute_path_tracer_tpu_torch.benchmarks.diagnose [--relax]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..app import profiling as pf
from ..app.profiling import group_stats
from ..constants import DEFAULT_FOV
from ..kernels import megakernel as mk
from ..kernels.megakernel import render_frame_megakernel
from ..render.program import build_program, program_table
from .common import bench_scene, cuda_ms, require_card

WIDTH, HEIGHT = 1920, 1080
N_PRIMS = 64
BOUNCES = (0, 1, 2, 4, 8)
OMEGA = 1.6
RELAX_BOUNCES = 8
MARCH = dict(geometry="baked", t_cull=True)


def relax_bound(spec, params, gpu: str) -> dict:
    """RELAX's work, bound and time at WIDTH x HEIGHT (see the module
    note); raises if the kernel's frame or lists differ from the plain
    frame's."""
    kw = dict(width=WIDTH, height=HEIGHT, bounces=RELAX_BOUNCES, omega=OMEGA,
              **MARCH)
    count, stats = {}, mk.MarchStats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = mk.render_frame_megakernel_plain(spec, params, None, 0, 0,
                                             count=count, stats=stats, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    before = mk.LAUNCHES["megakernel_march"]
    frame = render_frame_megakernel(spec, params, None, 0, 0, **kw)
    torch.cuda.synchronize()
    if mk.LAUNCHES["megakernel_march"] - before != 1:
        raise AssertionError("RELAX's frame did not launch the kernel")
    off = int((frame != plain).any(-1).sum())
    if off:
        raise AssertionError(f"RELAX's frame differs from the plain frame at "
                             f"{off} pixels")
    prog = build_program(spec, "baked")
    with torch.no_grad():
        table = program_table(prog, params, True)
    run = dict(frame=0, last_clear=0, bounces=RELAX_BOUNCES, fov=DEFAULT_FOV,
               aspect=WIDTH / HEIGHT, t_cull=True, debug=0)
    walk = torch.zeros(2 * (RELAX_BOUNCES + 1), dtype=torch.int64,
                       device=params.device)
    scratch = torch.zeros_like(frame)
    mk.launch_march(prog, table, scratch, omega=OMEGA, walk_stats=walk, **run)
    walk_k = walk.view(RELAX_BOUNCES + 1, 2).tolist()
    walk_p = stats.walk_lists().tolist()
    walk_p += [[0, 0]] * (RELAX_BOUNCES + 1 - len(walk_p))
    if walk_k != walk_p:
        raise AssertionError(f"RELAX's per-warp lists {walk_k} differ from the "
                             f"plain model's {walk_p}")
    relax_ms = cuda_ms(lambda: mk.launch_march(prog, table, scratch,
                                               omega=OMEGA, **run), 5)
    k2_ms = cuda_ms(lambda: mk.launch_march(prog, table, scratch, **run), 5)
    frame_bytes = HEIGHT * WIDTH * 3 * 4 * 2
    bound, by = pf.bound_ms(frame_bytes + 4 * prog.f_len,
                            pf.march_ops(count, prog), pf.fp32_peak())
    out = {"omega": OMEGA, "segments": int(count["segments"]),
           "taps": int(count["taps"]),
           "leaves": {str(k): int(v) for k, v in count.items()
                      if isinstance(k, int)},
           "bound_ms": bound, "bound_by": by, "ms": relax_ms, "k2_ms": k2_ms,
           "plain_ms": plain_ms, "lists": walk_k,
           "mean_list": [a / b if b else 0.0 for a, b in walk_k], "gpu": gpu}
    print(f"RELAX omega {OMEGA} at {WIDTH}x{HEIGHT}, {RELAX_BOUNCES} bounces: "
          f"{out['segments']} segments, {out['taps']} map taps, leaves "
          f"{out['leaves']}; bound {bound:.4f} ms ({by}); kernel "
          f"{relax_ms:.3f} ms, K2 (omega 1) {k2_ms:.3f} ms in this process "
          f"(x{relax_ms / k2_ms:.3f}); the frame and the lists equal the plain "
          f"frame's ({plain_ms:.1f} ms) [{gpu}]", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--relax", action="store_true",
                    help="RELAX's work, bound and time instead of debug 4")
    args = ap.parse_args(argv)
    gpu = require_card("diagnose")
    spec, params = bench_scene(N_PRIMS, torch.device("cuda"))
    if args.relax:
        print(json.dumps(relax_bound(spec, params, gpu)))
        return 0
    prev = None
    for bounces in BOUNCES:
        img = render_frame_megakernel(
            spec, params, width=WIDTH, height=HEIGHT, debug=4,
            bounces=bounces, frame=1, last_clear=1, geometry="baked",
            t_cull=True)
        per = group_stats(img)
        steps, acts, aux = per[:, 0], per[:, 1], per[:, 2]
        per_step = np.where(steps > 0, acts / np.maximum(steps, 1), 0.0)
        print(
            f"bounces={bounces}: steps/warp mean={steps.mean():6.1f} "
            f"p90={np.percentile(steps, 90):6.1f} max={steps.max():6.1f} | "
            f"act/step mean={per_step.mean():5.1f} "
            f"p90={np.percentile(per_step, 90):5.1f} | "
            f"march work={acts.mean():7.0f} aux work={aux.mean():7.0f}",
            flush=True,
        )
        if prev is not None:
            d = acts.mean() + aux.mean() - prev
            print(f"    marginal work for added bounces: {d:8.0f}")
        prev = acts.mean() + aux.mean()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
