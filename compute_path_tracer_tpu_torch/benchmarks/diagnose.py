"""March diagnostics on the card (JAX package: ``benchmarks/diagnose.py``):
where do the marching kernel's cycles go?

Renders the benchmark scene at 1920x1080 with debug 4 (baked, t_cull) for a
range of bounce budgets: K2's STATS kernel writes each warp's statistics
(kernels/megakernel.py:MarchStats; JAX's are per tile), and this prints
their distributions over the warps: steps per warp (x), active shapes per
step (y / x), march work (y) and aux work (z, the normal taps' shapes), and
the work each added bounce costs.  A warp's cost is about the sum over its
steps of its active shapes.  Run on a machine with an NVIDIA GPU:

    python -m compute_path_tracer_tpu_torch.benchmarks.diagnose
"""

from __future__ import annotations

import numpy as np
import torch

from ..app.profiling import group_stats
from ..kernels.megakernel import render_frame_megakernel
from .common import bench_scene, require_card

WIDTH, HEIGHT = 1920, 1080
N_PRIMS = 64
BOUNCES = (0, 1, 2, 4, 8)


def main() -> int:
    require_card("diagnose")
    spec, params = bench_scene(N_PRIMS, torch.device("cuda"))
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
