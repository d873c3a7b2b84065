"""One fused forward-plus-adjoint bounce on the card (JAX package:
``benchmarks/probe_fused_bwd.py``).

The JAX probe asked whether Mosaic compiles a Pallas kernel whose body runs
``jax.vjp`` over one bounce of the renderer, the step toward moving the
training step's XLA shading sweep into the kernel.  On this card there is no
such compiler question: a CUDA kernel's adjoint is written by hand, and K4
(``kernels/csrc/train_fused.cu``, the fused training step) is the H100's
answer to "can the bounce's adjoint run in the kernel": its phase 2 runs the
adjoint of every bounce's shading per pixel, after phase 1's forward.  What
the probe keeps is the cost of one such bounce: the fused_bwd kernel
(kernels/grad_probes.py) on the probe's (64, 128) tile and over the whole
1920x1080 frame of such tiles, beside K4's kernel time per bounce of a
1080p step (its march configuration without the edge terms: 9 bounces of
forward and adjoint per launch).

The probe's loss, the sum over the hits of emit + thr_factor / ray_prob,
reads the hit mask and the materials only, so its gradient in the baked
vector is identically zero (the JAX probe prints ``grad_nonzero=0``); the
kernel writes that zero.  Times by CUDA events over the repeats (the tile's
queued behind a sleep, ``common.queued_ms``), in one process, on the
64-primitive benchmark scene.  Run on a machine with an NVIDIA GPU:

    python -m compute_path_tracer_tpu_torch.benchmarks.probe_fused_bwd
"""

from __future__ import annotations

import json

import torch

from ..kernels import train as tm
from ..kernels.grad_probes import (
    FRAME_RECT,
    TILE_RECT,
    fused_bwd_tables,
    launch_fused_bwd,
)
from ..render.baked import bake
from .common import bench_scene, cuda_ms, queued_ms, require_card

N_PRIMS = 64
K4_BOUNCES = 8
REPS = 20
K4_STEPS = 3


def k4_bounce_ms(spec, params, steps: int = K4_STEPS) -> float:
    """K4's kernel time per bounce of a 1080p step (march, no edge terms):
    the median launch time by CUDA events, over its bounces + 1."""
    w, h = FRAME_RECT[2], FRAME_RECT[3]
    target = torch.zeros((h, w, 3), device=params.device)
    step = tm.make_fused_value_and_grad(spec, target, width=w, height=h,
                                        bounces=K4_BOUNCES)
    step(params)
    torch.cuda.synchronize()
    orig, events = tm.launch_train_fused, []

    def timed(*a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig(*a, **kw)
        end.record()
        events.append((start, end))
        return out

    tm.launch_train_fused = timed
    try:
        for _ in range(steps):
            step(params)
        torch.cuda.synchronize()
    finally:
        tm.launch_train_fused = orig
    times = sorted(a.elapsed_time(b) for a, b in events)
    return times[len(times) // 2] / (K4_BOUNCES + 1)


def measure(reps: int = REPS, device="cuda") -> dict:
    """The probe's loss and gradient at its tile, and fused_bwd's time at
    the tile and over the 1080p frame beside K4's per bounce."""
    dev = torch.device(device)
    spec, params = bench_scene(N_PRIMS, dev)
    with torch.no_grad():
        bv = bake(spec, params)
    prog, table = fused_bwd_tables(spec, params, bv)
    n = bv.shape[0]
    rows = {
        "tile": queued_ms(lambda: launch_fused_bwd(prog, table, TILE_RECT, n),
                          reps),
        "frame": cuda_ms(lambda: launch_fused_bwd(prog, table, FRAME_RECT, n),
                         reps),
        "K4 per bounce": k4_bounce_ms(spec, params)}
    loss, grad = launch_fused_bwd(prog, table, TILE_RECT, n)
    pixels = FRAME_RECT[2] * FRAME_RECT[3]
    return {"rows": rows, "summary": {
        "loss": float(loss[0]), "grad_finite": bool(torch.isfinite(grad).all()),
        "grad_nonzero": int((grad != 0).sum()), "grad_size": n,
        "frame_ns_per_pixel": rows["frame"] * 1e6 / pixels,
        "k4_bounce_ns_per_pixel": rows["K4 per bounce"] * 1e6 / pixels,
        "frame_over_k4_bounce": rows["frame"] / rows["K4 per bounce"],
        "tiles_per_frame": pixels / (TILE_RECT[2] * TILE_RECT[3])}}


def main() -> int:
    gpu = require_card("probe_fused_bwd")
    out = measure()
    for name, ms in out["rows"].items():
        print(json.dumps({"kernel": name, "ms": ms}), flush=True)
    print(json.dumps(dict(out["summary"], gpu=gpu)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
