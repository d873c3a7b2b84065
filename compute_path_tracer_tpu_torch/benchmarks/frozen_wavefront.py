"""The wavefront renderer on the card (JAX package:
``benchmarks/frozen_wavefront.py``): bounce-synchronous path tracing with ray
compaction, and its measurement.

The JAX package froze this design in its round 2: on a TPU the compaction
glue between bounces cost more than the dead lanes it saved, and it keeps
it under ``benchmarks/`` as a correct alternative to the tile megakernel.
The same question on this card: K2 (``megakernel_march.cu``) keeps a
finished path's thread idle until its block ends, the wavefront moves the
live rays together at the cost of a compaction per bounce.

``render_frame_wavefront`` keeps JAX's signature (less ``interpret``) and
its frame: per bounce one launch of the bounce kernel
(kernels/wavefront.py) over the whole flat ray buffer, whose threads past
the live count return, then in torch the radiance scatter-add into the
image and the compaction of the survivors to the front of the buffer
(``compact``: a cumsum and an order-preserving scatter; ``compact_sorted``:
an argsort on direction octant x 8^3 origin cell).  The rays start in JAX's
tile-major order of 64x64 screen tiles (1080 rows pad to 1088).  Every ray
carries its RNG state and pixel, and each pixel has one ray, so neither the
order nor the scatter-add can change a sample: the frame is K2's faithful
exact frame bit for bit (a pixel's per-bounce scatter-add takes one nonzero
term; the other slots add +0.0).  No step reads the live count on the host.

The measurement (1920x1080, 8 bounces, ``benchmark_scene(64)``): ms per
frame by the host clock, the bounce kernels' summed device time and the
rest (glue) by CUDA events, the live count per bounce, the same with
``sort_rays=True``, and K2's faithful exact frame in the same process.  Run
on a machine with an NVIDIA GPU:

    python -m compute_path_tracer_tpu_torch.benchmarks.frozen_wavefront
"""

from __future__ import annotations

import json
import time
from functools import lru_cache, partial

import numpy as np
import torch

from ..constants import DEFAULT_BOUNCES, DEFAULT_FOV
from ..kernels import wavefront as wf
from ..kernels.megakernel import render_frame_megakernel
from ..render.program import build_program, program_table
from ..render.reference import camera_rays, running_mean
from ..scene.compile import SceneSpec
from .common import bench_scene, require_card

TILE = 64            # the rays start as 64x64 screen tiles (JAX's blocks)
W, H, BOUNCES, N_PRIMS = 1920, 1080, 8, 64
FRAMES = 5


@lru_cache(maxsize=8)
def _tile_pixels(width: int, height: int, device: torch.device):
    """JAX's tile-major ray order over the frame padded to whole tiles:
    ``(pixel, valid)``, the flat image index of each ray (0 for a padding
    ray) and whether it is in the frame."""
    ph, pw = -(-height // TILE) * TILE, -(-width // TILE) * TILE
    perm = (np.arange(ph * pw).reshape(ph // TILE, TILE, pw // TILE, TILE)
            .transpose(0, 2, 1, 3).reshape(-1))
    xs, ys = perm % pw, perm // pw
    valid = (xs < width) & (ys < height)
    pix = np.where(valid, ys * width + xs, 0)
    return (torch.as_tensor(pix, dtype=torch.int64, device=device),
            torch.as_tensor(valid, device=device))


def compact(ray, rng, pix, alive):
    """The live rays (``alive``, bool) moved to the front of the buffer in
    their order, the others behind them in theirs; returns ``(ray, rng,
    pix, k)``, ``k`` the live count as a (1,) int32 tensor on the device."""
    n = alive.shape[0]
    pos = torch.cumsum(alive, 0)
    k = pos[-1:]
    rank = torch.arange(1, n + 1, device=alive.device)
    dest = torch.where(alive, pos - 1, k + rank - pos - 1)
    return (torch.empty_like(ray).index_copy_(1, dest, ray),
            torch.empty_like(rng).index_copy_(0, dest, rng),
            torch.empty_like(pix).index_copy_(0, dest, pix),
            k.to(torch.int32))


def _cell(a):
    return ((a + 16.0) * 0.25).to(torch.int32).clamp(0, 7)


def compact_sorted(ray, rng, pix, alive):
    """``compact`` that also orders the live rays by direction octant and
    origin cell (8^3 cells over [-16, 16)^3), stably: JAX's binning, which
    makes a block's secondary rays coherent again."""
    octant = (ray[3] > 0).to(torch.int32) + 2 * (ray[4] > 0).to(torch.int32) \
        + 4 * (ray[5] > 0).to(torch.int32)
    cell = (_cell(ray[0]) * 8 + _cell(ray[1])) * 8 + _cell(ray[2])
    key = torch.where(alive, octant * 512 + cell, 1 << 30)
    order = torch.argsort(key, stable=True)
    k = alive.sum(dtype=torch.int32).reshape(1)
    return ray[:, order], rng[order], pix[order], k


def _wavefront_trace(spec: SceneSpec, params, frame, fov, aspect, *,
                     width: int, height: int, bounces: int,
                     sort_rays: bool = False, bounce=None):
    """Path-trace one frame; returns the flat (width * height, 3) radiance
    image.  ``bounce`` replaces ``wf.wavefront_bounce`` (the plain frame)."""
    device = params.device
    pix, valid = _tile_pixels(width, height, device)
    xs, ys = (pix % width).to(torch.int32), (pix // width).to(torch.int32)
    rng, ro, rd = camera_rays(xs, ys, frame, fov, aspect, width=width,
                              height=height)
    ones = torch.ones_like(ro.x)
    ray = torch.stack([*ro, *rd, ones, ones, ones])
    rng = rng.to(torch.int32)
    prog = build_program(spec, "faithful")
    with torch.no_grad():
        table = program_table(prog, params)
    image = torch.zeros((width * height, 3), dtype=torch.float32,
                        device=device)
    step = compact_sorted if sort_rays else compact
    ray, rng, pix, k = compact(ray, rng, pix, valid)
    for _ in range(bounces + 1):
        add, alive = (bounce or wf.wavefront_bounce)(prog, table, k, ray, rng)
        image.index_add_(0, pix, add)
        ray, rng, pix, k = step(ray, rng, pix, alive != 0)
    return image


def render_frame_wavefront(
    spec: SceneSpec,
    params: torch.Tensor,
    accum=None,
    frame: int = 0,
    last_clear: int = 0,
    *,
    width: int = 256,
    height: int = 256,
    debug: int = 0,
    bounces: int = DEFAULT_BOUNCES,
    fov: float = DEFAULT_FOV,
    aspect: float = None,
    sort_rays: bool = False,
    count: dict = None,
) -> torch.Tensor:
    """One progressive frame by the wavefront renderer on ``params``'
    device; returns the running mean with ``accum`` (a new tensor).  Debug
    modes other than 0 route to the tile megakernel (K2, faithful, as JAX
    routes them to ``render_frame_pallas``).  On a CUDA tensor each bounce
    launches the kernel; with ``count``, a dict, every bounce runs the plain
    version (``wavefront_bounce_plain``), on any device, and adds its work
    to ``count``."""
    if aspect is None:
        aspect = width / height
    if debug != 0:
        return render_frame_megakernel(
            spec, params, accum, frame, last_clear, width=width,
            height=height, debug=debug, bounces=bounces, fov=fov,
            aspect=aspect)
    bounce = (None if count is None
              else partial(wf.wavefront_bounce_plain, count=count))
    flat = _wavefront_trace(spec, params, frame, fov, aspect, width=width,
                            height=height, bounces=int(bounces),
                            sort_rays=sort_rays, bounce=bounce)
    img = flat.view(height, width, 3)
    if accum is None:
        accum = torch.zeros_like(img)
    return running_mean(accum, img, last_clear)


def _frame_times(fn, frames: int):
    """(host ms per frame, stream ms per frame by events, the bounce
    kernels' ms per frame, the live counts of the last frame) over
    ``frames`` frames after a warm-up: ``wf.wavefront_bounce``, which the
    renderer resolves at call time, is wrapped with CUDA events and keeps
    each launch's live count.  The stream time outside the bounce kernels
    is the glue's, and any wait for the host's launches."""
    fn()
    torch.cuda.synchronize()
    orig, rec = wf.wavefront_bounce, []

    def timed(prog, table, k, ray, rng):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig(prog, table, k, ray, rng)
        end.record()
        rec.append((start, end, k.clone()))
        return out

    wf.wavefront_bounce = timed
    try:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(frames):
            fn()
        end.record()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3 / frames
    finally:
        wf.wavefront_bounce = orig
    kernels = sum(a.elapsed_time(b) for a, b, _ in rec) / frames
    per = len(rec) // frames
    alive = [int(k) for _, _, k in rec[-per:]]
    return host, start.elapsed_time(end) / frames, kernels, alive


def measure(frames: int = FRAMES, device="cuda") -> dict:
    """The wavefront frame (unsorted and sorted) and K2's faithful exact
    frame at 1080p on the card."""
    dev = torch.device(device)
    spec, params = bench_scene(N_PRIMS, dev)
    kw = dict(width=W, height=H, bounces=BOUNCES)
    rows = {}
    for name, sort_rays in (("wavefront", False), ("wavefront sorted", True)):
        host, device, kernels, alive = _frame_times(
            lambda s=sort_rays: render_frame_wavefront(
                spec, params, frame=1, last_clear=1, sort_rays=s, **kw),
            frames)
        rows[name] = {"ms_per_frame": host, "device_ms": device,
                      "bounce_kernels_ms": kernels,
                      "glue_ms": device - kernels, "alive_per_bounce": alive}
    acc = torch.zeros((H, W, 3), device=dev)

    def k2():
        return render_frame_megakernel(spec, params, acc, 1, 1, **kw)

    k2()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(frames):
        k2()
    torch.cuda.synchronize()
    rows["K2 faithful exact"] = {
        "ms_per_frame": (time.perf_counter() - t0) * 1e3 / frames}
    wave = rows["wavefront"]
    return {"rows": rows, "summary": {
        "wavefront_over_k2": (wave["ms_per_frame"]
                              / rows["K2 faithful exact"]["ms_per_frame"]),
        "glue_share": wave["glue_ms"] / wave["device_ms"],
        "sorted_over_unsorted": (rows["wavefront sorted"]["ms_per_frame"]
                                 / wave["ms_per_frame"]),
        "width": W, "height": H, "bounces": BOUNCES, "n_prims": N_PRIMS}}


def main() -> int:
    gpu = require_card("frozen_wavefront")
    out = measure()
    for name, row in out["rows"].items():
        print(json.dumps(dict(row, path=name)), flush=True)
    print(json.dumps(dict(out["summary"], gpu=gpu)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
