"""What a render cell's accumulator must hold at a sample of its pixels.

Each pixel of a progressive frame is one Monte-Carlo path from the pixel's
counter-based RNG stream (its coordinates and the frame counter), so the
reference traces only the sampled pixels, for every frame the window
rendered, all in one batch: lane ``l`` is pixel ``(xs[l], ys[l])`` at frame
``frames[l]`` on scene state ``states[l]``.  The scene is rebuilt here from
the configuration and the positions the traffic set, compiled and baked by
the frozen copy; the march is the oracle's over the baked geometry,
t-culled as the configuration's renderer asks (``tcull.py``).  A
configuration names this module as its renderer's ``reference``.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .count import make_tally_taps, march_ops, tally_segments
from .fastmap import make_flat_map
from .tracer import precision
from . import tcull
from .tracer.render.baked import bake
from .tracer.render.reference import (
    calc_normal,
    cast_ray,
    gather_material,
    trace_pixels,
)
from .tracer.render.scenegen import material_slot_matrix
from .tracer.scene.compile import compile_scene
from .tracer.scene.library import benchmark_scene

LANES_PER_BATCH = 1 << 20


def grid_shapes(scene):
    """The jittered grid primitives ``P0, P1, ...`` of a benchmark scene, in
    order: the shapes the edit traffic moves."""
    return [s for s in scene.iter_shapes() if s.name.startswith("P")]


def scene_state(scene_cfg: dict, positions=None):
    """``(spec, params)`` of the configuration's scene with the grid
    primitives ``positions`` ({index: (x, y, z)}) moved there."""
    scene = benchmark_scene(scene_cfg["n_prims"], seed=scene_cfg["seed"])
    shapes = grid_shapes(scene)
    for i, xyz in (positions or {}).items():
        shapes[i].transform.position.set(*xyz)
    compiled = compile_scene(scene)
    return compiled.spec, np.asarray(compiled.params, np.float32)


def trace_samples(spec, states, xs, ys, frames, state_ids, *, width: int,
                  height: int, bounces: int, fov: float, device,
                  options: dict, lowered: bool = False,
                  count=None) -> torch.Tensor:
    """One path a lane: ``(n, 3)`` float32 radiance of pixel ``(xs, ys)``
    at frame ``frames`` on the parameter vector ``states[state_ids]`` (the
    states share ``spec`` and their materials), as the program's
    ``render_frame_megakernel(**options)`` renders it: over the baked
    geometry, through the t-culled march (``tcull.py``) or, without
    ``t_cull``, the exact one; other options have no reference here.
    ``lowered=True`` runs the control: the march and shading state in
    bfloat16.  ``count``, a dict, receives the work the lanes' march needs
    (``count.py``; :func:`work_ops` prices it)."""
    opts = dict(options)
    if opts.pop("geometry", None) != "baked" or set(opts) - {"t_cull"}:
        raise ValueError(f"no reference here for the renderer options "
                         f"{options}")
    t_cull = bool(opts.get("t_cull", False))
    params = [torch.as_tensor(s, dtype=torch.float32, device=device)
              for s in states]
    mat_slots = torch.as_tensor(material_slot_matrix(spec), dtype=torch.int64,
                                device=device)
    mats = params[0][mat_slots]
    for p in params[1:]:
        if not torch.equal(p[mat_slots], mats):
            raise ValueError("the scene states differ in their materials")
    leaves = tcull.boxed_leaves(spec)
    cull = torch.tensor([leaf[4] for leaf in leaves], dtype=torch.bool,
                        device=device)
    column = {leaf[0]: j for j, leaf in enumerate(leaves)}
    baked = [bake(spec, p) for p in params]
    bvs = torch.stack(baked, 1)  # (slots, states)
    box = torch.stack([tcull.boxes(leaves, bv) for bv in baked])
    sph = torch.stack([tcull.bounding_spheres(leaves, bv) for bv in baked])
    aspect = width / height
    as_dev = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt,
                                           device=device).reshape(-1)
    xs, ys = as_dev(xs, torch.int32), as_dev(ys, torch.int32)
    frames, sids = as_dev(frames, torch.int64), as_dev(state_ids, torch.int64)
    one = len(states) == 1

    flat = make_flat_map(spec, column)
    if flat is None:
        raise ValueError("the reference's render takes a flat union")
    tally_taps = make_tally_taps(spec, column)

    def mapped(p, active, sid):
        if count is not None:
            tally_taps(count, active)
        return flat(p, bvs[:, 0] if one else bvs[:, sid], active)

    out = []
    ctx = precision.lowered() if lowered else contextlib.nullcontext()
    with torch.no_grad(), ctx:
        for s in range(0, xs.numel(), LANES_PER_BATCH):
            sl = slice(s, s + LANES_PER_BATCH)
            sid_all = sids[sl]
            live = {}

            def on_bounce(lanes):
                live["sid"] = sid_all[lanes]

            def bounds_fn(ro, rd):
                sid = live["sid"]
                chk, lo, hi = tcull.bounds(ro, rd, box[0] if one else box[sid],
                                           sph[0] if one else sph[sid])
                if count is not None:
                    tally_segments(count, ro.x.numel())
                return (chk, lo, hi, sid), None

            def full(p, c):
                return mapped(p, c[0], c[3])

            def march(ro, rd, c):
                if t_cull:
                    return tcull.cast(lambda p, a, rest: mapped(p, a, rest[0]),
                                      ro, rd, c, cull)
                return cast_ray(full, ro, rd, c)

            col = trace_pixels(
                bounds_fn, march,
                lambda p, _idx, c: calc_normal(full, p, c),
                lambda idx: gather_material(mats, idx),
                xs[sl], ys[sl], frames[sl], bounces, fov, aspect,
                width=width, height=height, debug=0, on_bounce=on_bounce)
            out.append(col.stack())
    return torch.cat(out).float()


def work_ops(count: dict, spec) -> float:
    """FP32 operations of the work :func:`trace_samples` counted."""
    return march_ops(count, spec)


def running_mean(samples: np.ndarray) -> np.ndarray:
    """The accumulator after a pixel's frames ``samples[:, 0], samples[:,
    1], ...`` ((pixels, frames, 3)) from a cleared start: ``accum * (1 - w)
    + img * w`` with ``w = 1 / (f + 1)``, each operation rounded to float32,
    the renderer's running mean (test_compute.glsl:242-245)."""
    samples = np.asarray(samples, np.float32)
    acc = np.zeros(samples[:, 0].shape, np.float32)
    for f in range(samples.shape[1]):
        w = np.float32(1.0) / np.float32(f + 1)
        acc = acc * (np.float32(1.0) - w) + samples[:, f] * w
    return acc


def rel_l1(got: np.ndarray, want: np.ndarray) -> float:
    """``sum |got - want| / sum |want|`` over every sampled channel; NaN in
    ``got`` reads as infinitely far."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if not np.all(np.isfinite(got)):
        return float("inf")
    return float(np.abs(got - want).sum() / max(np.abs(want).sum(), 1e-30))
