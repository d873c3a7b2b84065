"""The work of a frame of the guarded march, counted on the frozen
renderer, and its costs: the yardstick of the kernels' rooflines.

The costs are frozen copies of the port's ``app/profiling.py`` (commit
8039d02): operations per executed item read off the CUDA sources, each add,
sub, mul, div, sqrt, min, max, abs and compare one.  The items are those
the configuration's march needs, per ray and not per warp: per ray
segment (one cast of a bounce) the slab test of every boxed shape; per map
tap (each march step and each of the 6 normal taps) the tap itself and
every leaf in the map at that tap (a boxed leaf whose guard passes and,
in the t-culled march, whose bounding interval holds the ray's t; every
leaf without a box).  Integer work, loads, the bounding-sphere intervals
and shading are not counted, so the bound is a lower one.
"""

from __future__ import annotations

import torch

from .tracer.render.baked import baked_shapes_in_order

SLAB_OPS = 26
TAP_OPS = 11
LEAF_OPS = {0: 12, 1: 39, 2: 7, 3: 32}  # sphere, cube, plane, octahedron
# The fused step's work beyond the map taps and leaves, per item: one
# bounce's replay with its adjoint, one leaf's slot partials by kind, and
# a primary ray's edge bookkeeping (slope, sigmoid, seed).
REPLAY_OPS = 180
PARTIAL_OPS = {0: 14, 1: 75, 2: 8, 3: 70}
EDGE_RAY_OPS = 40


def tally_segments(count: dict, n_rays: int) -> None:
    count["segments"] = count.get("segments", 0) + int(n_rays)


def make_tally_taps(spec, column):
    """``tally(count, active)``: one map call's taps, ``active`` the
    (n, n_boxed) guard of its points, whose column of shape ``s`` is
    ``column[s]``."""
    boxed, free = {}, {}
    for bs in baked_shapes_in_order(spec):
        if bs.shape_id in column:
            boxed.setdefault(bs.kind, []).append(column[bs.shape_id])
        else:
            free[bs.kind] = free.get(bs.kind, 0) + 1

    def tally(count: dict, active) -> None:
        n = active.shape[0]
        count["taps"] = count.get("taps", 0) + n
        for kind in set(boxed) | set(free):
            key = ("leaves", kind)
            evals = n * free.get(kind, 0)
            if kind in boxed:
                evals = evals + active[:, boxed[kind]].sum()
            count[key] = count.get(key, 0) + evals

    return tally


def march_ops(count: dict, spec) -> float:
    """FP32 operations of the counted items."""
    n_boxed = sum(1 for bs in baked_shapes_in_order(spec) if bs.aabb)
    ops = count.get("segments", 0) * n_boxed * SLAB_OPS
    ops += count.get("taps", 0) * TAP_OPS
    for kind, cost in LEAF_OPS.items():
        v = count.get(("leaves", kind), 0)
        ops += (int(v.item()) if isinstance(v, torch.Tensor) else int(v)) * cost
    return float(ops)


def fused_ops(count: dict, spec) -> float:
    """FP32 operations of the fused step's counted items: its march as
    :func:`march_ops`, each primary ray's edge term (a slab test of every
    boxed shape and its bookkeeping), each replay and each leaf's
    partials."""
    n_boxed = sum(1 for bs in baked_shapes_in_order(spec) if bs.aabb)
    ops = march_ops(count, spec)
    ops += count.get("edge_rays", 0) * (n_boxed * SLAB_OPS + EDGE_RAY_OPS)
    ops += count.get("replays", 0) * REPLAY_OPS
    for kind, cost in PARTIAL_OPS.items():
        ops += int(count.get(("partials", kind), 0)) * cost
    return float(ops)
