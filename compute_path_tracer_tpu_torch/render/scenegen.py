"""Per-scene ``map()``/``bounds()`` closures and static tables derived from
the SceneSpec (JAX package: ``render/scenegen.py``).

The faithful geometry: every map tap re-derives each node's transform
(scale, translate, rotate) and un-scales the distance per shape and again
per union, in the reference's fold order (child unions, then shapes, the
first shape assigning; containers.rs:143-179, 244-252).  An AABB-culled
shape skips its whole block, assignment included (containers.rs:419-437).
The closures are unrolled over the spec in Python and evaluate whole
tensors of points; they are the torch oracle's map (render/reference.py).
The CUDA marching kernel interprets the same tree from a packed program
(render/program.py).

As in the JAX package, ``bounds()`` recurses into child unions in the map's
walk order, where the reference leaves nested checks uninitialised.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..constants import MAT_SIZE, MAX_DIST
from ..ops.aabb import aabb_hit, intersect_aabb
from ..ops.sdf import combine, rot3d, sd_cube, sd_octahedron, sd_plane, sd_sphere
from ..scene.compile import (
    OP_SMOOTH_UNION,
    OP_UNION,
    SceneSpec,
    ShapeSpec,
    TransformSpec,
    UnionSpec,
)
from ..scene.model import KIND_CUBE, KIND_OCTAHEDRON, KIND_PLANE, KIND_SPHERE
from ..vecmath import Vec3


def _p3(pv, slots) -> Vec3:
    return Vec3(pv[slots[0]], pv[slots[1]], pv[slots[2]])


def apply_transform(t: TransformSpec, p: Vec3, pv) -> Tuple[Vec3, torch.Tensor]:
    """p' = rot3D(p/s - pos/s, rot); returns (p', s) with s the node scale
    (data_structures.rs:45-55)."""
    s = pv[t.scale]
    inv = 1.0 / s
    p = p * inv
    p = p - _p3(pv, t.pos) * inv
    return rot3d(p, _p3(pv, t.rot)), s


def shape_distance(kind: int, q: Vec3, size):
    """Leaf SDF in its own frame; ``size`` is (r,), (bx, by, bz) or ()."""
    if kind == KIND_SPHERE:
        return sd_sphere(q, size[0])
    if kind == KIND_CUBE:
        return sd_cube(q, Vec3(*size))
    if kind == KIND_PLANE:
        return sd_plane(q)
    if kind == KIND_OCTAHEDRON:
        return sd_octahedron(q, size[0])
    raise ValueError(f"unknown shape kind {kind}")


def _eval_shape(ss: ShapeSpec, p_node: Vec3, pv, checks, acc_d, acc_i, op, k,
                index):
    q, s = apply_transform(ss.transform, p_node, pv)
    # finalise_scale (data_structures.rs:94-96)
    d = shape_distance(ss.kind, q, [pv[i] for i in ss.size]) * s
    i = torch.full_like(acc_i, ss.shape_id)
    cd, ci = combine(op, acc_d, acc_i, d, i, index, k)
    if ss.transform.aabb:
        g = checks[ss.shape_id]
        return torch.where(g, cd, acc_d), torch.where(g, ci, acc_i)
    return cd, ci


def _eval_union(us: UnionSpec, p: Vec3, pv, checks):
    p1, s = apply_transform(us.transform, p, pv)
    k = pv[us.smooth_k] if us.op == OP_SMOOTH_UNION else None
    acc_d = torch.full_like(p.x, MAX_DIST)
    acc_i = torch.full_like(p.x, -1, dtype=torch.int32)
    for cu in us.children_unions:
        cd, ci = _eval_union(cu, p1, pv, checks)
        acc_d, acc_i = combine(us.op, acc_d, acc_i, cd, ci, 1, k)
    for si, ss in enumerate(us.children_shapes):
        acc_d, acc_i = _eval_shape(ss, p1, pv, checks, acc_d, acc_i, us.op, k,
                                   si)
    return acc_d * s, acc_i


def make_map(spec: SceneSpec):
    """``map(p, pv, checks) -> (d, idx)``: the scene SDF and the int32 id of
    the winning shape (-1 = none).  ``checks`` holds one boolean tensor per
    shape id, or None for a shape whose guard is ``if (true)``; roots
    min-combine into the MAXHIT accumulator (sdf_editor.rs:192-210)."""

    def map_fn(p: Vec3, pv, checks):
        d = torch.full_like(p.x, MAX_DIST)
        i = torch.full_like(p.x, -1, dtype=torch.int32)
        for root in spec.roots:
            rd_, ri_ = _eval_union(root, p, pv, checks)
            d, i = combine(OP_UNION, d, i, rd_, ri_, 1)
        return d, i

    return map_fn


def make_bounds(spec: SceneSpec, with_t: bool = False):
    """``bounds(ro, rd, pv) -> (checks, debug)``.

    ``checks`` has one entry per shape id: the boolean AABB hit, or None for
    a shape without a box (data_structures.rs:57-66).  ``debug`` adds 0.1
    per hit in walk order like the reference's cube_debug
    (containers.rs:451-458).  ``with_t=True`` returns ``(checks, tns, tfs,
    debug)`` with each box's slab entry and exit distances."""

    def bounds_fn(ro: Vec3, rd: Vec3, pv):
        checks: list = [None] * spec.n_shapes
        tns: list = [None] * spec.n_shapes
        tfs: list = [None] * spec.n_shapes
        dbg = [torch.zeros_like(ro.x)]

        def walk(us: UnionSpec, pos_trail: Vec3, scale_trail):
            pos2 = pos_trail + _p3(pv, us.transform.pos)
            scale2 = scale_trail * pv[us.transform.scale]
            for cu in us.children_unions:
                walk(cu, pos2, scale2)
            for ss in us.children_shapes:
                if not ss.transform.aabb:
                    continue
                if ss.kind in (KIND_SPHERE, KIND_OCTAHEDRON):
                    so = Vec3.splat(pv[ss.size[0]])
                elif ss.kind == KIND_CUBE:
                    so = _p3(pv, ss.size)
                else:  # plane: the reference's unit box (data_structures.rs:73-76)
                    so = Vec3.splat(torch.ones_like(scale2))
                center = pos2 + _p3(pv, ss.transform.pos)
                half = so * (scale2 * pv[ss.transform.scale]) * pv[ss.transform.ex]
                tn, tf = intersect_aabb(ro, rd, center - half, center + half)
                hit = aabb_hit(tn, tf)
                checks[ss.shape_id] = hit
                tns[ss.shape_id] = tn
                tfs[ss.shape_id] = tf
                dbg[0] = dbg[0] + 0.1 * hit.to(dbg[0].dtype)

        zero = ro.x.new_zeros(())
        one = ro.x.new_ones(())
        for root in spec.roots:
            walk(root, Vec3.splat(zero), one)
        if with_t:
            return tuple(checks), tuple(tns), tuple(tfs), dbg[0]
        return tuple(checks), dbg[0]

    return bounds_fn


def material_slot_matrix(spec: SceneSpec) -> np.ndarray:
    """(n_shapes, 18) int32 matrix of parameter slots, row = shape id, columns
    in Mat(...) constructor order (data_structures.rs:178-194)."""
    rows = np.zeros((spec.n_shapes, MAT_SIZE), dtype=np.int32)
    for ss in spec.iter_shapes():
        rows[ss.shape_id] = ss.material
    return rows
