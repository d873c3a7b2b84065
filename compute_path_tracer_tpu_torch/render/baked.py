"""Leaf-baked scene coefficients: fold transform chains out of the render.

Port of the JAX package's ``render/baked.py`` (``baked_layout``, ``bake``,
``analytic_all_plan``, the leaf distances and the baked map and bounds).
Every node transform ``q' = R((q - pos)/s)`` along a leaf's chain composes
into one affine map, and because every SDF is
positively homogeneous and every CSG combine commutes with positive scaling,
the chain folds into world-space leaf coefficients ``bv``: sphere centre and
radius, plane normal and offset, cube/octahedron frame and half-sizes, the
per-union MAXHIT seed / smooth k / fully-culled value, and each boxed shape's
world AABB (containers.rs:181-202, data_structures.rs:68-92).

The JAX ``bake`` is a scalar graph of ~50 ops per shape that XLA fuses into
the frame.  Run eagerly on a GPU that would be thousands of tiny launches per
frame, so here the same formulas are evaluated batched over all nodes of one
tree depth at a time: a few hundred tensor ops per frame whatever the shape
count, each element computed in the same order as the JAX scalar graph.  It
stays differentiable with respect to the parameter vector.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from ..constants import MAX_DIST
from ..ops.aabb import aabb_hit, intersect_aabb
from ..ops.sdf import combine, sd_cube, sd_octahedron
from ..scene.compile import (
    OP_SMOOTH_UNION,
    OP_SUBTRACTION,
    OP_UNION,
    SceneSpec,
    ShapeSpec,
    UnionSpec,
)
from ..scene.model import KIND_CUBE, KIND_OCTAHEDRON, KIND_PLANE, KIND_SPHERE
from ..scene.params import SENTINEL
from ..vecmath import Vec3

# -- static layout ------------------------------------------------------------


@dataclass(frozen=True)
class BakedShape:
    kind: int
    shape_id: int
    off: int           # geometry slots
    aabb_off: int      # 6 box slots, or -1 when the guard is `if (true)`
    aabb: bool


@dataclass(frozen=True)
class BakedUnion:
    op: int
    init_off: int      # world-scaled MAXHIT accumulator seed
    empty_off: int     # value of this union when every shape block is culled
    k_off: int         # world-scaled smooth-min k, or -1
    children_unions: Tuple["BakedUnion", ...]
    children_shapes: Tuple[BakedShape, ...]


@dataclass(frozen=True)
class BakedLayout:
    roots: Tuple[BakedUnion, ...]
    n_slots: int
    n_shapes: int


GEOM_SLOTS = {KIND_SPHERE: 4, KIND_CUBE: 15, KIND_PLANE: 4, KIND_OCTAHEDRON: 13}


@lru_cache(maxsize=None)
def baked_layout(spec: SceneSpec) -> BakedLayout:
    """Assign bv slot offsets in a deterministic walk (mirrored by bake)."""
    counter = [1]  # slot 0 is a sentinel, mirroring the reference DataArray

    def take(n):
        off = counter[0]
        counter[0] += n
        return off

    def walk_shape(ss: ShapeSpec) -> BakedShape:
        off = take(GEOM_SLOTS[ss.kind])
        aabb_off = take(6) if ss.transform.aabb else -1
        return BakedShape(
            kind=ss.kind, shape_id=ss.shape_id, off=off,
            aabb_off=aabb_off, aabb=ss.transform.aabb,
        )

    def walk_union(us: UnionSpec) -> BakedUnion:
        init_off = take(1)
        empty_off = take(1)
        k_off = take(1) if us.op == OP_SMOOTH_UNION else -1
        cu = tuple(walk_union(child) for child in us.children_unions)
        cs = tuple(walk_shape(child) for child in us.children_shapes)
        return BakedUnion(
            op=us.op, init_off=init_off, empty_off=empty_off, k_off=k_off,
            children_unions=cu, children_shapes=cs,
        )

    roots = tuple(walk_union(r) for r in spec.roots)
    return BakedLayout(roots=roots, n_slots=counter[0], n_shapes=spec.n_shapes)


@lru_cache(maxsize=None)
def analytic_all_plan(spec: SceneSpec):
    """Static plan for the full-analytic bounce: ``None`` when the tree has
    any non-union op, else ``(BakedShape, clobber_ids)`` rows in walk order,
    one per leaf that can ever be in a ray's map.  ``clobber_ids`` are the
    guarded ancestor FIRST shapes whose passing ``check[]`` removes this
    leaf from the fold (the reference's first-shape ASSIGN,
    containers.rs:244-252); a guard-less first shape clobbers statically, so
    its subtree is absent from the plan."""
    layout = baked_layout(spec)
    plan = []
    ok = [True]

    def walk(bu, clobber_ids, excluded):
        if bu.op != OP_UNION:
            ok[0] = False
            return
        sub_ids, sub_excl = clobber_ids, excluded
        if bu.children_shapes and bu.children_unions:
            s0 = bu.children_shapes[0]
            if s0.aabb:
                sub_ids = clobber_ids + (s0.shape_id,)
            else:
                sub_excl = True
        for cu in bu.children_unions:
            walk(cu, sub_ids, sub_excl)
        for bs in bu.children_shapes:
            if not excluded:
                plan.append((bs, clobber_ids))

    for root in layout.roots:
        walk(root, (), False)
    return tuple(plan) if ok[0] else None


# -- bake plan: the tree flattened into per-depth batches ----------------------


@dataclass(frozen=True)
class _Level:
    pos: np.ndarray      # (n, 3) param slots
    rot: np.ndarray      # (n, 3)
    scale: np.ndarray    # (n,)
    parent: np.ndarray   # (n,) row in the previous level (unused at depth 0)


@dataclass(frozen=True)
class _KindGroup:
    kind: int
    node: np.ndarray     # (n,) global node row of each shape
    size: np.ndarray     # (n, n_size) param slots (n_size 0, 1 or 3)
    boxed: np.ndarray    # (m,) rows of the group that carry an AABB
    ex: np.ndarray       # (m,) aabb_exaggeration slots of those rows


@dataclass(frozen=True)
class _UnionRow:
    node: int
    op: int
    k_slot: int          # param slot of smooth k, or -1
    children: Tuple[int, ...]  # rows of the child unions in the union list


@dataclass(frozen=True)
class _BakePlan:
    levels: Tuple[_Level, ...]
    groups: Tuple[_KindGroup, ...]
    unions: Tuple[_UnionRow, ...]   # post-order: children before parents
    perm: np.ndarray     # bv = cat(values in bake's emit order)[perm]


@lru_cache(maxsize=None)
def _bake_plan(spec: SceneSpec) -> _BakePlan:
    layout = baked_layout(spec)
    levels = []          # per depth: list of (TransformSpec, parent row)
    shapes = []          # (ShapeSpec, BakedShape, global node row)
    unions = []          # (UnionRow fields..., BakedUnion)

    def add_node(depth, t, parent):
        while len(levels) <= depth:
            levels.append([])
        levels[depth].append((t, parent))
        return depth, len(levels[depth]) - 1

    def walk_union(us, bu, depth, parent):
        me = add_node(depth, us.transform, parent)
        kids = tuple(walk_union(cu, bcu, depth + 1, me[1])
                     for cu, bcu in zip(us.children_unions,
                                        bu.children_unions))
        for cs, bcs in zip(us.children_shapes, bu.children_shapes):
            shapes.append((cs, bcs, add_node(depth + 1, cs.transform, me[1])))
        unions.append((me, us, bu, kids))
        return len(unions) - 1

    for root, broot in zip(spec.roots, layout.roots):
        walk_union(root, broot, 0, -1)

    starts = np.cumsum([0] + [len(lv) for lv in levels])

    def row(node):
        return int(starts[node[0]] + node[1])

    lv_out = tuple(
        _Level(
            pos=np.asarray([t.pos for t, _ in lv], np.int64).reshape(-1, 3),
            rot=np.asarray([t.rot for t, _ in lv], np.int64).reshape(-1, 3),
            scale=np.asarray([t.scale for t, _ in lv], np.int64),
            parent=np.asarray([p for _, p in lv], np.int64),
        )
        for lv in levels
    )
    union_rows = tuple(
        _UnionRow(node=row(me), op=us.op,
                  k_slot=us.smooth_k if bu.k_off >= 0 else -1,
                  children=kids)
        for me, us, bu, kids in unions
    )

    # Emit order (mirrored by bake): sentinel, union seeds, smooth ks, union
    # empties, then per kind the geometry rows and the boxed rows' AABBs.
    slots = [np.asarray([0])]
    slots.append(np.asarray([bu.init_off for _, _, bu, _ in unions]))
    slots.append(np.asarray([bu.k_off for _, _, bu, _ in unions
                             if bu.k_off >= 0]))
    slots.append(np.asarray([bu.empty_off for _, _, bu, _ in unions]))
    groups = []
    for kind in sorted({bs.kind for _, bs, _ in shapes}):
        rows = [(ss, bs, n) for ss, bs, n in shapes if bs.kind == kind]
        w = GEOM_SLOTS[kind]
        boxed = [i for i, (_, bs, _) in enumerate(rows) if bs.aabb]
        groups.append(_KindGroup(
            kind=kind,
            node=np.asarray([row(n) for _, _, n in rows], np.int64),
            size=np.asarray([ss.size for ss, _, _ in rows],
                            np.int64).reshape(len(rows),
                                              len(rows[0][0].size)),
            boxed=np.asarray(boxed, np.int64),
            ex=np.asarray([rows[i][0].transform.ex for i in boxed], np.int64),
        ))
        slots.append(np.concatenate(
            [np.arange(bs.off, bs.off + w) for _, bs, _ in rows]))
        slots.append(np.concatenate(
            [np.arange(rows[i][1].aabb_off, rows[i][1].aabb_off + 6)
             for i in boxed] or [np.zeros(0, np.int64)]))
    order = np.concatenate([s.astype(np.int64) for s in slots])
    if sorted(order.tolist()) != list(range(layout.n_slots)):
        raise AssertionError("bake plan does not cover every bv slot once")
    return _BakePlan(levels=lv_out, groups=tuple(groups),
                     unions=union_rows, perm=np.argsort(order))


@lru_cache(maxsize=32)
def _device_plan(spec: SceneSpec, device: torch.device):
    """The bake plan's index arrays as tensors on ``device``, made once per
    (spec, device) so a frame's bake issues no host-to-device copies."""
    plan = _bake_plan(spec)

    def t(a):
        return torch.as_tensor(a, dtype=torch.int64, device=device)

    levels = tuple((t(lv.pos), t(lv.rot), t(lv.scale), t(lv.parent))
                   for lv in plan.levels)
    groups = tuple((g.kind, t(g.node), t(g.size), t(g.boxed), t(g.ex))
                   for g in plan.groups)
    union_nodes = t([u.node for u in plan.unions])
    smooth = [i for i, u in enumerate(plan.unions) if u.k_slot >= 0]
    k_nodes = t([plan.unions[i].node for i in smooth])
    k_slots = t([plan.unions[i].k_slot for i in smooth])
    return levels, groups, union_nodes, smooth, k_nodes, k_slots, t(plan.perm)


# -- bake: pv -> bv, batched over the nodes of one depth ----------------------


def _mat_mul(a, b):
    """Batched 3x3 products, each entry summed in the JAX scalar order."""
    return (a[:, :, 0:1] * b[:, 0:1, :] + a[:, :, 1:2] * b[:, 1:2, :]
            + a[:, :, 2:3] * b[:, 2:3, :])


def _mat_vec(a, v):
    return (a[:, :, 0] * v[:, 0:1] + a[:, :, 1] * v[:, 1:2]
            + a[:, :, 2] * v[:, 2:3])


def _mat_t_vec(a, v):
    return (a[:, 0, :] * v[:, 0:1] + a[:, 1, :] * v[:, 1:2]
            + a[:, 2, :] * v[:, 2:3])


def _rot_matrix(rx, ry, rz):
    """R with R @ p == rot3d(p, rot): Rz @ Ry @ Rx in the element
    arrangement of shapes.glsl:34-68."""
    one = torch.ones_like(rx)
    zero = torch.zeros_like(rx)
    cx, sx = torch.cos(rx), torch.sin(rx)
    cy, sy = torch.cos(ry), torch.sin(ry)
    cz, sz = torch.cos(rz), torch.sin(rz)

    def m(*e):
        return torch.stack(e, dim=1).reshape(-1, 3, 3)

    rx_m = m(one, zero, zero, zero, cx, sx, zero, -sx, cx)
    ry_m = m(cy, zero, -sy, zero, one, zero, sy, zero, cy)
    rz_m = m(cz, sz, zero, -sz, cz, zero, zero, zero, one)
    return _mat_mul(rz_m, _mat_mul(ry_m, rx_m))


def _combine_scalar(op, acc, d, k):
    if op == OP_UNION:
        return torch.minimum(acc, d)
    if op == OP_SUBTRACTION:
        na = -acc
        return torch.where(na >= d, na, d)
    if op == OP_SMOOTH_UNION:
        h = torch.clamp(0.5 + 0.5 * (d - acc) / k, 0.0, 1.0)
        return d * (1.0 - h) + acc * h - k * h * (1.0 - h)
    raise ValueError(f"unknown CSG op {op}")


def bake(spec: SceneSpec, pv: torch.Tensor) -> torch.Tensor:
    """The baked geometry vector (float32, ``n_slots``) from the flat
    parameter vector, on ``pv``'s device; differentiable in ``pv``."""
    plan = _bake_plan(spec)
    levels, groups, union_nodes, smooth, k_nodes, k_slots, perm = (
        _device_plan(spec, pv.device))

    # Per node: composed affine (M, b), scale product S, and the reference's
    # AABB trails (positions summed unrotated, scales multiplied).
    outs = []
    prev = None
    for pos_i, rot_i, scale_i, parent_i in levels:
        n = scale_i.shape[0]
        if prev is None:
            M = torch.eye(3, dtype=pv.dtype, device=pv.device).expand(n, 3, 3)
            b = pv.new_zeros((n, 3))
            S = pv.new_ones((n,))
            pt = pv.new_zeros((n, 3))
            st = pv.new_ones((n,))
        else:
            M, b, S, pt, st = (x[parent_i] for x in prev)
        s = pv[scale_i]
        inv = 1.0 / s
        A = _rot_matrix(pv[rot_i[:, 0]], pv[rot_i[:, 1]], pv[rot_i[:, 2]]) \
            * inv[:, None, None]
        pos = pv[pos_i]
        prev = (_mat_mul(A, M), _mat_vec(A, b) - _mat_vec(A, pos), S * s,
                pt + pos, st * s)
        outs.append(prev)
    M_all, b_all, S_all, pt_all, st_all = (
        torch.cat([o[i] for o in outs]) for i in range(5))

    values = [pv.new_full((1,), SENTINEL)]
    init = MAX_DIST * S_all[union_nodes]
    k_all = pv[k_slots] * S_all[k_nodes]
    k_of = {u: k_all[j] for j, u in enumerate(smooth)}
    empties = []
    for u, row in enumerate(plan.unions):
        # Fully-culled value: the seed folded through the child unions'
        # empty values.
        acc = init[u]
        for c in row.children:
            acc = _combine_scalar(row.op, acc, empties[c], k_of.get(u))
        empties.append(acc)
    values += [init, k_all, torch.stack(empties)]

    for kind, node_i, size_i, boxed_i, ex_i in groups:
        Mf, bf, Sf = M_all[node_i], b_all[node_i], S_all[node_i]
        Mw = Mf * Sf[:, None, None]   # = R_combined for uniform scales
        bw = bf * Sf[:, None]
        size = pv[size_i]
        if kind == KIND_SPHERE:
            geo = torch.cat([-_mat_t_vec(Mw, bw), (size[:, 0] * Sf)[:, None]],
                            dim=1)
        elif kind == KIND_PLANE:
            # d = (M' p + b').y  ->  row 1 of M' and b'.y
            geo = torch.cat([Mw[:, 1, :], bw[:, 1:2]], dim=1)
        elif kind == KIND_CUBE:
            geo = torch.cat([Mw.reshape(-1, 9), bw, size * Sf[:, None]], dim=1)
        else:
            geo = torch.cat([Mw.reshape(-1, 9), bw, (size[:, 0] * Sf)[:, None]],
                            dim=1)
        values.append(geo.reshape(-1))
        node_b = node_i[boxed_i]
        hs = st_all[node_b] * pv[ex_i]
        if kind == KIND_CUBE:
            half = size[boxed_i] * hs[:, None]
        elif kind == KIND_PLANE:
            half = hs[:, None].expand(-1, 3)
        else:
            half = size[boxed_i][:, 0:1] * hs[:, None]
            half = half.expand(-1, 3)
        c = pt_all[node_b]
        values.append(torch.cat([c - half, c + half], dim=1).reshape(-1))
    return torch.cat(values)[perm]


# -- baked map / bounds -------------------------------------------------------


def leaf_distance(kind: int, p: Vec3, g):
    """World-space leaf SDF from its baked slots ``g[0..]`` (scalars or
    per-lane tensors): sphere centre and radius, plane row, or the cube /
    octahedron frame rows, offset and half-size."""
    if kind == KIND_SPHERE:
        return Vec3(p.x - g[0], p.y - g[1], p.z - g[2]).length_safe() - g[3]
    if kind == KIND_PLANE:
        return g[0] * p.x + g[1] * p.y + g[2] * p.z + g[3]
    q = Vec3(
        g[0] * p.x + g[1] * p.y + g[2] * p.z + g[9],
        g[3] * p.x + g[4] * p.y + g[5] * p.z + g[10],
        g[6] * p.x + g[7] * p.y + g[8] * p.z + g[11],
    )
    if kind == KIND_CUBE:
        return sd_cube(q, Vec3(g[12], g[13], g[14]))
    return sd_octahedron(q, g[12])


def _eval_union_baked(bu: BakedUnion, p: Vec3, bv, checks):
    acc_d = p.x * 0.0 + bv[bu.init_off]
    acc_i = torch.full_like(p.x, -1, dtype=torch.int32)
    k = bv[bu.k_off] if bu.k_off >= 0 else None
    for cu in bu.children_unions:
        cd, ci = _eval_union_baked(cu, p, bv, checks)
        acc_d, acc_i = combine(bu.op, acc_d, acc_i, cd, ci, 1, k)
    for si, bs in enumerate(bu.children_shapes):
        d = leaf_distance(bs.kind, p, bv[bs.off:bs.off + GEOM_SLOTS[bs.kind]])
        i = torch.full_like(acc_i, bs.shape_id)
        cd, ci = combine(bu.op, acc_d, acc_i, d, i, si, k)
        if bs.aabb:
            g = checks[bs.shape_id]
            cd, ci = torch.where(g, cd, acc_d), torch.where(g, ci, acc_i)
        acc_d, acc_i = cd, ci
    return acc_d, acc_i


def make_map_baked(spec: SceneSpec):
    """``map(p, bv, checks) -> (d, idx)`` over baked geometry: the faithful
    map's fold (render/scenegen.py) with world-space leaves, equal to it up
    to float rounding.  The JAX version's ``anyhit`` tile skips are left
    out: they are bit-identical to the per-lane guards."""
    layout = baked_layout(spec)

    def map_fn(p: Vec3, bv, checks):
        d = torch.full_like(p.x, MAX_DIST)
        i = torch.full_like(p.x, -1, dtype=torch.int32)
        for broot in layout.roots:
            rd_, ri_ = _eval_union_baked(broot, p, bv, checks)
            d, i = combine(OP_UNION, d, i, rd_, ri_, 1)
        return d, i

    return map_fn


def boxed_shapes(spec: SceneSpec) -> Tuple[BakedShape, ...]:
    """The shapes with an AABB guard, in the map's walk order (child unions
    first, then shapes)."""
    def shapes_of(bu):
        for cu in bu.children_unions:
            yield from shapes_of(cu)
        yield from bu.children_shapes

    return tuple(bs for broot in baked_layout(spec).roots
                 for bs in shapes_of(broot) if bs.aabb)


def make_bounds_baked(spec: SceneSpec, with_t: bool = False):
    """``bounds(ro, rd, bv) -> (checks, debug)`` reading the baked
    world-space boxes; the semantics of scenegen.make_bounds, including its
    ``with_t=True`` form."""
    boxed = boxed_shapes(spec)
    n = spec.n_shapes

    def bounds_fn(ro: Vec3, rd: Vec3, bv):
        checks: list = [None] * n
        tns: list = [None] * n
        tfs: list = [None] * n
        dbg = torch.zeros_like(ro.x)
        for bs in boxed:
            o = bs.aabb_off
            tn, tf = intersect_aabb(ro, rd, Vec3(bv[o], bv[o + 1], bv[o + 2]),
                                    Vec3(bv[o + 3], bv[o + 4], bv[o + 5]))
            hit = aabb_hit(tn, tf)
            checks[bs.shape_id] = hit
            tns[bs.shape_id] = tn
            tfs[bs.shape_id] = tf
            dbg = dbg + 0.1 * hit.to(dbg.dtype)
        if with_t:
            return tuple(checks), tuple(tns), tuple(tfs), dbg
        return tuple(checks), dbg

    return bounds_fn
