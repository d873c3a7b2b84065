"""The scene's ``map()`` as a packed CSG program, for the marching kernel.

The JAX package unrolls each scene's map into its Pallas kernel at trace
time.  The port instead flattens the SceneSpec once into an int32 op list
(``build_program``, cached per spec and geometry) that one compiled CUDA
kernel (kernels/csrc/megakernel_march.cu) interprets for every scene, so a
structure edit costs no compile.  Each op is a record of ``OP_WIDTH`` ints:

* ``ENTER``  ``[0, xform, init, 0, ...]``: push the accumulator (and, in
  faithful geometry, the point), transform the point into the union's frame
  (record ``xform``, or none when -1) and seed the accumulator with
  ``F[init]`` (baked) or MAX_DIST (when -1);
* ``SHAPE``  ``[1, kind, geom, box, shape_id, fold, k, cull]``: when box
  guard ``box`` passes (always when -1), evaluate the leaf (faithful: record
  ``geom`` transforms the point and holds the size; baked: ``F[geom..]``
  holds the world-space slots) and fold it into the accumulator: ``fold``
  -1 assigns (the first shape), else it is the union's op with smooth ``k =
  F[k]``.  ``cull`` is 1 when the t-culled march may drop the shape outside
  its box interval (see ``cast_tcull``), and repeats ``box_cull[box]``;
* ``LEAVE``  ``[2, scale, fold, k, 0, ...]``: un-scale the union's result by
  ``F[scale]`` (faithful; none when -1), pop, and fold it into the parent
  with the parent's op (a root folds into the scene with a union).

``program_table`` fills the float table ``F`` per frame on the params'
device: the faithful node records (``XFORM`` floats: s, 1/s, pos/s, the
cos/sin pairs of the three rotation angles, then the size or smooth k) or
the baked vector; then per guarded shape, in walk order, its AABB (the
reference's box, which decides the guard) and, for the t-culled march, a
sphere that bounds the leaf itself; then the materials.  Faithful trig is computed here once per frame, so the kernel
and the plain interpreter read the same cos/sin and agree bit for bit.

``make_map_program`` / ``program_bounds`` / ``cast_tcull`` are the plain
torch versions of the kernel's map, guards and per-thread t-culled march.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..constants import BIG, FP, MAT_SIZE, MAX_DIST, MHD, STEPS
from ..ops.aabb import aabb_hit, intersect_aabb
from ..ops.sdf import combine, rot3d_cs
from ..scene.compile import OP_SMOOTH_UNION, OP_UNION, SceneSpec
from ..scene.model import KIND_CUBE, KIND_PLANE, KIND_SPHERE
from ..vecmath import Vec3, sqrt_rn
from .baked import GEOM_SLOTS, bake, baked_layout, leaf_distance
from .reference import take_lanes
from .scenegen import material_slot_matrix, shape_distance

OPC_ENTER, OPC_SHAPE, OPC_LEAVE = 0, 1, 2
OP_WIDTH = 8
FOLD_ASSIGN = -1
XFORM = 14        # floats per faithful node record
MAX_DEPTH = 16    # union nesting the kernel's per-thread stack holds
MAX_BOXED = 256   # guarded shapes the kernel's per-thread guard arrays hold


@dataclass(frozen=True, eq=False)
class Program:
    spec: SceneSpec
    geometry: str
    ops: np.ndarray        # (n_ops, OP_WIDTH) int32
    box_cull: np.ndarray   # (n_boxed,) int32: 1 where t-culling may drop it
    box_leaf: np.ndarray   # (n_boxed, 2): kind, baked slot offset
    depth: int             # deepest union nesting
    n_boxed: int
    f_box: int             # F offsets: boxes (n_boxed, 6), bounding spheres
    f_sph: int             # (n_boxed, 4: centre, radius), materials (n, 18)
    f_mat: int
    f_len: int
    # per-frame recipes, as parameter slots (n_params = 0.0, +1 = 1.0)
    node_slots: np.ndarray  # faithful (n_nodes, 10): scale, pos 3, rot 3, size 3
    box_chain: np.ndarray   # faithful (n_boxed, depth+1, 4): pos 3, scale
    box_size: np.ndarray    # faithful (n_boxed, 4): size 3, exaggeration
    box_gather: np.ndarray  # baked (n_boxed, 6) bv slots

    @property
    def n_shapes(self) -> int:
        return self.spec.n_shapes


@lru_cache(maxsize=None)
def build_program(spec: SceneSpec, geometry: str) -> Program:
    """Flatten ``spec`` for ``geometry`` ("faithful" or "baked")."""
    if geometry not in ("faithful", "baked"):
        raise ValueError("geometry must be 'faithful' or 'baked'")
    baked = geometry == "baked"
    zero, one = spec.n_params, spec.n_params + 1
    ops, nodes, chains, sizes, gathers, culls, leaves = ([] for _ in range(7))
    depth = [0]

    def node(t, size):
        size = tuple(size) + (zero,) * (3 - len(size))
        nodes.append((t.scale, *t.pos, *t.rot, *size))
        return XFORM * (len(nodes) - 1)

    def walk(us, bu, parent_fold, parent_k, chain, level, min_path):
        depth[0] = max(depth[0], level)
        min_path = min_path and us.op == OP_UNION
        smooth = us.op == OP_SMOOTH_UNION
        rec = node(us.transform, (us.smooth_k,) if smooth else ())
        chain = chain + ((*us.transform.pos, us.transform.scale),)
        k = (bu.k_off if baked else rec + 11) if smooth else -1
        ops.append([OPC_ENTER, -1 if baked else rec,
                    bu.init_off if baked else -1, 0, 0, 0, 0, 0])
        for cu, bcu in zip(us.children_unions, bu.children_unions):
            walk(cu, bcu, us.op, k, chain, level + 1, min_path)
        for si, (ss, bs) in enumerate(zip(us.children_shapes,
                                          bu.children_shapes)):
            srec = node(ss.transform, ss.size)
            box = -1
            # Only a bounded shape whose value reaches the scene through min
            # folds alone may leave the map away from it: dropping a
            # subtraction's or a smooth union's operand, or a clobbering
            # first shape, changes the fold itself.
            cull = int(min_path and ss.kind != KIND_PLANE
                       and not (si == 0 and us.children_unions))
            if ss.transform.aabb:
                box = len(chains)
                t = ss.transform
                chains.append(chain + ((*t.pos, t.scale),))
                if ss.kind == KIND_CUBE:
                    so = ss.size
                elif ss.kind == KIND_PLANE:  # the reference's unit box
                    so = (one,) * 3
                else:
                    so = (ss.size[0],) * 3
                sizes.append((*so, t.ex))
                gathers.append(range(bs.aabb_off, bs.aabb_off + 6))
                culls.append(cull)
                leaves.append((ss.kind, bs.off))
            ops.append([OPC_SHAPE, ss.kind, bs.off if baked else srec, box,
                        ss.shape_id, FOLD_ASSIGN if si == 0 else us.op, k,
                        cull if box >= 0 else 0])
        ops.append([OPC_LEAVE, -1 if baked else rec, parent_fold, parent_k,
                    0, 0, 0, 0])

    for root, broot in zip(spec.roots, baked_layout(spec).roots):
        walk(root, broot, OP_UNION, -1, (), 1, True)

    n_boxed = len(chains)
    if depth[0] > MAX_DEPTH:
        raise ValueError(f"the scene nests unions {depth[0]} deep; the "
                         f"marching kernel's stack holds MAX_DEPTH={MAX_DEPTH}")
    if n_boxed > MAX_BOXED:
        raise ValueError(f"the scene has {n_boxed} AABB-guarded shapes; the "
                         f"marching kernel holds MAX_BOXED={MAX_BOXED}")
    chain_len = depth[0] + 1
    box_chain = np.full((n_boxed, chain_len, 4), zero, np.int64)
    box_chain[..., 3] = one
    for j, c in enumerate(chains):
        box_chain[j, :len(c)] = c
    f_box = baked_layout(spec).n_slots if baked else XFORM * len(nodes)
    f_sph = f_box + 6 * n_boxed
    f_mat = f_sph + 4 * n_boxed
    return Program(
        spec=spec, geometry=geometry,
        ops=np.asarray(ops, np.int32).reshape(-1, OP_WIDTH),
        box_cull=np.asarray(culls, np.int32),
        box_leaf=np.asarray(leaves, np.int64).reshape(-1, 2),
        depth=depth[0], n_boxed=n_boxed, f_box=f_box, f_sph=f_sph, f_mat=f_mat,
        f_len=f_mat + MAT_SIZE * spec.n_shapes,
        node_slots=np.asarray(nodes, np.int64).reshape(-1, 10),
        box_chain=box_chain,
        box_size=np.asarray(sizes, np.int64).reshape(-1, 4),
        box_gather=np.asarray([list(g) for g in gathers],
                              np.int64).reshape(-1, 6),
    )


class _OnDevice(NamedTuple):
    """A program's index arrays on one device."""

    nodes: torch.Tensor      # node_slots
    chain: torch.Tensor      # box_chain
    size: torch.Tensor       # box_size
    gather: torch.Tensor     # box_gather
    mat_slots: torch.Tensor  # (n_shapes, 18) material slots
    code: torch.Tensor       # int32: ops, flattened, then box_cull
    cull: torch.Tensor       # bool box_cull
    spheres: tuple           # (kind, rows, (n, slots) bv offsets) per kind
    consts: torch.Tensor     # float32 [0.0, 1.0], the slots past the params


@lru_cache(maxsize=32)
def _on_device(prog: Program, device: torch.device) -> _OnDevice:
    """The program's index arrays as tensors on ``device``, made once so
    that a frame issues no host-to-device copy."""
    def t(a):
        return torch.as_tensor(a, dtype=torch.int64, device=device)

    code = np.concatenate([prog.ops.reshape(-1), prog.box_cull])
    spheres = []
    for kind in np.unique(prog.box_leaf[:, 0]):
        rows = np.nonzero((prog.box_leaf[:, 0] == kind) & (prog.box_cull != 0))[0]
        if len(rows):
            offs = prog.box_leaf[rows, 1][:, None] + np.arange(GEOM_SLOTS[kind])
            spheres.append((int(kind), t(rows), t(offs)))
    return _OnDevice(t(prog.node_slots), t(prog.box_chain), t(prog.box_size),
                     t(prog.box_gather), t(material_slot_matrix(prog.spec)),
                     torch.as_tensor(code, dtype=torch.int32, device=device),
                     torch.as_tensor(prog.box_cull != 0, device=device),
                     tuple(spheres),
                     torch.tensor([0.0, 1.0], dtype=torch.float32, device=device))


# Bounding spheres are inflated to cover float rounding and the MHD shell in
# which a hit fires just outside a surface.
_SPHERE_SLACK = (1e-5, 2.0 * MHD)


def _bounding_spheres(prog: Program, bv: torch.Tensor) -> torch.Tensor:
    """(n_boxed, 4) world-space centre and radius of each t-cullable
    leaf, from its baked slots (zero rows elsewhere).  A cube's or an
    octahedron's frame rows are orthonormal times one scale, so its centre
    is -M^T b."""
    out = bv.new_zeros((prog.n_boxed, 4))
    for kind, rows, offs in _on_device(prog, bv.device).spheres:
        g = bv[offs]
        if kind == KIND_SPHERE:
            c, r = g[:, :3], g[:, 3]
        else:
            m = g[:, :9].reshape(-1, 3, 3)
            c = -(m.transpose(1, 2) @ g[:, 9:12, None])[..., 0]
            r = (torch.linalg.vector_norm(g[:, 12:15], dim=1)
                 if kind == KIND_CUBE else g[:, 12])
        out[rows] = torch.cat(
            [c, (r * (1.0 + _SPHERE_SLACK[0]) + _SPHERE_SLACK[1])[:, None]], 1)
    return out


def program_table(prog: Program, params: torch.Tensor,
                  t_cull: bool = False) -> torch.Tensor:
    """The per-frame float32 table ``F`` (``prog.f_len``) on ``params``'
    device; a few tens of batched ops whatever the scene size.  The bounding
    spheres are filled only for ``t_cull`` (zeros otherwise: the exact march
    does not read them)."""
    dev = _on_device(prog, params.device)
    parts = []
    bv = bake(prog.spec, params) if prog.geometry == "baked" or t_cull else None
    if prog.geometry == "baked":
        parts += [bv, bv[dev.gather].reshape(-1)]
    else:
        nodes, chain, size = dev.nodes, dev.chain, dev.size
        pv = torch.cat([params, dev.consts])
        s = pv[nodes[:, 0]]
        inv = 1.0 / s
        rot = pv[nodes[:, 4:7]]
        cs = torch.stack([torch.cos(rot), torch.sin(rot)], dim=2).reshape(-1, 6)
        parts.append(torch.cat([s[:, None], inv[:, None],
                                pv[nodes[:, 1:4]] * inv[:, None], cs,
                                pv[nodes[:, 7:10]]], dim=1).reshape(-1))
        # Boxes from the reference's trails: positions summed unrotated,
        # scales multiplied, in walk order (scenegen.make_bounds).
        c = pv.new_zeros((prog.n_boxed, 3))
        st = pv.new_ones((prog.n_boxed,))
        for lv in range(chain.shape[1]):
            c = c + pv[chain[:, lv, :3]]
            st = st * pv[chain[:, lv, 3]]
        half = (pv[size[:, :3]] * st[:, None]) * pv[size[:, 3]][:, None]
        parts.append(torch.cat([c - half, c + half], dim=1).reshape(-1))
    parts.append(_bounding_spheres(prog, bv).reshape(-1) if t_cull
                 else params.new_zeros(4 * prog.n_boxed))
    parts.append(params[dev.mat_slots].reshape(-1))
    table = torch.cat(parts).to(torch.float32)
    if table.shape[0] != prog.f_len:
        raise AssertionError(f"table of {table.shape[0]} floats, program "
                             f"expects {prog.f_len}")
    return table


def program_code_on(prog: Program, device) -> torch.Tensor:
    """What the kernel reads as its program, on ``device`` (cached): the
    op records, flattened, then ``box_cull``, as one int32 vector."""
    return _on_device(prog, torch.device(device)).code


# -- plain versions of the kernel's map, guards and march ---------------------


def _xform(p: Vec3, r) -> Vec3:
    """apply_transform (scenegen) from a node record: p*inv - pos*inv, then
    the rotation from its stored cos/sin."""
    q = Vec3(p.x * r[1] - r[2], p.y * r[1] - r[3], p.z * r[1] - r[4])
    return rot3d_cs(q, *r[5:11])


def make_map_program(prog: Program, vals):
    """``map(p, guard) -> (d, idx)``: the kernel's interpreter over the op
    list in vectorized torch.  ``vals`` is the table as Python floats (exact:
    they come from float32); ``guard`` is an (n, n_boxed) bool tensor."""
    ops = prog.ops.tolist()
    baked = prog.geometry == "baked"

    def map_fn(p: Vec3, guard):
        stack = []
        acc_d = torch.full_like(p.x, MAX_DIST)
        acc_i = torch.full_like(p.x, -1, dtype=torch.int32)
        for op in ops:
            if op[0] == OPC_ENTER:
                stack.append((acc_d, acc_i, p))
                if op[1] >= 0:
                    p = _xform(p, vals[op[1]:op[1] + XFORM])
                acc_d = torch.full_like(p.x, vals[op[2]] if op[2] >= 0
                                        else MAX_DIST)
                acc_i = torch.full_like(acc_i, -1)
            elif op[0] == OPC_SHAPE:
                _, kind, geom, box, sid, fold, k, _ = op
                if baked:
                    d = leaf_distance(kind, p, vals[geom:geom + GEOM_SLOTS[kind]])
                else:
                    r = vals[geom:geom + XFORM]
                    d = shape_distance(kind, _xform(p, r), r[11:14]) * r[0]
                i = torch.full_like(acc_i, sid)
                cd, ci = combine(fold, acc_d, acc_i, d, i,
                                 0 if fold == FOLD_ASSIGN else 1,
                                 vals[k] if k >= 0 else None)
                if box >= 0:
                    g = guard[:, box]
                    cd, ci = torch.where(g, cd, acc_d), torch.where(g, ci, acc_i)
                acc_d, acc_i = cd, ci
            else:
                d = acc_d * vals[op[1]] if op[1] >= 0 else acc_d
                i = acc_i
                acc_d, acc_i, p = stack.pop()
                acc_d, acc_i = combine(op[2], acc_d, acc_i, d, i, 1,
                                       vals[op[3]] if op[3] >= 0 else None)
        return acc_d, acc_i

    return map_fn


def program_bounds(prog: Program, table, ro: Vec3, rd: Vec3, with_t: bool):
    """The kernel's per-bounce guards for (n,) rays: ``((check,), dbg)``,
    or for the t-culled march ``((check, t_lo, t_hi), dbg)`` with the ray's
    interval through each leaf's bounding sphere (entry clamped to 0; empty
    as [BIG, -BIG] on a miss).  ``check`` etc. are (n, n_boxed); ``dbg`` sums
    0.1 per AABB hit in walk order (scenegen.make_bounds)."""
    boxes = table[prog.f_box:prog.f_sph].view(prog.n_boxed, 6)
    ro, rd = (Vec3(*(c[:, None] for c in v)) for v in (ro, rd))
    tn, tf = intersect_aabb(ro, rd, Vec3(*(boxes[:, k] for k in range(3))),
                            Vec3(*(boxes[:, k] for k in range(3, 6))))
    hit = aabb_hit(tn, tf)
    dbg = torch.zeros_like(ro.x[:, 0])
    for j in range(prog.n_boxed):
        dbg = dbg + 0.1 * hit[:, j].to(dbg.dtype)
    if not with_t:
        return (hit,), dbg
    sph = table[prog.f_sph:prog.f_mat].view(prog.n_boxed, 4)
    oc = ro - Vec3(sph[:, 0], sph[:, 1], sph[:, 2])
    b = oc.dot(rd)
    disc = b * b - (oc.dot(oc) - sph[:, 3] * sph[:, 3])
    ok = disc >= 0.0
    root = sqrt_rn(torch.where(ok, disc, torch.zeros_like(disc)))
    lo = torch.where(ok, torch.clamp(-b - root, min=0.0), torch.full_like(b, BIG))
    hi = torch.where(ok, -b + root, torch.full_like(b, -BIG))
    return (hit, lo, hi), dbg


def cast_tcull(prog: Program, map_fn, ro: Vec3, rd: Vec3, checks):
    """The kernel's t-culled march (JAX ``_march_while_tcull`` with the tile
    reduced to one ray, and the interval taken through a sphere that bounds
    the leaf, where the reference's box need not): a guarded shape with
    ``box_cull`` is in the map while the ray's interval [t_lo, t_hi] holds
    its t, and the nearest such interval still ahead clamps the step to
    ``max(t_lo - t, MHD)``; the other guarded shapes keep the bounce-level
    check.  ``checks`` is ``(check, t_lo, t_hi)`` from
    ``program_bounds(..., with_t=True)``.  Returns ``(t, idx)`` like
    ``cast_ray``, ``idx`` from the last tap."""
    cull = _on_device(prog, ro.x.device).cull
    t = torch.zeros_like(ro.x)
    idx = torch.full_like(ro.x, -1, dtype=torch.int32)
    live = torch.arange(t.shape[0], device=t.device)
    lt = t
    for _ in range(STEPS):
        if live.numel() == 0:
            break
        chk, lo, hi = checks
        tt = lt[:, None]
        active = chk & (~cull | ((lo <= tt) & (hi >= tt)))
        if chk.shape[1]:
            m = torch.where(chk & cull & (lo > tt), lo,
                            torch.full_like(lo, BIG)).amin(1)
        else:
            m = torch.full_like(lt, BIG)
        d, mi = map_fn(ro + rd * lt, active)
        ad = torch.abs(d)
        nt = lt + torch.minimum(ad, torch.clamp(m - lt, min=MHD))
        far = nt > FP
        t[live] = nt
        idx[live] = torch.where(far, torch.full_like(mi, -1), mi)
        keep = ~((ad < MHD) | far)
        live, lt = live[keep], nt[keep]
        ro, rd = (Vec3(v.x[keep], v.y[keep], v.z[keep]) for v in (ro, rd))
        checks = take_lanes(checks, keep)
    return t, idx
