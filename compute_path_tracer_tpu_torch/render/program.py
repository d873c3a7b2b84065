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

``build_program(..., skip_unboxed=True)`` (baked geometry) is the program
of the ``analytic_unboxed`` mode: the SHAPE ops of the guard-less shapes
that ``analytic_eligible_ids`` names are left out, and the program's
``caps`` list them, as (kind, baked offset, shape id) in walk order, for the
closed-form cap of the march (kernels/megakernel.py:make_analytic_unboxed);
``cap_leave`` gives, per LEAVE in walk order, the caps listed before it,
so a union's caps are those between its LEAVE and the one before it.
A skipped first shape leaves the union's seed in the accumulator, and the
next shape folds into it (JAX ``_eval_union_d``); the table is the full
program's, since a skipped shape has no box.

``make_map_program`` / ``program_bounds`` / ``cast_tcull`` / ``cast_grid``
are the plain torch versions of the kernel's map, guards, per-thread
t-culled march (with ``refresh_every``'s frozen window) and distance-grid
march; ``make_grad_program`` is the plain version of the exact-gradient
walk of ``normals="autodiff"``.

The marching kernels (K2's plain march, K6, K3, K4) walk, at each map
tap, not the whole op list but a list per warp of 32 lanes, built after
the bounce's guards (kernels/csrc/csg_program.cuh:build_warp_list): every
ENTER, LEAVE and guard-less shape, and each guarded shape whose box some
live lane of the warp hits.  ``warp_records`` is its plain model,
``make_map_program(..., records=)`` the map over one such list, and
``walk_smem_bytes`` the shared memory a block needs to hold the program
and its warps' lists; ``fused_smem_bytes`` sizes the fused step's block,
whose sums come first.
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
from ..vecmath import Vec3, div_exact, sqrt_rn, vwhere
from .baked import (
    GEOM_SLOTS,
    analytic_eligible_ids,
    bake,
    baked_layout,
    leaf_distance,
)
from .distgrid import GRID_MAX_ITERS
from .reference import take_lanes
from .scenegen import material_slot_matrix, shape_distance

OPC_ENTER, OPC_SHAPE, OPC_LEAVE = 0, 1, 2
OP_WIDTH = 8
FOLD_ASSIGN = -1
XFORM = 14        # floats per faithful node record
MAX_DEPTH = 16    # union nesting the kernel's per-thread stack holds
MAX_BOXED = 256   # guarded shapes the kernel's per-thread guard arrays hold
SMEM_PER_BLOCK = 232_448  # an H100 block's most (dynamic) shared memory
_GRID_CHEAP_RUN = 16  # cast_grid: cheap steps per ray between map calls


@dataclass(frozen=True, eq=False)
class Program:
    spec: SceneSpec
    geometry: str
    ops: np.ndarray        # (n_ops, OP_WIDTH) int32
    box_cull: np.ndarray   # (n_boxed,) int32: 1 where t-culling may drop it
    box_leaf: np.ndarray   # (n_boxed, 2): kind, baked slot offset
    caps: np.ndarray       # (n_cap, 3) int32: kind, baked offset, shape id
    cap_leave: np.ndarray  # (n_leave,) int32: caps listed before each LEAVE
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
def build_program(spec: SceneSpec, geometry: str,
                  skip_unboxed: bool = False) -> Program:
    """Flatten ``spec`` for ``geometry`` ("faithful" or "baked");
    ``skip_unboxed`` (baked only) leaves the shapes of
    ``analytic_eligible_ids`` out of the ops and lists them in ``caps``."""
    if geometry not in ("faithful", "baked"):
        raise ValueError("geometry must be 'faithful' or 'baked'")
    baked = geometry == "baked"
    if skip_unboxed and not baked:
        raise ValueError("skip_unboxed requires geometry='baked'")
    skip = analytic_eligible_ids(spec) if skip_unboxed else frozenset()
    zero, one = spec.n_params, spec.n_params + 1
    ops, nodes, chains, sizes, gathers, culls, leaves, caps, cap_leave = (
        [] for _ in range(9))
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
            if ss.shape_id in skip:
                # Guard-less, so no box; the next shape keeps its fold.
                caps.append((ss.kind, bs.off, ss.shape_id))
                continue
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
        # The caps of this union are the last listed: its child unions'
        # come before their own LEAVEs.
        cap_leave.append(len(caps))

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
        caps=np.asarray(caps, np.int32).reshape(-1, 3),
        cap_leave=np.asarray(cap_leave, np.int32),
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
    code: torch.Tensor       # int32: ops, flattened, box_cull, caps, cap_leave
    cull: torch.Tensor       # bool box_cull
    spheres: tuple           # (kind, rows, (n, slots) bv offsets) per kind
    consts: torch.Tensor     # float32 [0.0, 1.0], the slots past the params


@lru_cache(maxsize=32)
def _on_device(prog: Program, device: torch.device) -> _OnDevice:
    """The program's index arrays as tensors on ``device``, made once so
    that a frame issues no host-to-device copy."""
    def t(a):
        return torch.as_tensor(a, dtype=torch.int64, device=device)

    code = np.concatenate([prog.ops.reshape(-1), prog.box_cull,
                           prog.caps.reshape(-1), prog.cap_leave])
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


def program_table(prog: Program, params: torch.Tensor, t_cull: bool = False,
                  bv: torch.Tensor = None) -> torch.Tensor:
    """The per-frame float32 table ``F`` (``prog.f_len``) on ``params``'
    device; a few tens of batched ops whatever the scene size.  The bounding
    spheres are filled only for ``t_cull`` (zeros otherwise: the exact march
    does not read them).  ``bv``, the frame's ``bake(spec, params)`` where
    the caller has it, saves baking again."""
    dev = _on_device(prog, params.device)
    parts = []
    if bv is None and (prog.geometry == "baked" or t_cull):
        bv = bake(prog.spec, params)
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
    op records, flattened, then ``box_cull``, ``caps`` and ``cap_leave``,
    as one int32 vector."""
    return _on_device(prog, torch.device(device)).code


def _walk_bytes(prog: Program, warps: int):
    """(n_ops, bytes of the decoded records and the warps' lists, bytes of
    the leaf table) of a block of ``warps`` warps that walks ``prog``."""
    n_ops = prog.ops.shape[0]
    return n_ops, 16 * n_ops * (1 + warps), 16 * ((prog.f_box + 3 + 3) // 4)


def walk_smem_bytes(prog: Program, warps: int) -> int:
    """The dynamic shared memory of a block of ``warps`` warps that walks
    ``prog`` (kernels/csrc/csg_program.cuh:walk_smem_bytes): its decoded
    op records and one list per warp, 16 bytes a record each, then the leaf
    table ``F[0, f_box)`` behind up to 3 floats that give it the table's
    own alignment, rounded up to 16 bytes.  Raises ``ValueError``, naming
    the sizes, when a block cannot hold it."""
    n_ops, lists, table = _walk_bytes(prog, warps)
    if lists + table > SMEM_PER_BLOCK:
        raise ValueError(
            f"the program does not fit a block's shared memory: {n_ops} op "
            f"records x 16 bytes x (1 + {warps} warps) = {lists} bytes and a "
            f"leaf table of {prog.f_box} floats ({table} bytes) need "
            f"{lists + table} bytes, more than {SMEM_PER_BLOCK}")
    return lists + table


def fused_smem_bytes(prog: Program, warps: int, n_acc: int, walk: bool,
                     excl: bool) -> int:
    """The dynamic shared memory of a block of the fused step's kernel
    (kernels/csrc/train_fused.cu:fused_smem_bytes): each of its ``warps``
    warps' (n_shapes, n_acc) float32 sums; with ``walk``, from the next 16
    bytes, ``prog`` staged as :func:`walk_smem_bytes` lays it out and, with
    ``excl`` (the secondary exclusion march), one list of n_shapes records
    of 16 bytes a warp.  Raises ``ValueError``, naming the sizes, when a
    block cannot hold it."""
    sums = 4 * warps * prog.n_shapes * n_acc
    total, parts = sums, f"{sums} bytes of sums"
    if walk:
        n_ops, lists, table = _walk_bytes(prog, warps)
        lists += 16 * warps * prog.n_shapes * int(excl)
        total = 16 * -(-sums // 16) + lists + table
        parts += (f" and {lists + table} bytes of staged program ({n_ops} op "
                  f"records, a leaf table of {prog.f_box} floats"
                  + (", exclusion lists" if excl else "") + ")")
    if total > SMEM_PER_BLOCK:
        raise ValueError(
            f"the fused step does not fit a block's shared memory: {warps} "
            f"warps x {prog.n_shapes} shapes x {n_acc} channels x 4 bytes = "
            f"{parts} need {total} bytes, more than {SMEM_PER_BLOCK}")
    return total


def warp_records(prog: Program, check: torch.Tensor, warp: torch.Tensor,
                 n_warps: int = None) -> torch.Tensor:
    """The per-warp lists of the walk (csg_program.cuh:build_warp_list) as
    an (n_warps, n_ops) bool mask: row w marks, in walk order, the records
    the lanes of warp w can need: every ENTER, LEAVE and guard-less shape,
    and each guarded shape whose box check passes for at least one of them.
    ``check`` is the (n, n_boxed) guard bits of the live lanes, ``warp``
    the (n,) warp of each (``n_warps`` defaults to the largest plus one)."""
    if n_warps is None:
        n_warps = int(warp.max()) + 1 if warp.numel() else 0
    hit = torch.zeros((n_warps, prog.n_boxed), dtype=torch.int32,
                      device=check.device).index_add_(0, warp, check.int()) > 0
    box = np.where(prog.ops[:, 0] == OPC_SHAPE, prog.ops[:, 3], -1)
    out = torch.ones((n_warps, box.shape[0]), dtype=torch.bool,
                     device=check.device)
    out[:, box >= 0] = hit[:, box[box >= 0]]
    return out


# -- plain versions of the kernel's map, guards and march ---------------------


def _xform(p: Vec3, r) -> Vec3:
    """apply_transform (scenegen) from a node record: p*inv - pos*inv, then
    the rotation from its stored cos/sin."""
    q = Vec3(p.x * r[1] - r[2], p.y * r[1] - r[3], p.z * r[1] - r[4])
    return rot3d_cs(q, *r[5:11])


def make_map_program(prog: Program, vals, count=None, records=None):
    """``map(p, guard) -> (d, idx)``: the kernel's interpreter over the op
    list in vectorized torch.  ``vals`` is the table as Python floats (exact:
    they come from float32); ``guard`` is an (n, n_boxed) bool tensor.
    ``records``, record indices in walk order (a row of ``warp_records``),
    walks those records only, as a warp's list is walked.

    ``count``, a dict, accumulates the work the kernel does for these taps:
    ``"taps"`` (points mapped) and, per leaf kind, the leaf evaluations
    whose guard passes (device tensors, so counting does not synchronise)."""
    ops = prog.ops.tolist()
    if records is not None:
        ops = [ops[int(r)] for r in records]
    baked = prog.geometry == "baked"
    shapes = [op for op in ops if op[0] == OPC_SHAPE]
    kinds = sorted({op[1] for op in shapes})
    boxes = {k: [op[3] for op in shapes if op[1] == k and op[3] >= 0]
             for k in kinds}
    free = {k: sum(op[1] == k and op[3] < 0 for op in shapes) for k in kinds}

    def tally(n, guard):
        count["taps"] = count.get("taps", 0) + n
        for k in kinds:
            done = guard[:, boxes[k]].sum() if boxes[k] else 0
            count[k] = count.get(k, 0) + done + n * free[k]

    def map_fn(p: Vec3, guard):
        if count is not None:
            tally(p.x.shape[0], guard)
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


# -- the exact gradient of the map (normals="autodiff") ------------------------
#
# The plain version of csg_program.cuh:grad_exact_walk, operation for
# operation: one forward-mode walk of the op list carrying (d, grad d).  At
# the kinks it takes JAX's AD rules (jax/_src/lax/lax.py), as JAX's
# reverse-mode normal of the same map does: |x| has slope +1 at x >= 0 and
# -1 below (lax.abs); min and max give the winner's gradient and half each
# on a tie (lax.min/max, _balanced_eq; jnp.clip is a max then a min);
# length_safe has zero gradient at the zero vector; a select (a failed
# guard, the subtraction, the octahedron's branches) takes the selected
# operand's.


def _ones(x, v=1.0):
    return torch.full_like(x, v)


def _max_slope(a, b):
    """d max(a, b) / da: 1 where a wins, 1/2 on a tie, else 0."""
    return torch.where(a > b, _ones(a), torch.where(a == b, _ones(a, 0.5),
                                                    torch.zeros_like(a)))


def _min_slope(a, b):
    """d min(a, b) / da: 1 where a wins, 1/2 on a tie, else 0."""
    return torch.where(a < b, _ones(a), torch.where(a == b, _ones(a, 0.5),
                                                    torch.zeros_like(a)))


def _abs_slope(x):
    return torch.where(x >= 0.0, _ones(x), _ones(x, -1.0))


# The gradients below are (3, n) tensors, a row a component: each operation
# on them is the one the kernel does on each component, in one launch.


def _length_grad(v):
    """The gradient of length_safe(v) for a (3, n) ``v``: v / |v|, zero at
    the zero vector."""
    l2 = v[0] * v[0] + v[1] * v[1] + v[2] * v[2]
    pos = l2 > 0.0
    ln = sqrt_rn(torch.where(pos, l2, torch.ones_like(l2)))
    return torch.where(pos, v / ln, torch.zeros_like(v))


def _octa_branch_grad(qx, qy, qz, s):
    u = 0.5 * (qz - qy + s)
    mu = torch.clamp(u, min=0.0)
    k = torch.minimum(mu, _ones(mu, s))
    c = _min_slope(mu, _ones(mu, s)) * _max_slope(u, torch.zeros_like(u))
    gv = _length_grad(torch.stack([qx, qy - s + k, qz - k]))
    e = (gv[1] - gv[2]) * c * 0.5
    return torch.stack([gv[0], gv[1] - e, gv[2] + e])


def _leaf_sdf_grad(kind: int, q, sz, size):
    """The gradient of the leaf SDF (ops/sdf.py) at the (3, n) point ``q``
    in the leaf's frame, (3, n); ``sz`` holds the size slots as Python
    floats, ``size`` a cube's as a (3, 1) float32 tensor on ``q``'s
    device."""
    if kind == KIND_SPHERE:
        return _length_grad(q)
    if kind == KIND_PLANE:
        out = torch.zeros_like(q)
        out[1] = 1.0
        return out
    if kind == KIND_CUBE:
        a = torch.abs(q) - size
        go = _length_grad(torch.clamp(a, min=0.0))
        t = torch.maximum(a[1], a[2])
        w = _min_slope(torch.maximum(a[0], t), torch.zeros_like(t))
        wt = w * _max_slope(t, a[0])
        wv = torch.stack([w * _max_slope(a[0], t), wt * _max_slope(a[1], a[2]),
                          wt * _max_slope(a[2], a[1])])
        return _abs_slope(q) * (go + wv)
    s = sz[0]
    p = torch.abs(q)
    m = p[0] + p[1] + p[2] - s
    gp = torch.full_like(q, 0.57735027)
    b = _octa_branch_grad(p[2], p[0], p[1], s)
    gp = torch.where(3.0 * p[2] < m, b[[1, 2, 0]], gp)
    b = _octa_branch_grad(p[1], p[2], p[0], s)
    gp = torch.where(3.0 * p[1] < m, b[[2, 0, 1]], gp)
    gp = torch.where(3.0 * p[0] < m, _octa_branch_grad(p[0], p[1], p[2], s),
                     gp)
    return _abs_slope(q) * gp


def _leaf_baked_grad(kind: int, p: Vec3, g, col):
    """The world-space gradient of ``leaf_distance(kind, p, g)`` (render/
    baked.py), (3, n): a cube's or an octahedron's leaf-frame gradient
    through its affine rows, A^T grad.  ``col(i)`` is the column of slots
    ``g[i:i + 3]`` as a (3, 1) float32 tensor on ``p``'s device."""
    if kind == KIND_SPHERE:
        return _length_grad(torch.stack(list(p)) - col(0))
    if kind == KIND_PLANE:
        return col(0).expand(3, p.x.shape[0]).clone()
    q = torch.stack([g[0] * p.x + g[1] * p.y + g[2] * p.z + g[9],
                     g[3] * p.x + g[4] * p.y + g[5] * p.z + g[10],
                     g[6] * p.x + g[7] * p.y + g[8] * p.z + g[11]])
    gl = _leaf_sdf_grad(kind, q, g[12:15], col(12))
    return col(0) * gl[0] + col(3) * gl[1] + col(6) * gl[2]


def _xform_t(gv, r):
    """The transpose of ``_xform``'s Jacobian applied to a (3, n) gradient
    in the transformed frame: the rotation transposed, then the inverse
    scale."""
    cx, sx, cy, sy, cz, sz = r[5:11]
    gx2 = cz * gv[0] - sz * gv[1]
    gy1 = sz * gv[0] + cz * gv[1]
    gz1 = -sy * gx2 + cy * gv[2]
    return torch.stack([cy * gx2 + sy * gv[2], cx * gy1 - sx * gz1,
                        sx * gy1 + cx * gz1]) * r[1]


def _fold_grad(op: int, k, acc_d, acc_g, d, gd):
    """csg_program.cuh:fold with the (3, n) gradient: returns (d, grad)."""
    if op == FOLD_ASSIGN:
        return d, gd
    if op == OP_UNION:
        keep, tie = acc_d < d, acc_d == d
        g = torch.where(keep, acc_g,
                        torch.where(tie, 0.5 * acc_g + 0.5 * gd, gd))
        return torch.where(keep, acc_d, d), g
    if op == OP_SMOOTH_UNION:
        u = 0.5 + div_exact(0.5 * (d - acc_d), k)
        mu = torch.clamp(u, min=0.0)
        h = torch.clamp(mu, max=1.0)
        blended = d * (1.0 - h) + acc_d * h - k * h * (1.0 - h)
        c = _min_slope(mu, _ones(mu)) * _max_slope(u, torch.zeros_like(u))
        s = div_exact((acc_d - d - k * (1.0 - 2.0 * h)) * c * 0.5, k)
        return blended, (1.0 - h) * gd + h * acc_g + s * (gd - acc_g)
    nd = -acc_d  # subtraction
    take = nd >= d
    return torch.where(take, nd, d), torch.where(take, -acc_g, gd)


def make_grad_program(prog: Program, vals, count=None):
    """``grad(p, guard) -> (d, Vec3)``: the map of ``make_map_program`` and
    its exact gradient at ``p`` under the (n, n_boxed) guard bits, the plain
    version of csg_program.cuh:grad_exact_walk, in its operation order.  A
    program with ``caps`` (``analytic_unboxed``) folds each capped leaf into
    its own union by min just before the union's LEAVE (``cap_leave``): the
    union is a plain UNION and its seed is MAX_DIST, so that is the map of
    the whole program, the one JAX differentiates, also where an
    ancestor's first shape clobbers the union.

    ``count``, a dict, adds ``"grad_taps"`` (points) and, per leaf kind
    ``k``, ``("grad", k)``: the leaf gradients whose guard passes, caps
    included (device tensors, so counting does not synchronise)."""
    ops = prog.ops.tolist()
    caps = prog.caps.tolist()
    cap_leave = prog.cap_leave.tolist()
    baked = prog.geometry == "baked"
    shapes = [op for op in ops if op[0] == OPC_SHAPE]
    kinds = sorted({op[1] for op in shapes} | {c[0] for c in caps})

    def tally(n, guard):
        count["grad_taps"] = count.get("grad_taps", 0) + n
        for k in kinds:
            boxed = [op[3] for op in shapes if op[1] == k and op[3] >= 0]
            free = sum(op[1] == k and op[3] < 0 for op in shapes)
            free += sum(c[0] == k for c in caps)
            done = guard[:, boxed].sum() if boxed else 0
            count[("grad", k)] = count.get(("grad", k), 0) + done + n * free

    table, cols = {}, {}

    def col(device, off):
        """F[off:off + 3] as a (3, 1) float32 tensor on ``device``, made
        once (a view of the table's copy there)."""
        key = (device, off)
        if key not in cols:
            if device not in table:
                table[device] = torch.tensor(vals, dtype=torch.float32,
                                             device=device)
            cols[key] = table[device][off:off + 3, None]
        return cols[key]

    def baked_leaf(kind, off, p):
        g = vals[off:off + GEOM_SLOTS[kind]]
        return leaf_distance(kind, p, g), _leaf_baked_grad(
            kind, p, g, lambda i: col(p.x.device, off + i))

    def leaf(kind, geom, p):
        if baked:
            return baked_leaf(kind, geom, p)
        r = vals[geom:geom + XFORM]
        q = _xform(p, r)
        gl = _xform_t(_leaf_sdf_grad(kind, torch.stack(list(q)), r[11:14],
                                    col(p.x.device, geom + 11)), r)
        return shape_distance(kind, q, r[11:14]) * r[0], gl * r[0]

    def grad_fn(p: Vec3, guard):
        if count is not None:
            tally(p.x.shape[0], guard)
        zero = torch.zeros((3,) + p.x.shape, dtype=p.x.dtype,
                           device=p.x.device)
        stack = []
        acc_d, acc_g = torch.full_like(p.x, MAX_DIST), zero
        n_leave = c = 0
        for op in ops:
            if op[0] == OPC_ENTER:
                stack.append((acc_d, acc_g, p, op[1]))
                if op[1] >= 0:
                    p = _xform(p, vals[op[1]:op[1] + XFORM])
                acc_d = torch.full_like(p.x, vals[op[2]] if op[2] >= 0
                                        else MAX_DIST)
                acc_g = zero
            elif op[0] == OPC_SHAPE:
                _, kind, geom, box, _, fold, k, _ = op
                d, gd = leaf(kind, geom, p)
                cd, cg = _fold_grad(fold, vals[k] if k >= 0 else None, acc_d,
                                    acc_g, d, gd)
                if box >= 0:
                    g = guard[:, box]
                    cd, cg = torch.where(g, cd, acc_d), torch.where(g, cg, acc_g)
                acc_d, acc_g = cd, cg
            else:
                for kind, off, _ in caps[c:cap_leave[n_leave]]:
                    acc_d, acc_g = _fold_grad(OP_UNION, None, acc_d, acc_g,
                                              *baked_leaf(kind, off, p))
                c = cap_leave[n_leave]
                n_leave += 1
                d, gd = acc_d, acc_g
                acc_d, acc_g, p, rec = stack.pop()
                if op[1] >= 0:
                    scale = vals[op[1]]
                    d = d * scale
                    gd = _xform_t(gd, vals[rec:rec + XFORM]) * scale
                acc_d, acc_g = _fold_grad(op[2], vals[op[3]] if op[3] >= 0
                                          else None, acc_d, acc_g, d, gd)
        return acc_d, Vec3(*acc_g)

    return grad_fn


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


def cast_tcull(prog: Program, map_fn, ro: Vec3, rd: Vec3, checks,
               t_cap=None, omega: float = 1.0, record=None,
               refresh_every: int = 1):
    """The kernel's t-culled march (JAX ``_march_while_tcull`` with the tile
    reduced to one ray, and the interval taken through a sphere that bounds
    the leaf, where the reference's box need not): a guarded shape with
    ``box_cull`` is in the map while the ray's interval [t_lo, t_hi] holds
    its t, and the nearest such interval still ahead clamps the step to
    ``max(t_lo - t, MHD)``; the other guarded shapes keep the bounce-level
    check.  ``checks`` is ``(check, t_lo, t_hi)`` from
    ``program_bounds(..., with_t=True)``.  Returns ``(t, idx)`` like
    ``cast_ray``, ``idx`` from the last tap.

    ``t_cap`` ((n,), the closed-form cap of ``analytic_unboxed``) stops a
    ray on it: ``t = min(t, t_cap)``, done once ``t >= t_cap``.  ``omega``
    != 1 over-relaxes the march (JAX ``:785-820``): an exterior sample (d >
    0) steps ``min(omega |d|, clamp)``; when the unbounding spheres of two
    samples stop overlapping (``d_prev > 0`` and ``s_prev > d_prev + d``,
    signed) the ray reverts to ``t_prev + f_prev``, the step the exact march
    would have taken there, and a hit needs no such overshoot.

    ``record(live, active)``, when given, receives at each step the indices
    of the rays still marching and the (n, n_boxed) mask of the guarded
    shapes each of them evaluates (debug 4's statistics,
    kernels/megakernel.py:MarchStats).

    ``refresh_every = K`` freezes the activation window (JAX
    ``_march_while_tcull`` :674-700, with the tile reduced to one ray): at
    steps 0, K, 2K, ... a ray takes its refresh point t_r, and for the K
    steps of the window a culled shape is in the map while its interval
    holds t_r, and the nearest entry still ahead of t_r clamps the step.  A
    box reached mid-window stays out of the map (the clamp still stops the
    ray at its entry, creeping MHD a step, up to K MHD), a box left
    mid-window stays in.  K must divide STEPS and needs ``omega`` 1, which
    the caller checks (kernels/megakernel.py:_march_refresh); K = 1 is the
    march above."""
    cull = _on_device(prog, ro.x.device).cull
    relax = float(omega) != 1.0
    refresh = int(refresh_every)
    om = float(np.float32(omega))
    t = torch.zeros_like(ro.x)
    idx = torch.full_like(ro.x, -1, dtype=torch.int32)
    live = torch.arange(t.shape[0], device=t.device)
    lt = torch.zeros_like(t)  # not t itself: t is written in place
    cap = t_cap
    tp = dp = sp = fp = lt  # relax: t, d, step and exact step of the last sample
    tr = lt  # the window's refresh point
    for step in range(STEPS):
        if live.numel() == 0:
            break
        chk, lo, hi = checks
        if step % refresh == 0:
            tr = lt
        tt = tr[:, None]
        active = chk & (~cull | ((lo <= tt) & (hi >= tt)))
        if chk.shape[1]:
            m = torch.where(chk & cull & (lo > tt), lo,
                            torch.full_like(lo, BIG)).amin(1)
        else:
            m = torch.full_like(lt, BIG)
        if record is not None:
            record(live, active)
        d, mi = map_fn(ro + rd * lt, active)
        ad = torch.abs(d)
        clamp = torch.clamp(m - lt, min=MHD)
        exact = torch.minimum(ad, clamp)
        if relax:
            over = (dp > 0.0) & (sp > dp + d)
            step = torch.where(d > 0.0, torch.minimum(om * ad, clamp), exact)
            nt = torch.where(over, tp + fp, lt + step)
            hit = ~over & (ad < MHD)
        else:
            nt = lt + exact
            hit = ad < MHD
        if cap is not None:
            nt = torch.minimum(nt, cap)
        far = nt > FP
        t[live] = nt
        idx[live] = torch.where(far, torch.full_like(mi, -1), mi)
        done = hit | far
        if cap is not None:
            done = done | (nt >= cap)
        keep = ~done
        if relax:
            tp, dp, sp, fp = (torch.where(over, tp, lt)[keep],
                              torch.where(over, dp, d)[keep],
                              torch.where(over, fp, step)[keep],
                              torch.where(over, fp, exact)[keep])
        live, lt, tr = live[keep], nt[keep], tr[keep]
        ro, rd = (Vec3(v.x[keep], v.y[keep], v.z[keep]) for v in (ro, rd))
        checks = take_lanes(checks, keep)
        if cap is not None:
            cap = cap[keep]
    return t, idx


def cast_grid(prog: Program, map_fn, ro: Vec3, rd: Vec3, checks, tap,
              tau: float, t_cap=None, count=None):
    """The kernel's distance-grid march (JAX ``_march_while_grid`` with the
    tile reduced to one ray, as ``cast_tcull`` reduces
    ``_march_while_tcull``): each iteration a ray taps the grid bound ``g =
    tap(p)`` (render/distgrid.py).  A ray with ``g < tau`` takes one exact
    tap of the map under the per-thread t-cull of ``cast_tcull`` and steps
    ``min(|d|, max(m - t, MHD))``; a ray with ``g >= tau`` steps by ``g``
    with no map tap.  Only exact taps count against STEPS, and a ray runs at
    most ``GRID_MAX_ITERS`` iterations.  A hit needs an exact tap with ``|d|
    < MHD``; a ray is far once ``t > FP``; a finite ``t_cap``
    (``analytic_unboxed``) caps t and ends the ray.

    Returns ``(t, idx)``: ``idx`` is the id of the ray's last exact tap, -1
    when far or when it took none; a ray still marching when its iterations
    run out takes, as JAX ``_final_idx`` does, the id of one map tap under
    the bounce's full guards at its previous position; a ray that hits,
    goes far, meets its cap or spends its exact taps on its last iteration
    keeps its last exact tap's id, as the kernel returns it.  ``count``, a
    dict, adds the grid taps as ``tap`` counts them and ``"grid_cheap"``,
    the cheap steps (the map's own work goes through ``map_fn``'s count).

    Rays are independent, so their iterations may interleave in any order:
    each round gives every ray up to ``_GRID_CHEAP_RUN`` cheap steps, then
    one exact tap to every ray then near.  Each ray's own sequence of steps
    is the kernel's, and the map, a few thousand torch ops, runs once a
    round instead of once an iteration."""
    cull = _on_device(prog, ro.x.device).cull
    t = torch.zeros_like(ro.x)
    idx = torch.full_like(ro.x, -1, dtype=torch.int32)
    zero = torch.zeros_like(ro.x)
    # The live rays' state, compacted once a round: lane, ray, guards, t, t
    # before the last step, the last exact tap's id, exact taps,
    # iterations, cap, and g at t.
    st = dict(lane=torch.arange(t.shape[0], device=t.device), ro=ro, rd=rd,
              chk=checks[0], lo=checks[1], hi=checks[2], t=zero, tp=zero,
              last=idx, ec=torch.zeros_like(idx), it=torch.zeros_like(idx),
              cap=t_cap, g=None)
    out = []  # rays whose iterations ran out: (lane, ray at tp, guards)

    def grid(p, live=None):
        return tap(p, count, live)

    def at(t_):
        return st["ro"] + st["rd"] * t_

    st["g"] = grid(at(zero))
    while st["lane"].numel():
        # fin: the ray ends this round; stop: it ends by a hit, far, its cap
        # or its exact-tap budget, not by running out of iterations.
        fin = torch.zeros_like(st["lane"], dtype=torch.bool)
        far, stop = fin.clone(), fin.clone()
        # Up to _GRID_CHEAP_RUN cheap steps of every ray with g >= tau.
        for _ in range(_GRID_CHEAP_RUN):
            cheap = ~fin & (st["g"] >= tau)
            if not bool(cheap.any()):
                break
            lt = st["t"]
            nt = torch.where(cheap, lt + st["g"], lt)
            done = cheap & (nt > FP)
            far = far | done
            if st["cap"] is not None:
                nt = torch.where(cheap, torch.minimum(nt, st["cap"]), nt)
                done = done | (cheap & (nt >= st["cap"]))
            st["tp"] = torch.where(cheap, lt, st["tp"])
            st["t"] = nt
            st["it"] = st["it"] + cheap.to(st["it"].dtype)
            if count is not None:
                count["grid_cheap"] = count.get("grid_cheap", 0) + cheap.sum()
            stop = stop | done
            fin = fin | done | (cheap & (st["it"] >= GRID_MAX_ITERS))
            go = cheap & ~fin
            st["g"] = torch.where(go, grid(at(nt), go), st["g"])
        # One exact tap of every ray now near.
        sel = torch.nonzero(~fin & (st["g"] < tau)).flatten()
        if sel.numel():
            lt = st["t"][sel]
            c, lo_, hi_ = st["chk"][sel], st["lo"][sel], st["hi"][sel]
            tt = lt[:, None]
            active = c & (~cull | ((lo_ <= tt) & (hi_ >= tt)))
            if c.shape[1]:
                m = torch.where(c & cull & (lo_ > tt), lo_,
                                torch.full_like(lo_, BIG)).amin(1)
            else:
                m = torch.full_like(lt, BIG)
            d, mi = map_fn(Vec3(*(o[sel] + r[sel] * lt
                                  for o, r in zip(st["ro"], st["rd"]))),
                           active)
            ad = torch.abs(d)
            nt = lt + torch.minimum(ad, torch.clamp(m - lt, min=MHD))
            done = ad < MHD
            if st["cap"] is not None:
                nt = torch.minimum(nt, st["cap"][sel])
                done = done | (nt >= st["cap"][sel])
            f = nt > FP
            ec, it = st["ec"][sel] + 1, st["it"][sel] + 1
            done = done | f | (ec >= STEPS)
            for k, v in (("tp", lt), ("t", nt), ("last", mi), ("ec", ec),
                         ("it", it)):
                st[k] = st[k].index_put((sel,), v)
            far = far.index_put((sel,), f)
            stop = stop.index_put((sel,), done)
            fin = fin.index_put((sel,), done | (it >= GRID_MAX_ITERS))
            go = sel[~fin[sel]]
            if go.numel():
                st["g"] = st["g"].index_put(
                    (go,), grid(Vec3(*(o[go] + r[go] * st["t"][go]
                                       for o, r in zip(st["ro"], st["rd"])))))
        # Retire the finished rays: write t and the id, set aside the rays
        # whose iterations ran out, and compact the rest.
        ran_out = fin & ~stop
        ended = fin & ~ran_out
        if not bool(ended.any() | ran_out.any()):
            continue
        lanes = st["lane"][fin]
        t[lanes] = st["t"][fin]
        e = torch.nonzero(ended).flatten()
        idx[st["lane"][e]] = torch.where(far[e], -1, st["last"][e])
        r = torch.nonzero(ran_out).flatten()
        if r.numel():
            out.append((st["lane"][r], Vec3(*(o[r] + d_[r] * st["tp"][r]
                                              for o, d_ in zip(st["ro"],
                                                               st["rd"]))),
                        st["chk"][r]))
        keep = ~fin
        for k, v in st.items():
            if v is not None:
                st[k] = (Vec3(v.x[keep], v.y[keep], v.z[keep])
                         if isinstance(v, Vec3) else v[keep])
    if out:
        lanes = torch.cat([o[0] for o in out])
        p = Vec3(*(torch.cat([o[1][k] for o in out]) for k in range(3)))
        _, mi = map_fn(p, torch.cat([o[2] for o in out]))
        idx[lanes] = mi
    return t, idx
