"""The fused training step: a forward render and the whole per-pixel backward
in one launch of the CUDA kernel K4, and its plain torch version (JAX
package: ``kernels/train.py``).

``make_fused_value_and_grad(spec, target, ...)`` builds ``step(params,
frame=0) -> (loss, grad)`` (``(loss, grad, image)`` with ``with_image``):
the MSE between one sample of the frame and ``target`` and its gradient in
the flat parameter vector, laid out as ``scene/compile.py``'s slots.  It
returns the gradient as the JAX version does; ``diff/inverse.py`` hands it to
the optimizer as ``params.grad``.  Per step and sample:

* ``fused_tables``: the baked vector (``bake``, differentiable) and the
  tables the kernel reads: the baked CSG program of render/program.py (with
  ``analytic_unboxed`` the program without the eligible guard-less shapes,
  and their cap list) and, with ``analytic_all``, K1's packed shape
  tables;
* ``fused_planes``: on a CUDA tensor one launch of
  ``csrc/train_fused.cu`` (counted in ``LAUNCHES["train_fused"]``), on a CPU
  tensor :func:`fused_planes_plain`.  Per pixel, phase 1 is the bounce loop
  (K2's baked t-culled march with the closest approach of bounce 0, or K1's
  closed form with ``analytic_all``; with ``analytic_unboxed`` the march
  is capped by the closed form of the skipped shapes, and a capped hit
  takes that shape's id and ``g = n * 2e-4`` from its exact normal, JAX
  ``train.py:465-520``); phase 2 the reverse sweep: the
  adjoint of each bounce's shading replay, the hit distance linearised by
  the implicit identity ``t = t* + A.(ro - ro*) + B.(rd - rd*) + t_aux``
  with ``A = -g/(g.rd)``, ``B = A t*`` from the 6-tap gradient ``g``; then
  the edge terms;
* outside the kernel, in torch: the slot-gather transposes, the bake vjp
  and, for trees with a non-union op, the map vjp seeded with the kernel's
  per-bounce ``scale = -dL/dt / (g.rd)`` planes.

Every map tap of the kernel walks its warp's list of the program
(render/program.py:warp_records over ``band_warps``; the exclusion march's
list of the full program's leaves, ``_leaves(..., records=)``), staged in
shared memory behind its sums (``fused_smem_bytes``).

Phase 2 reads every leaf: the winner-leaf partials, the map vjp and the
secondary exclusion march (JAX ``_make_excl_closest``) take the full baked
program, also with ``analytic_unboxed``, whose edge term folds in the
closed-form closest approach of the skipped spheres (JAX
``train.py:682-687``).

Two modes, as in JAX: union-only trees take the winner-leaf mode, where the
kernel reduces every cotangent to ``(n_shapes, 13)`` material and
``(n_shapes, 15)`` geometry sums (the partials of each pixel's winning
leaf); other trees the map-vjp mode, where it writes the segment planes.

Gradient semantics are JAX's ``normals="detached"`` fast-training ones (the
surface normal is a constant of the backward); ``edge_grad`` adds the
primary-silhouette coverage term and ``edge_secondary`` the secondary one.
Scenes with a non-zero ``refract_chance`` are rejected
(:func:`check_no_refraction`).  Where the port differs from the JAX kernel:
the bounce loop's march culls per thread, as K2 does, where JAX culls per
(32, 128) tile; the edge estimator's marches (the closest approach of the
primary ray, the signed continuation) do not cull at all, since a
per-thread cull hides every shape from the near misses the coverage term is
about (PERF.md); the winner id is the march's last tap; the normal taps run
under the bounce's full guards.  The TPU-only ``tile`` and ``interpret``
arguments are gone.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..constants import BIG, DEFAULT_FOV, FP, MHD, STEPS
from ..render.baked import (
    GEOM_CHANNELS,
    GEOM_SLOTS,
    bake,
    baked_geom_slot_matrix,
    baked_layout,
    leaf_distance,
    make_bounds_baked,
    make_map_baked,
    spec_is_union_only,
)
from ..render.program import (
    OPC_SHAPE,
    Program,
    build_program,
    cast_tcull,
    fused_smem_bytes,
    make_map_program,
    program_bounds,
    program_code_on,
    program_table,
    warp_records,
)
from ..render.reference import (
    Mat,
    calc_grad,
    calc_normal,
    camera_rays,
    cast_ray,
    gather_material,
    shade_bounce,
    take_lanes,
)
from ..render.scenegen import material_slot_matrix
from ..render.soa import (
    SoaSmemLayout,
    build_soa_smem_layout,
    make_cast_soa,
    make_normal_soa,
    pack_soa_smem,
)
from ..ops.rng import random_float01
from ..scene.compile import SceneSpec
from ..vecmath import Vec3, sqrt_rn
from .build import load_library
from .megakernel import capped_winners, make_analytic_unboxed, warp_ids

# Launches since import (or since a caller reset them).
LAUNCHES = {"train_fused": 0}

EPS_N = 1e-4       # central-difference epsilon (funcs.glsl:26)
DENOM_EPS = 1e-6   # implicit-gradient denominator clamp (diff/vjp.py)
EDGE_STEP = 2e-3   # floored step of the signed continuation marches
# The kernel keeps each pixel's per-bounce state in thread-local arrays of
# this many bounces plus one.
MAX_BOUNCES = 15
BACKWARD_CHUNK = 1 << 20  # rays per map vjp of the map-vjp mode
# The warps of a block of the kernel (16x8 pixels), each with its own lists
# of the program in shared memory; a warp is 2x16 pixels of the band, as
# K2's (megakernel.WARP).
WARPS = 4

# Material channels the kernel emits cotangents for, in the column order of
# the (n_shapes, 18) material table.  Channels 12 (ior), 14
# (refract_roughness) and 15-17 (refract_col) only feed the refraction
# branch, which no lane takes once check_no_refraction holds, so their
# cotangents are zero; refract_chance (13) gets one through the diffuse
# probability 1 - spec - refract_chance.
MAT_CHANNELS = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13)

_F32 = np.float32


def check_no_refraction(spec: SceneSpec, params) -> None:
    """Raise ``ValueError`` if a material's refract_chance is non-zero: the
    fused step never shades refraction, so its gradient would be that of
    another model.  Such scenes train through diff/vjp.py."""
    slots = torch.as_tensor(material_slot_matrix(spec)[:, 13],
                            dtype=torch.int64)
    p = torch.as_tensor(params)
    if bool((p.detach()[slots.to(p.device)] != 0.0).any()):
        raise ValueError(
            "scene has nonzero refract_chance materials: the fused train "
            "step never shades refraction, so its gradients are for the "
            "wrong model - train through diff/vjp.py (fused=False) instead")


def _segment_matmul(seg_idx, cot, n_shapes):
    """Per-(shape, channel) sums of (B1, C, n) cotangent planes grouped by
    the (B1, n) winner ids; ``idx == -1`` lanes drop out.  ``index_add_``
    bounce by bounce (JAX: one one-hot matmul per bounce)."""
    out = cot.new_zeros((n_shapes, cot.shape[1]))
    for b in range(seg_idx.shape[0]):
        ok = seg_idx[b] >= 0
        out.index_add_(0, seg_idx[b][ok].to(torch.int64), cot[b][:, ok].T)
    return out


class FusedMode(NamedTuple):
    """The static options of one fused step."""

    bounces: int
    winner: bool
    edge_grad: bool = False
    edge_secondary: bool = False
    analytic_all: bool = False
    edge_beta: float = 0.5
    edge_beta2: float = 2.0
    analytic_unboxed: bool = False

    @property
    def b1(self) -> int:
        return self.bounces + 1

    @property
    def n_acc(self) -> int:
        """Channels of the in-kernel (S, C) sums: 13 material and 15
        geometry (winner mode), the 15 secondary geometry channels
        (map-vjp mode with edge_secondary), or none."""
        if self.winner:
            return len(MAT_CHANNELS) + GEOM_CHANNELS
        return GEOM_CHANNELS if self.edge_secondary else 0


class FusedTables(NamedTuple):
    """What one fused step reads of the scene, on the params' device."""

    spec: SceneSpec
    bv: torch.Tensor          # baked vector, attached to the params' graph
    prog: Program             # the baked CSG program (analytic_unboxed: its
                              # skip variant, with the cap list)
    table: torch.Tensor       # its t-culled table (program_table)
    leaf_lut: torch.Tensor    # (S, 2) int32: kind, bv offset of each shape
    layout: Optional[SoaSmemLayout]   # analytic_all: K1's packed tables
    soa_f: Optional[torch.Tensor]
    soa_i: Optional[torch.Tensor]


class FusedOut(NamedTuple):
    """A fused launch's outputs; absent ones are None.  Planes are flat
    over the band's pixels (row-major), ``n = crop_h * width``."""

    col: torch.Tensor                          # (3, n)
    mat_acc: Optional[torch.Tensor] = None     # (S, 13)   winner mode
    geom_acc: Optional[torch.Tensor] = None    # (S, 15)   winner mode
    seg_ro: Optional[torch.Tensor] = None      # (B1P, 3, n) map-vjp mode
    seg_rd: Optional[torch.Tensor] = None      # (B1P, 3, n)
    seg_t: Optional[torch.Tensor] = None       # (B1P, n)
    seg_idx: Optional[torch.Tensor] = None     # (B1P, n) int32
    seg_scale: Optional[torch.Tensor] = None   # (B1P, n)
    mat_cot: Optional[torch.Tensor] = None     # (B1, 13, n)
    geom2_acc: Optional[torch.Tensor] = None   # (S, 15) secondary rows


@lru_cache(maxsize=None)
def _leaf_lut_np(spec: SceneSpec) -> np.ndarray:
    prog = build_program(spec, "baked")
    lut = np.zeros((spec.n_shapes, 2), np.int32)
    for op in prog.ops.tolist():
        if op[0] == OPC_SHAPE:
            lut[op[4]] = (op[1], op[2])
    return lut


@lru_cache(maxsize=32)
def _leaf_lut_on(spec: SceneSpec, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_leaf_lut_np(spec), device=device)


def fused_tables(spec: SceneSpec, params: torch.Tensor,
                 analytic_all: bool = False,
                 analytic_unboxed: bool = False) -> FusedTables:
    """Bake ``params`` (keeping the graph for the bake vjp) and build the
    tables the fused step reads.  The skip program of ``analytic_unboxed``
    has the full program's table: a skipped shape has no box."""
    if analytic_all and build_soa_smem_layout(spec) is None:
        raise ValueError("analytic_all requires a union-only tree")
    bv = bake(spec, params)
    prog = build_program(spec, "baked", analytic_unboxed)
    pd = params.detach()
    with torch.no_grad():
        table = program_table(prog, pd, True)
        layout = soa_f = soa_i = None
        if analytic_all:
            layout = build_soa_smem_layout(spec)
            soa_f, soa_i = pack_soa_smem(layout, bv.detach(), pd)
    return FusedTables(spec, bv, prog, table,
                       _leaf_lut_on(spec, params.device), layout, soa_f,
                       soa_i)


def edge_footprints(mode: FusedMode, height: int, fov: float):
    """The pixel-footprint factors of the primary and secondary coverage
    bandwidths, in float32 as the JAX kernel computes them."""
    def foot(beta):
        return float(_F32(_F32(2.0 * beta / height) / _F32(fov)))

    return foot(mode.edge_beta), foot(mode.edge_beta2)


# -- the plain version ----------------------------------------------------------


def _tally(count, key, n):
    if count is not None:
        count[key] = count.get(key, 0) + int(n)


def _continue_march(map_fn, ro: Vec3, rd: Vec3, chk, t0, cap):
    """The signed continuation march (JAX ``train.py:610-687``), without
    t-cull: from ``t0``, steps of ``max(|d|, EDGE_STEP)`` under the
    bounce's guards ``chk``, tracking the smallest signed map value
    ``(d_min, t_min)``, until the ray leaves the first shape it entered, t
    passes FP, or ``cap`` steps.  ``t_min`` starts at ``t0``."""
    d_min = torch.full_like(t0, BIG)
    t_min = t0.clone()
    was_neg = torch.zeros_like(t0, dtype=torch.bool)
    live = torch.arange(t0.shape[0], device=t0.device)
    lt = t0
    for _ in range(cap):
        if live.numel() == 0:
            break
        d, _ = map_fn(ro + rd * lt, chk)
        better = d < d_min[live]
        d_min[live] = torch.where(better, d, d_min[live])
        t_min[live] = torch.where(better, lt, t_min[live])
        nt = lt + torch.clamp(torch.abs(d), min=EDGE_STEP)
        done = (was_neg[live] & (d > 0.0)) | (nt > FP)
        was_neg[live] = was_neg[live] | (d < 0.0)
        keep = ~done
        live, lt = live[keep], nt[keep]
        ro, rd = (Vec3(v.x[keep], v.y[keep], v.z[keep]) for v in (ro, rd))
        chk = chk[keep]
    return d_min, t_min


def _edge_closest(map_fn, ro: Vec3, rd: Vec3, chk, t_cap=None,
                  from_zero: bool = False):
    """The edge term's closest approach of the primary rays (JAX
    ``train.py:610-687``) over ``map_fn`` under their guards ``chk``,
    without t-cull: the exact march (capped at ``t_cap``) tracking the
    smallest map value, then the signed continuation through the surface a
    ray hit (32 steps from its hit); ``from_zero`` (``analytic_all``, which
    has no exact march) runs the continuation over the whole ray from t = 0
    instead.  Returns ``(d_min, t_min, id)``: the id of a map tap at t_min
    (-1 where nothing was tracked)."""
    n = ro.x.shape[0]
    if from_zero:
        d_min = torch.full_like(ro.x, BIG)
        t_min = torch.zeros_like(ro.x)
        lanes = torch.arange(n, device=ro.x.device)
        t0, cap = torch.zeros_like(ro.x), STEPS + 32
    else:
        t_ex, _, d_min, t_min = cast_ray(lambda p, c: map_fn(p, c[0]), ro, rd,
                                         (chk,), closest=True, t_cap=t_cap)
        lanes = torch.nonzero(d_min < MHD).flatten()
        t0, cap = t_ex[lanes], 32
    c_dmin, c_tmin = _continue_march(
        map_fn, Vec3(*(c[lanes] for c in ro)), Vec3(*(c[lanes] for c in rd)),
        chk[lanes], t0, cap)
    deeper = c_dmin < d_min[lanes]
    t_min[lanes] = torch.where(deeper, c_tmin, t_min[lanes])
    d_min[lanes] = torch.minimum(d_min[lanes], c_dmin)
    _, e_id = map_fn(ro + rd * t_min, chk)
    return d_min, t_min, torch.where(d_min < 0.5 * BIG, e_id,
                                     torch.full_like(e_id, -1))


def _leaves(prog: Program, vals, records=None):
    """(kind, slots, box, shape id) of every leaf in walk order; with
    ``records``, op indices in walk order (a warp's list, a row of
    ``warp_records``), of those leaves only: the exclusion list a warp of
    the kernel walks."""
    ops = prog.ops.tolist()
    if records is not None:
        ops = [ops[int(r)] for r in records]
    return [(op[1], vals[op[2]:op[2] + GEOM_SLOTS[op[1]]], op[3], op[4])
            for op in ops if op[0] == OPC_SHAPE]


def _excl_fold(leaves, p: Vec3, chk, excl1, excl2, count=None):
    """The union of leaves with the shapes ``excl1``, ``excl2`` (per lane)
    left out, guarded leaves under the bounce's checks: ``(d, id)``, BIG and
    -1 where nothing is left (JAX ``_make_excl_closest``'s fold)."""
    d = torch.full_like(p.x, BIG)
    i = torch.full_like(p.x, -1, dtype=torch.int32)
    for kind, g, box, sid in leaves:
        _tally(count, ("excl", kind), p.x.shape[0])
        ld = leaf_distance(kind, p, g)
        m = (excl1 != sid) & (excl2 != sid)
        if box >= 0:
            m = m & chk[:, box]
        better = m & (ld < d)
        d = torch.where(better, ld, d)
        i = torch.where(better, torch.full_like(i, sid), i)
    return d, i


def _excl_closest(leaves, ro: Vec3, rd: Vec3, chk, excl1, excl2, t_stop,
                  count=None):
    """The secondary edge estimator's march (JAX ``_make_excl_closest``):
    from t = 0 over the exclusion fold with steps of ``max(|d|,
    EDGE_STEP)``, tracking ``(d_min, t_min)``, until the ray leaves the
    first leaf it entered or passes FP or ``t_stop``, at most STEPS steps;
    then the id at the argmin point (-1 when nothing was tracked)."""
    n = ro.x.shape[0]
    d_min = torch.full_like(ro.x, BIG)
    t_min = torch.zeros_like(ro.x)
    was_neg = torch.zeros_like(ro.x, dtype=torch.bool)
    live = torch.arange(n, device=ro.x.device)
    lt = torch.zeros_like(ro.x)
    r, d_, c, e1, e2, ts = ro, rd, chk, excl1, excl2, t_stop
    for _ in range(STEPS):
        if live.numel() == 0:
            break
        d, _ = _excl_fold(leaves, r + d_ * lt, c, e1, e2, count)
        better = d < d_min[live]
        d_min[live] = torch.where(better, d, d_min[live])
        t_min[live] = torch.where(better, lt, t_min[live])
        nt = lt + torch.clamp(torch.abs(d), min=EDGE_STEP)
        done = (was_neg[live] & (d > 0.0)) | (nt > FP) | (nt > ts)
        was_neg[live] = was_neg[live] | (d < 0.0)
        keep = ~done
        live, lt = live[keep], nt[keep]
        r, d_ = (Vec3(v.x[keep], v.y[keep], v.z[keep]) for v in (r, d_))
        c, e1, e2, ts = c[keep], e1[keep], e2[keep], ts[keep]
    _, i_min = _excl_fold(leaves, ro + rd * t_min, chk, excl1, excl2, count)
    i_min = torch.where(d_min < 0.5 * BIG, i_min, torch.full_like(i_min, -1))
    return d_min, t_min, i_min


def _edge_slope(map_checked, ro: Vec3, rd: Vec3, t, chk):
    """The slope factor of the coverage bandwidth (JAX ``_edge_slope``):
    the ray-perpendicular part of the 6-tap map gradient at ``ro + rd t``
    under the full guards, clipped to [0.15, 1]."""
    n = calc_normal(map_checked, ro + rd * t, (chk,))
    g_par = n.x * rd.x + n.y * rd.y + n.z * rd.z
    perp = sqrt_rn(torch.clamp(1.0 - g_par * g_par, min=1e-6))
    return torch.clamp(perp, 0.15, 1.0)


def _coverage_seed(col_cot: Vec3, proxy: Vec3, d_min, beta):
    """``-dL.proxy * sigma'(z) / beta`` with ``z = (MHD - d_min) / beta``."""
    cvg = torch.sigmoid((MHD - d_min) / beta)
    sig = cvg * (1.0 - cvg)
    return -(col_cot.x * proxy.x + col_cot.y * proxy.y
             + col_cot.z * proxy.z) * sig / beta


def _emission(mat: Mat) -> Vec3:
    return mat.light.normalize_safe() * mat.brightness


def leaf_partials(tables: FusedTables, p: Vec3, idx, seed, acc, count=None):
    """Add to ``acc`` (S, 15) the partials ``seed * d leaf_idx(p) / d
    slots`` of each lane's leaf ``idx`` (-1: none), by autograd of
    ``leaf_distance`` over per-lane copies of the slots (JAX
    ``winner_leaf_channels``), summed per shape."""
    kinds = tables.leaf_lut[:, 0].to(torch.int64)
    gslots = torch.as_tensor(baked_geom_slot_matrix(tables.spec),
                             device=idx.device)
    ok = (idx >= 0) & (seed != 0.0)
    if not bool(ok.any()):
        return
    sel = torch.nonzero(ok).flatten()
    ids = idx[sel].to(torch.int64)
    lane_kind = kinds[ids]
    bv = tables.bv.detach()
    for kind, nsl in GEOM_SLOTS.items():
        lanes = sel[lane_kind == kind]
        if lanes.numel() == 0:
            continue
        _tally(count, ("partials", kind), lanes.numel())
        lid = idx[lanes].to(torch.int64)
        with torch.enable_grad():
            sl = bv[gslots[lid, :nsl]].requires_grad_()
            d = leaf_distance(
                kind, Vec3(*(c[lanes] for c in p)),
                [sl[:, c] for c in range(nsl)])
            (g,) = torch.autograd.grad(d, sl, seed[lanes])
        acc[:, :nsl].index_add_(0, lid, g)


def _replay_adjoint(rng, ro_b: Vec3, rd_b: Vec3, thr_b: Vec3, t_b, g_b,
                    invd, mat_vals: Mat, cot):
    """Autograd of one bounce's shading replay (JAX ``train.py:760-791``)
    on lanes that hit: returns the cotangents of (ro, rd, thr), of t_aux
    and of the MAT_CHANNELS material channels, given those ``cot`` of the
    outputs (ro2, rd2, thr2, ret_incr)."""
    n_b = g_b.normalize_safe()
    a_fac = g_b * (float(_F32(-0.5 / EPS_N)) * invd)
    b_fac = a_fac * t_b
    with torch.enable_grad():
        ro = [c.detach().clone().requires_grad_() for c in ro_b]
        rd = [c.detach().clone().requires_grad_() for c in rd_b]
        thr = [c.detach().clone().requires_grad_() for c in thr_b]
        t_aux = torch.zeros_like(t_b).requires_grad_()
        dmat = [torch.zeros_like(t_b).requires_grad_() for _ in MAT_CHANNELS]
        rov, rdv, thrv = Vec3(*ro), Vec3(*rd), Vec3(*thr)
        t = (t_b + a_fac.dot(rov - ro_b) + b_fac.dot(rdv - rd_b) + t_aux)
        hit = rov + rdv * t
        flat = [rows for rows in (mat_vals.col.x, mat_vals.col.y,
                                  mat_vals.col.z, mat_vals.brightness,
                                  mat_vals.light.x, mat_vals.light.y,
                                  mat_vals.light.z, mat_vals.spec,
                                  mat_vals.spec_col.x, mat_vals.spec_col.y,
                                  mat_vals.spec_col.z, mat_vals.roughness,
                                  mat_vals.ior, mat_vals.refract_chance,
                                  mat_vals.refract_roughness,
                                  mat_vals.refract_col.x,
                                  mat_vals.refract_col.y,
                                  mat_vals.refract_col.z)]
        for j, c in enumerate(MAT_CHANNELS):
            flat[c] = flat[c] + dmat[j]
        mat = Mat(Vec3(*flat[0:3]), flat[3], Vec3(*flat[4:7]), flat[7],
                  Vec3(*flat[8:11]), flat[11], flat[12], flat[13], flat[14],
                  Vec3(*flat[15:18]))
        rng2, new_ro, new_rd, emit, thr_f, ray_p = shade_bounce(
            rng, rdv, hit, n_b, mat)
        ret_incr = emit * thrv
        new_thr = thrv * thr_f / ray_p
        p_rr = new_thr.max_component()
        _, r_rr = random_float01(rng2)
        surv = ~(r_rr > p_rr)
        p_pos = p_rr > 0.0
        inv_p = torch.where(p_pos, 1.0 / torch.where(p_pos, p_rr,
                                                     torch.ones_like(p_rr)),
                            torch.zeros_like(p_rr))
        thr2 = Vec3(*(torch.where(surv, c * inv_p, c) for c in new_thr))
        outs = [*new_ro, *new_rd, *thr2, *ret_incr]
        ins = [*ro, *rd, *thr, t_aux, *dmat]
        grads = torch.autograd.grad(outs, ins, [*cot[0], *cot[1], *cot[2],
                                                *cot[3]], allow_unused=True)
    grads = [torch.zeros_like(t_b) if g is None else g for g in grads]
    return (Vec3(*grads[0:3]), Vec3(*grads[3:6]), Vec3(*grads[6:9]),
            grads[9], grads[10:])


@torch.no_grad()
def fused_planes_plain(tables: FusedTables, target: torch.Tensor, frame: int,
                       fov: float, aspect: float, row_offset: int, *,
                       width: int, height: int, mode: FusedMode,
                       count: dict = None,
                       walk_stats: torch.Tensor = None) -> FusedOut:
    """What K4 computes, per pixel, in vectorized torch: the rows
    ``[row_offset, row_offset + crop_h)`` of the (height, width) frame,
    ``target`` the band's (3, crop_h, width) planes.  Phase 2 is autograd of
    the per-bounce replay (as the JAX kernel uses ``jax.vjp``) and of the
    leaf distances.  ``count``, a dict, accumulates the work (ray segments,
    map taps and leaf evaluations by kind, replays, leaf partials, exclusion
    folds).  ``walk_stats``, laid out as :func:`launch_train_fused`'s, takes
    the plain model of the kernel's per-warp lists (:func:`_count_lists`)."""
    prog, table = tables.prog, tables.table
    device = table.device
    crop_h = target.shape[1]
    b1 = mode.b1
    ys, xs = torch.meshgrid(
        torch.arange(row_offset, row_offset + crop_h, dtype=torch.int32,
                     device=device),
        torch.arange(width, dtype=torch.int32, device=device), indexing="ij")
    rng, ro, rd = camera_rays(xs, ys, frame, fov, aspect, width=width,
                              height=height)
    n = ro.x.shape[0]
    ro0, rd0 = ro, rd
    map_fn = make_map_program(prog, table.tolist(), count)
    warp = band_warps(width, crop_h, device)
    excl_prog = (build_program(tables.spec, "baked") if mode.edge_secondary
                 else None)

    def map_checked(p, checks):
        return map_fn(p, checks[0])

    mats = table[prog.f_mat:].view(prog.n_shapes, -1)
    # The exclusion march keeps every leaf, the skipped ones included.
    leaves = (_leaves(excl_prog, table.tolist()) if mode.edge_secondary
              else None)
    unboxed = mode.analytic_unboxed and prog.caps.shape[0] > 0
    if unboxed:
        cap_fn, cap_normal, closest_fn = make_analytic_unboxed(tables.spec)
        bv_t = table[:baked_layout(tables.spec).n_slots]
    if mode.analytic_all:
        cast_soa = make_cast_soa(tables.layout)
        normal_soa = make_normal_soa(tables.layout)

    zero = torch.zeros(n, dtype=torch.float32, device=device)
    ret = Vec3(zero, zero, zero)
    thr = Vec3.splat(torch.ones_like(zero))
    alive = torch.ones(n, dtype=torch.bool, device=device)
    idx_prev = torch.full((n,), -1, dtype=torch.int32, device=device)
    seg = []
    for b in range(b1):
        al = torch.nonzero(alive).flatten()
        ro_a, rd_a = (Vec3(*(c[al] for c in v)) for v in (ro, rd))
        _tally(count, "segments", al.numel())
        checks = None
        if mode.analytic_all:
            _tally(count, "analytic_segments", al.numel())
            t_a, idx_a = cast_soa(ro_a, rd_a, tables.soa_f, tables.soa_i)
        else:
            checks, _ = program_bounds(prog, table, ro_a, rd_a, True)
            t_cap = None
            if unboxed:
                _tally(count, "cap_segments", al.numel())
                t_cap, cap_idx = cap_fn(ro_a, rd_a, bv_t)
            t_a, idx_a = cast_tcull(prog, map_fn, ro_a, rd_a, checks, t_cap)
            _count_lists(walk_stats, b, prog, checks[0], warp[al])
        h = ~(t_a > FP)
        hl = al[h]
        hp = Vec3(*(o[h] + d[h] * t_a[h] for o, d in zip(ro_a, rd_a)))
        if mode.analytic_all:
            n_h = normal_soa(hp, idx_a[h], tables.soa_f, tables.soa_i)
            g_h = n_h * float(_F32(2.0 * EPS_N))
        elif unboxed:
            # A capped winner: its id, and its exact normal scaled so that
            # g * 0.5/eps is a unit normal (JAX train.py:508-515).
            hit_lanes = torch.nonzero(h).flatten()
            idx_a, g_h = capped_winners(
                t_a, t_cap, idx_a, cap_idx, hp, cap_normal, bv_t,
                float(_F32(2.0 * EPS_N)),
                lambda tp: calc_grad(map_checked, Vec3(*(c[tp] for c in hp)),
                                     take_lanes(checks[:1], hit_lanes[tp])))
            n_h = g_h.normalize_safe()
        else:
            g_h = calc_grad(map_checked, hp, take_lanes(checks[:1], h))
            n_h = g_h.normalize_safe()
        rd_h = Vec3(*(c[h] for c in rd_a))
        denom = g_h.dot(rd_h) * float(_F32(0.5 / EPS_N))
        safe = torch.abs(denom) > DENOM_EPS
        invd_h = torch.where(safe, 1.0 / torch.where(safe, denom,
                                                     torch.ones_like(denom)),
                             torch.zeros_like(denom))

        def full(vals, fill=0.0, dtype=torch.float32, lanes=hl):
            out = torch.full((n,), fill, dtype=dtype, device=device)
            out[lanes] = vals
            return out

        st = dict(ro=ro, rd=rd, thr=thr, rng=rng, alive=alive,
                  t=full(t_a, lanes=al),
                  idx=full(idx_a, -1, torch.int32, al),
                  g=Vec3(*(full(c) for c in g_h)), invd=full(invd_h),
                  ret=ret)
        if mode.edge_secondary and b >= 1:
            chk = (checks[0] if checks is not None else
                   program_bounds(prog, table, ro_a, rd_a, False)[0][0])
            sd, stt, si = _excl_closest(leaves, ro_a, rd_a, chk, idx_a,
                                        idx_prev[al], t_a, count)
            _count_lists(walk_stats, 2 * b1 + b, excl_prog, chk, warp[al],
                         shapes=True)
            st.update(d2=full(sd, BIG, lanes=al), t2=full(stt, lanes=al),
                      i2=full(si, -1, torch.int32, al))
        seg.append(st)
        idx_prev = st["idx"]

        # Shading and roulette of the lanes that hit (path_trace's bounce).
        mat = gather_material(mats, idx_a[h])
        thr_h = Vec3(*(c[hl] for c in thr))
        rng2, new_ro, new_rd, emit, thr_f, ray_p = shade_bounce(
            rng[hl], rd_h, hp, n_h, mat)
        ret = Vec3(*(c.index_add(0, hl, e) for c, e in zip(ret, emit * thr_h)))
        new_thr = thr_h * thr_f / ray_p
        p_rr = new_thr.max_component()
        rng3, r_rr = random_float01(rng2)
        surv = ~(r_rr > p_rr)
        p_pos = p_rr > 0.0
        inv_p = torch.where(p_pos, 1.0 / torch.where(p_pos, p_rr,
                                                     torch.ones_like(p_rr)),
                            torch.zeros_like(p_rr))
        thr2 = Vec3(*(torch.where(surv, c * inv_p, c) for c in new_thr))
        ro = Vec3(*(c.index_put((hl,), v) for c, v in zip(ro, new_ro)))
        rd = Vec3(*(c.index_put((hl,), v) for c, v in zip(rd, new_rd)))
        thr = Vec3(*(c.index_put((hl,), v) for c, v in zip(thr, thr2)))
        rng = rng.index_put((hl,), rng3)
        alive = torch.zeros_like(alive).index_put((hl,), surv)

    col = ret.stack(0)
    tgt = target.reshape(3, -1)
    seed_scale = float(_F32(2.0 / (width * height * 3)))
    col_cot = Vec3(*((col[c] - tgt[c]) * seed_scale for c in range(3)))

    S = tables.spec.n_shapes
    out = dict(col=col)
    if mode.winner:
        mat_acc = zero.new_zeros((S, len(MAT_CHANNELS)))
        geom_acc = zero.new_zeros((S, GEOM_CHANNELS))
        out.update(mat_acc=mat_acc, geom_acc=geom_acc)
    else:
        b1p = b1 + 1 if mode.edge_grad else b1
        seg_ro = zero.new_zeros((b1p, 3, n))
        seg_rd = zero.new_zeros((b1p, 3, n))
        seg_t = zero.new_zeros((b1p, n))
        seg_idx = torch.full((b1p, n), -1, dtype=torch.int32, device=device)
        seg_scale = zero.new_zeros((b1p, n))
        mat_cot = zero.new_zeros((b1, len(MAT_CHANNELS), n))
        for b, st in enumerate(seg):
            seg_ro[b] = st["ro"].stack(0)
            seg_rd[b] = st["rd"].stack(0)
            seg_t[b] = st["t"]
            seg_idx[b] = st["idx"]
        out.update(seg_ro=seg_ro, seg_rd=seg_rd, seg_t=seg_t, seg_idx=seg_idx,
                   seg_scale=seg_scale, mat_cot=mat_cot)

    # ---- phase 2: the reverse sweep, bounce by bounce ----
    ro_c = rd_c = thr_c = Vec3(zero, zero, zero)
    for b in range(b1 - 1, -1, -1):
        st = seg[b]
        act = st["alive"] & ~(st["t"] > FP)
        a = torch.nonzero(act).flatten()
        if a.numel() == 0:
            continue
        _tally(count, "replays", a.numel())

        def sub(v):
            return Vec3(*(c[a] for c in v))

        t_b, idx_b, invd = st["t"][a], st["idx"][a], st["invd"][a]
        ro_b, rd_b = sub(st["ro"]), sub(st["rd"])
        ro_g, rd_g, thr_g, t_cot, mat_g = _replay_adjoint(
            st["rng"][a], ro_b, rd_b, sub(st["thr"]), t_b, sub(st["g"]), invd,
            gather_material(mats, idx_b),
            (sub(ro_c), sub(rd_c), sub(thr_c), sub(col_cot)))
        ro_c = Vec3(*(c.index_put((a,), v) for c, v in zip(ro_c, ro_g)))
        rd_c = Vec3(*(c.index_put((a,), v) for c, v in zip(rd_c, rd_g)))
        thr_c = Vec3(*(c.index_put((a,), v) for c, v in zip(thr_c, thr_g)))
        scale = -t_cot * invd
        if mode.winner:
            ok = idx_b >= 0
            out["mat_acc"].index_add_(0, idx_b[ok].to(torch.int64),
                                      torch.stack(mat_g, 1)[ok])
            leaf_partials(tables, ro_b + rd_b * t_b, idx_b, scale,
                          out["geom_acc"], count)
        else:
            out["seg_scale"][b, a] = scale
            out["mat_cot"][b][:, a] = torch.stack(mat_g, 0)

    if mode.edge_grad:
        checks0, _ = program_bounds(prog, table, ro0, rd0, False)
        _tally(count, "edge_rays", n)
        # Every warp of the launch builds the edge term's list, also one
        # with no pixel of the band.
        _count_lists(walk_stats, b1, prog, checks0[0], warp,
                     4 * (-(-width // 16)) * -(-crop_h // 8))
        # The edge estimator's marches do not cull (module docstring): the
        # closest approach of the primary ray over the exact march, then
        # the signed continuation through the surface it hit; under
        # analytic_all the signed march runs the whole ray from t = 0.
        cap0 = None
        if unboxed:
            _tally(count, "cap_segments", n)
            cap0, _ = cap_fn(ro0, rd0, bv_t)
        e_dmin, e_tmin, e_imin = _edge_closest(map_fn, ro0, rd0, checks0[0],
                                               cap0, mode.analytic_all)
        if unboxed:
            # The skipped spheres are in no map tap: their closed-form
            # closest approach (JAX train.py:682-687).
            d_ca, t_ca, i_ca = closest_fn(ro0, rd0, bv_t)
            closer = d_ca < e_dmin
            e_imin = torch.where(closer, i_ca, e_imin)
            e_tmin = torch.where(closer, t_ca, e_tmin)
            e_dmin = torch.where(closer, d_ca, e_dmin)

        foot1, foot2 = edge_footprints(mode, height, fov)
        w = torch.zeros_like(zero)
        e = torch.nonzero(e_imin >= 0).flatten()
        if e.numel():
            ro_e, rd_e = (Vec3(*(c[e] for c in v)) for v in (ro0, rd0))
            tm = e_tmin[e]
            beta = (torch.clamp(tm, min=0.2) * foot1
                    * _edge_slope(map_checked, ro_e, rd_e, tm, checks0[0][e]))
            proxy_hit = e_dmin[e] < MHD
            emit = _emission(gather_material(mats, e_imin[e]))
            proxy = Vec3(*(torch.where(proxy_hit, r_[e], m_)
                           for r_, m_ in zip(ret, emit)))
            w[e] = _coverage_seed(Vec3(*(c[e] for c in col_cot)), proxy,
                                  e_dmin[e], beta)
        if mode.winner:
            leaf_partials(tables, ro0 + rd0 * e_tmin, e_imin, w,
                          out["geom_acc"], count)
        else:
            out["seg_idx"][b1] = e_imin
            out["seg_ro"][b1] = ro0.stack(0)
            out["seg_rd"][b1] = rd0.stack(0)
            out["seg_t"][b1] = e_tmin
            out["seg_scale"][b1] = w

    if mode.edge_secondary:
        acc2 = out["geom_acc"] if mode.winner else zero.new_zeros(
            (S, GEOM_CHANNELS))
        for b in range(1, b1):
            st = seg[b]
            ok = torch.nonzero((st["i2"] >= 0) & st["alive"]).flatten()
            if ok.numel() == 0:
                continue
            ro_b, rd_b, thr_b, ret_b = (Vec3(*(c[ok] for c in st[k]))
                                        for k in ("ro", "rd", "thr", "ret"))
            t2, i2 = st["t2"][ok], st["i2"][ok]
            chk_b = program_bounds(prog, table, ro_b, rd_b, False)[0][0]
            _count_lists(walk_stats, b1 + b, prog, chk_b, warp[ok])
            beta2 = (torch.clamp(t2, min=0.2) * foot2
                     * _edge_slope(map_checked, ro_b, rd_b, t2, chk_b))
            emit2 = _emission(gather_material(mats, i2))
            prox = Vec3(*(tb * em - (r_[ok] - rb) for tb, em, r_, rb
                          in zip(thr_b, emit2, ret, ret_b)))
            w2 = _coverage_seed(Vec3(*(c[ok] for c in col_cot)), prox,
                                st["d2"][ok], beta2)
            leaf_partials(tables, ro_b + rd_b * t2, i2, w2, acc2, count)
        if not mode.winner:
            out["geom2_acc"] = acc2
    return FusedOut(**out)


def _count_lists(walk_stats, i, prog: Program, check, warp, n_warps=None,
                 shapes: bool = False) -> None:
    """Adds to row ``i`` of ``walk_stats`` (when not None) the summed length
    and the number of the kernel's per-warp lists (warp_records) over the
    lanes whose guard bits are ``check`` and warps ``warp``: a list for each
    warp that holds one of them or, with ``n_warps``, for each of the
    launch's ``n_warps`` warps.  ``shapes`` counts the exclusion list, the
    SHAPE records of each row (those ``_leaves(prog, vals, records=)``
    keeps)."""
    if walk_stats is None:
        return
    if n_warps is None:
        groups, warp = torch.unique(warp, return_inverse=True)
        n_warps = groups.shape[0]
    rows = warp_records(prog, check, warp, n_warps)
    if shapes:
        rows = rows[:, torch.from_numpy(prog.ops[:, 0] == OPC_SHAPE).to(
            rows.device)]
    walk_stats[2 * i] += rows.sum()
    walk_stats[2 * i + 1] += n_warps


# -- the kernel ----------------------------------------------------------------


def _partial_rows(width: int, crop_h: int) -> int:
    """Rows of (S, C) partial sums a launch needs: one per thread block of
    (16, 8) pixels, then one per group of 128 blocks (train_fused.cu)."""
    blocks = -(-width // 16) * -(-crop_h // 8)
    return blocks + -(-blocks // 128)


def band_warps(width: int, crop_h: int, device=None) -> torch.Tensor:
    """The kernel's warp of each pixel of a band ``crop_h`` rows high, flat
    in row-major order: its blocks, so its warps, tile the band's own rows,
    whatever the band's row_offset."""
    ys, xs = torch.meshgrid(
        torch.arange(crop_h, dtype=torch.int32, device=device),
        torch.arange(width, dtype=torch.int32, device=device), indexing="ij")
    return warp_ids(xs, ys, width)


@lru_cache(maxsize=None)
def _excl_program(spec: SceneSpec) -> Program:
    """The full baked program, whose leaves the secondary exclusion march
    folds.  The kernel tests them against the march program's guard words,
    so the two must number their boxes alike: the skip program of
    ``analytic_unboxed`` leaves out only guard-less shapes, so they do, and
    this checks it."""
    full = build_program(spec, "baked")
    skip = build_program(spec, "baked", True)

    def boxes(prog):
        return {op[4]: op[3] for op in prog.ops.tolist() if op[0] == OPC_SHAPE}

    fb, sb = boxes(full), boxes(skip)
    if (full.n_boxed != skip.n_boxed or any(fb[i] != b for i, b in sb.items())
            or any(fb[i] >= 0 for i in fb.keys() - sb.keys())):
        raise AssertionError("the full program numbers its boxes unlike the "
                             "march program")
    return full


def launch_train_fused(tables: FusedTables, target: torch.Tensor, frame: int,
                       fov: float, aspect: float, row_offset: int, *,
                       width: int, height: int, mode: FusedMode,
                       walk_stats: torch.Tensor = None) -> FusedOut:
    """Launch K4 on CUDA tables and the band's (3, crop_h, width) target, on
    the current stream, without synchronising; counts the launch in
    ``LAUNCHES["train_fused"]``.  Returns the same outputs as
    :func:`fused_planes_plain`.

    Each block stages the program in shared memory behind its sums
    (``fused_smem_bytes``, which raises for a step a block cannot hold);
    ``walk_stats``, a zeroed int64 CUDA tensor of 6 (bounces + 1), then
    takes the summed length and the count of its warps' lists, as (3,
    bounces + 1, 2): [0, b] phase 1's march of bounce b, [1, 0] the edge
    term's, [1, b] the secondary rows' slope taps of bounce b, [2, b] the
    exclusion march of bounce b (b >= 1)."""
    prog, table = tables.prog, tables.table
    device = table.device
    if not 0 <= mode.bounces <= MAX_BOUNCES:
        raise ValueError(f"the fused kernel keeps 0 to {MAX_BOUNCES} "
                         f"bounces per pixel, not {mode.bounces}")
    if (target.device != device or target.dtype != torch.float32
            or target.dim() != 3 or target.shape[0] != 3
            or target.shape[2] != width or not target.is_contiguous()):
        raise ValueError("target must be contiguous float32 (3, crop_h, "
                         f"{width}) planes on {device}")
    if (table.dtype != torch.float32 or table.shape != (prog.f_len,)
            or not table.is_contiguous()):
        raise ValueError(f"table must be contiguous float32 ({prog.f_len},)")
    if mode.analytic_all and (tables.soa_f is None or tables.soa_f.device
                              != device):
        raise ValueError(f"analytic_all needs K1's packed tables on {device}")
    crop_h = target.shape[1]
    n = crop_h * width
    S, b1, c_acc = tables.spec.n_shapes, mode.b1, mode.n_acc
    smem = fused_smem_bytes(prog, WARPS, c_acc,
                            not mode.analytic_all or mode.edge_grad,
                            mode.edge_secondary)
    if walk_stats is not None and (
            walk_stats.device != device or walk_stats.dtype != torch.int64
            or walk_stats.shape != (6 * b1,)
            or not walk_stats.is_contiguous()):
        raise ValueError(f"walk_stats must be contiguous int64 ({6 * b1},) "
                         f"on {device}")
    f32 = dict(dtype=torch.float32, device=device)
    col = torch.empty((3, n), **f32)
    out = dict(col=col)
    acc = part = None
    if c_acc:
        acc = torch.empty((S, c_acc), **f32)
        part = torch.empty((_partial_rows(width, crop_h), S, c_acc), **f32)
    planes = [None] * 6
    if not mode.winner:
        b1p = b1 + 1 if mode.edge_grad else b1
        planes = [torch.empty((b1p, 3, n), **f32),
                  torch.empty((b1p, 3, n), **f32),
                  torch.empty((b1p, n), **f32),
                  torch.empty((b1p, n), dtype=torch.int32, device=device),
                  torch.empty((b1p, n), **f32),
                  torch.empty((b1, len(MAT_CHANNELS), n), **f32)]
        out.update(zip(("seg_ro", "seg_rd", "seg_t", "seg_idx", "seg_scale",
                        "mat_cot"), planes))
    if mode.winner:
        out.update(mat_acc=acc[:, :len(MAT_CHANNELS)],
                   geom_acc=acc[:, len(MAT_CHANNELS):])
    elif mode.edge_secondary:
        out["geom2_acc"] = acc
    analytic = None
    if mode.analytic_all:
        from .megakernel import _kernel_meta

        kmeta, sid_lut = _kernel_meta(tables.layout, device)
        analytic = (tables.soa_f, tables.soa_i, kmeta, sid_lut)
    foot1, foot2 = edge_footprints(mode, height, fov)
    unboxed = mode.analytic_unboxed and prog.caps.shape[0] > 0
    flags = (int(mode.winner) | int(mode.edge_grad) << 1
             | int(mode.edge_secondary) << 2 | int(mode.analytic_all) << 3
             | int(unboxed) << 4)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    code = program_code_on(prog, device)
    # The secondary exclusion march reads every leaf of the full program.
    full = _excl_program(tables.spec)
    lib = load_library()
    with torch.cuda.device(device):
        err = lib.cpt_train_fused(
            code.data_ptr(), prog.ops.shape[0], prog.caps.shape[0],
            program_code_on(full, device).data_ptr(), full.ops.shape[0],
            table.data_ptr(), prog.n_boxed, prog.f_box, prog.f_mat,
            tables.leaf_lut.data_ptr(),
            S, *(ptr(t) for t in (analytic or (None,) * 4)),
            len(tables.layout.kinds) if analytic else 0,
            target.data_ptr(), col.data_ptr(), ptr(part), ptr(acc),
            *(ptr(t) for t in planes), c_acc, width, height, crop_h,
            int(row_offset), int(frame), mode.bounces, float(fov),
            float(aspect), float(_F32(2.0 / (width * height * 3))), flags,
            foot1, foot2, smem, ptr(walk_stats),
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"train_fused launch failed: CUDA error {err}")
    LAUNCHES["train_fused"] += 1
    return FusedOut(**out)


def fused_planes(tables: FusedTables, target: torch.Tensor, frame: int,
                 fov: float, aspect: float, row_offset: int, *, width: int,
                 height: int, mode: FusedMode) -> FusedOut:
    """One fused launch on the tables' device: K4 on CUDA, its plain version
    on the CPU."""
    kw = dict(width=width, height=height, mode=mode)
    device = tables.table.device
    if device.type == "cpu":
        return fused_planes_plain(tables, target, frame, fov, aspect,
                                  row_offset, **kw)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    return launch_train_fused(tables, target, frame, fov, aspect, row_offset,
                              **kw)


# -- the step around the launch ------------------------------------------------


def _map_vjp(spec: SceneSpec, bv: torch.Tensor, out: FusedOut):
    """The f_theta term of the implicit gradient in the map-vjp mode: the
    gradient in ``bv`` of sum(map(ro + rd t) * scale) over every segment
    row with a non-zero scale (JAX ``geom_sum``), chunked."""
    map_fn, bounds = make_map_baked(spec), make_bounds_baked(spec)
    ro = out.seg_ro.permute(1, 0, 2).reshape(3, -1)
    rd = out.seg_rd.permute(1, 0, 2).reshape(3, -1)
    t, scale = out.seg_t.reshape(-1), out.seg_scale.reshape(-1)
    gv = torch.zeros_like(bv)
    live = torch.nonzero(scale != 0).flatten()
    for lo in range(0, live.numel(), BACKWARD_CHUNK):
        sel = live[lo:lo + BACKWARD_CHUNK]
        o, d = Vec3(*ro[:, sel]), Vec3(*rd[:, sel])
        checks = bounds(o, d, bv)[0]
        with torch.enable_grad():
            g = bv.detach().requires_grad_()
            dist, _ = map_fn(o + d * t[sel], g, checks)
            gv = gv + torch.autograd.grad(dist, g, scale[sel])[0]
    return gv


def _geom_scatter(spec: SceneSpec, bv: torch.Tensor, acc: torch.Tensor):
    """The (S, 15) per-shape geometry sums scattered into bv's slots."""
    slots = torch.as_tensor(baked_geom_slot_matrix(spec), device=bv.device)
    ok = slots >= 0
    return torch.zeros_like(bv).index_add_(0, slots[ok], acc[ok])


def _fused_sse_and_grad_impl(spec: SceneSpec, params: torch.Tensor,
                             target: torch.Tensor, frame: int, fov: float,
                             aspect: float, row_offset: int, *, width: int,
                             height: int, mode: FusedMode):
    """The band-shardable core: renders the rows ``[row_offset, row_offset
    + crop_h)`` of the (height, width) frame against the band's (3, crop_h,
    width) ``target`` planes and returns the band's summed squared error,
    its share of the whole frame's mean-loss gradient, and the (3, crop_h,
    width) color planes."""
    p = params.detach().requires_grad_()
    with torch.enable_grad():
        tables = fused_tables(spec, p, mode.analytic_all,
                              mode.analytic_unboxed)
    out = fused_planes(tables, target, frame, fov, aspect, row_offset,
                       width=width, height=height, mode=mode)
    crop_h = target.shape[1]
    col = out.col.view(3, crop_h, width)
    sse = torch.sum((col - target) ** 2)
    bv = tables.bv
    if mode.winner:
        gv_cot = _geom_scatter(spec, bv, out.geom_acc)
        g_chan = out.mat_acc
    else:
        gv_cot = _map_vjp(spec, bv.detach(), out)
        if mode.edge_secondary:
            gv_cot = gv_cot + _geom_scatter(spec, bv, out.geom2_acc)
        g_chan = _segment_matmul(out.seg_idx[:mode.b1], out.mat_cot,
                                 spec.n_shapes)
    (g_geom,) = torch.autograd.grad(bv, p, gv_cot)
    slots = torch.as_tensor(material_slot_matrix(spec)[:, list(MAT_CHANNELS)],
                            device=params.device)
    g_mat = torch.zeros_like(g_geom).index_add_(0, slots.reshape(-1),
                                                g_chan.reshape(-1))
    return sse, g_geom + g_mat, col


def make_fused_value_and_grad(
    spec: SceneSpec,
    target,
    *,
    width: int,
    height: int,
    bounces: int = 2,
    fov: float = DEFAULT_FOV,
    aspect: float = None,
    with_image: bool = False,
    analytic_unboxed: bool = False,
    edge_grad: bool = False,
    edge_beta: float = 0.5,
    edge_secondary: bool = False,
    edge_beta2: float = 2.0,
    spp: int = 1,
    analytic_all: bool = False,
):
    """Build ``step(params, frame=0) -> (loss, grad)``: the MSE between the
    rendered frame and ``target`` (an (H, W, 3) array or tensor) and its
    gradient in the flat parameter vector, the whole per-pixel backward in
    one K4 launch per sample on a CUDA tensor (its plain version on a CPU
    one).  ``with_image=True`` also returns the (H, W, 3) image.

    ``spp > 1`` averages loss and gradient over the frame streams ``frame *
    spp + s``, s in [0, spp).  ``edge_grad`` adds the primary-silhouette
    coverage term (without it no geometry slot gets a gradient: this
    shading model's smooth geometry gradient is zero); ``edge_secondary``
    (needs ``edge_grad``) the secondary-bounce term; ``analytic_all``
    (union-only trees) takes phase 1 in K1's closed form;
    ``analytic_unboxed`` caps phase 1's march with the closed form of the
    guard-less shapes of ``analytic_eligible_ids`` (a no-op where there are
    none).  The loss and the image do not depend on the edge options."""
    if edge_secondary and not edge_grad:
        raise ValueError("edge_secondary requires edge_grad")
    if spp < 1:
        raise ValueError("spp must be >= 1")
    if analytic_all and analytic_unboxed:
        raise ValueError("analytic_all subsumes analytic_unboxed; enable "
                         "only one")
    winner = spec_is_union_only(spec)
    if analytic_all and not winner:
        raise ValueError("analytic_all requires a union-only tree")
    mode = FusedMode(bounces, winner, edge_grad, edge_secondary, analytic_all,
                     edge_beta, edge_beta2, analytic_unboxed)
    if aspect is None:
        aspect = width / height
    tgt = torch.as_tensor(np.array(target, np.float32) if not isinstance(
        target, torch.Tensor) else target, dtype=torch.float32)
    if tuple(tgt.shape) != (height, width, 3):
        raise ValueError(f"target must be ({height}, {width}, 3)")
    planes = {}
    inv_n = 1.0 / float(width * height * 3)

    def step(params: torch.Tensor, frame: int = 0):
        check_no_refraction(spec, params)
        device = params.device
        if device not in planes:
            planes[device] = tgt.to(device).permute(2, 0, 1).contiguous()
        pv = params.detach().to(torch.float32)
        sse = grad = col_acc = None
        for s in range(spp):
            sse_s, grad_s, col = _fused_sse_and_grad_impl(
                spec, pv, planes[device], int(frame) * spp + s, fov, aspect,
                0, width=width, height=height, mode=mode)
            sse = sse_s if sse is None else sse + sse_s
            grad = grad_s if grad is None else grad + grad_s
            if with_image:
                col_acc = col if col_acc is None else col_acc + col
        inv_spp = 1.0 / spp
        loss = sse * inv_n * inv_spp
        if with_image:
            return loss, grad * inv_spp, col_acc.permute(1, 2, 0) * inv_spp
        return loss, grad * inv_spp

    return step
