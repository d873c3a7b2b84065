"""Packed shape tables for the full-analytic bounce, and the plain closed-form
cast and normal over them.

Port of the JAX package's ``render/soa.py``.  ``build_soa_smem_layout`` and
``pack_soa_smem`` flatten a union-only scene into ONE float32 table
(per kind: geometry rows, own AABB rows, ancestor-guard AABB rows; then the
(n_shapes_pad, 18) material rows) and ONE int32 table (per kind: shape ids,
guard flags, ancestor-valid flags), with static per-kind offsets.  The CUDA
kernel (kernels/csrc/megakernel_analytic.cu) walks these tables at run time,
so one compiled kernel serves every union-only scene.

``make_cast_soa`` / ``make_normal_soa`` are the plain torch versions of the
kernel's nearest hit and winner normal over the same tables.  Semantics are
the JAX ``analytic_all`` mode's: a guarded shape is in a ray's map iff its
AABB ``check[]`` passes (aabb.glsl:21-33), shapes under a union's child
unions are clobbered out while an ancestor first-shape guard passes
(containers.rs:244-252), and equal-t ties pick the earlier shape in walk
order (strict ``<`` within a kind, a lexicographic (t, shape_id) combine
across kinds).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from ..constants import BIG, MAT_SIZE
from ..scene.compile import SceneSpec
from ..scene.model import KIND_CUBE, KIND_SPHERE, KIND_PLANE
from ..vecmath import Vec3, sqrt_rn
from .baked import GEOM_SLOTS, analytic_all_plan
from .scenegen import material_slot_matrix

SID_NONE = 2 ** 30  # "no shape" id of the lexicographic combine

# Rows per kind (and material rows) are padded to a multiple of this, as the
# JAX package pads them for its Mosaic kernel's unrolled shape loop, so that
# the packed tables stay equal to the JAX package's.  The CUDA kernel and the
# plain cast walk the real rows only.
UNROLL = 8

# Octahedron 4-slab axes (|x|+|y|+|z| <= s as diagonal half-space pairs).
OCT_AXES = ((1.0, 1.0, 1.0), (1.0, 1.0, -1.0),
            (1.0, -1.0, 1.0), (1.0, -1.0, -1.0))


@dataclass(frozen=True)
class SmemKind:
    kind: int
    n: int
    n_pad: int      # n rounded up to UNROLL
    w: int          # geometry slots per shape
    a: int          # padded ancestor-guard count
    f_geom: int     # f32 offsets
    f_aabb: int
    f_anc: int
    i_sid: int      # i32 offsets
    i_guard: int
    i_anc_valid: int


# eq=False: hashed by identity, so per-device copies of its index arrays can
# be cached against the (spec-cached) layout object.
@dataclass(frozen=True, eq=False)
class SoaSmemLayout:
    kinds: Tuple[SmemKind, ...]
    f_len: int
    i_len: int
    f_mat: int      # f32 offset of the (n_shapes_pad, 18) material values
    n_shapes: int
    n_shapes_pad: int
    bv_gather: np.ndarray    # (f_mat,) int32 indices into bv (0 on pad)
    bv_mask: np.ndarray      # (f_mat,) float32 1.0 on real entries
    mat_slots: np.ndarray    # (n_shapes_pad, 18) int32 indices into params
    i_const: np.ndarray      # (i_len,) int32 constant vector


@lru_cache(maxsize=None)
def build_soa_smem_layout(spec: SceneSpec) -> Optional[SoaSmemLayout]:
    """Static table layout; ``None`` when the scene is not union-only.

    Kinds and the material table are padded to a multiple of ``UNROLL``;
    pad rows carry guard=1 with a degenerate (never-hit) AABB, so membership
    excludes them by construction."""
    plan = analytic_all_plan(spec)
    if plan is None:
        return None
    aabb_off_of = {bs.shape_id: bs.aabb_off for bs, _ in plan if bs.aabb}
    max_anc = max((len(c) for _, c in plan), default=0)
    by_kind = {}
    for bs, clob in plan:
        by_kind.setdefault(bs.kind, []).append((bs, clob))

    kinds = []
    f_idx: list = []
    f_msk: list = []
    i_val: list = []

    def f_push(indices):
        f_idx.extend(int(i) for i in indices)
        f_msk.extend([1.0] * len(indices))

    def f_pad(count):
        f_idx.extend([0] * count)
        f_msk.extend([0.0] * count)

    for kind, rows in sorted(by_kind.items()):
        w = GEOM_SLOTS[kind]
        n = len(rows)
        n_pad = -(-n // UNROLL) * UNROLL
        pad = n_pad - n
        a = max_anc
        f_geom = len(f_idx)
        for bs, _ in rows:
            f_push(range(bs.off, bs.off + w))
        f_pad(pad * w)
        f_aabb = len(f_idx)
        for bs, _ in rows:
            if bs.aabb:
                f_push(range(bs.aabb_off, bs.aabb_off + 6))
            else:
                f_pad(6)
        f_pad(pad * 6)  # degenerate lo=hi=0 boxes: slab never hits
        f_anc = len(f_idx)
        for bs, clob in rows:
            for j in range(a):
                if j < len(clob):
                    o = aabb_off_of[clob[j]]
                    f_push(range(o, o + 6))
                else:
                    f_pad(6)
        f_pad(pad * a * 6)
        i_sid = len(i_val)
        i_val.extend(int(bs.shape_id) for bs, _ in rows)
        i_val.extend([-2] * pad)  # matches no lane (idx is -1 or >= 0)
        i_guard = len(i_val)
        i_val.extend(1 if bs.aabb else 0 for bs, _ in rows)
        i_val.extend([1] * pad)  # guarded + degenerate box = excluded
        i_anc_valid = len(i_val)
        for bs, clob in rows:
            i_val.extend([1] * len(clob) + [0] * (a - len(clob)))
        i_val.extend([0] * (pad * a))
        kinds.append(SmemKind(kind, n, n_pad, w, a, f_geom, f_aabb, f_anc,
                              i_sid, i_guard, i_anc_valid))

    f_mat = len(f_idx)
    slots = material_slot_matrix(spec)
    n_sh_pad = -(-spec.n_shapes // UNROLL) * UNROLL
    slots_pad = np.zeros((n_sh_pad, slots.shape[1]), np.int32)
    slots_pad[: spec.n_shapes] = slots
    return SoaSmemLayout(
        kinds=tuple(kinds),
        f_len=f_mat + n_sh_pad * slots.shape[1],
        i_len=len(i_val),
        f_mat=f_mat,
        n_shapes=spec.n_shapes,
        n_shapes_pad=n_sh_pad,
        bv_gather=np.asarray(f_idx, np.int32),
        bv_mask=np.asarray(f_msk, np.float32),
        mat_slots=slots_pad,
        i_const=np.asarray(i_val, np.int32),
    )


@lru_cache(maxsize=32)
def _layout_on(layout: SoaSmemLayout, device: torch.device):
    """The layout's packing recipes as tensors on ``device``, made once so
    that a frame's packing issues no host-to-device copies."""
    return (torch.as_tensor(layout.bv_gather, dtype=torch.int64, device=device),
            torch.as_tensor(layout.bv_mask, device=device),
            torch.as_tensor(layout.mat_slots, dtype=torch.int64, device=device),
            torch.as_tensor(layout.i_const, device=device))


def pack_soa_smem(layout: SoaSmemLayout, bv: torch.Tensor, params: torch.Tensor):
    """Per-frame packing: ``(f32 table, i32 table)`` on ``bv``'s device."""
    gather, mask, mat_slots, i_const = _layout_on(layout, bv.device)
    geo = bv[gather] * mask
    mat = params[mat_slots].reshape(-1)
    return torch.cat([geo, mat]).to(torch.float32), i_const


# -- plain closed-form cast / normal over the packed tables -------------------


def _full(ref, v):
    return torch.full_like(ref, v)


def _slab_t(oqs, dqs, halfs):
    """Nearest hit of a convex slab polytope |oq_k + t dq_k| <= b_k (cube: 3
    axis slabs; octahedron: 4 diagonal slabs); exit face from inside, BIG
    on a miss."""
    lo = _full(oqs[0], -BIG)
    hi = _full(oqs[0], BIG)
    for oq, dq, b in zip(oqs, dqs, halfs):
        ok = torch.abs(dq) > 1e-9
        inv = 1.0 / torch.where(ok, dq, torch.ones_like(dq))
        ta = (-b - oq) * inv
        tb = (b - oq) * inv
        axlo = torch.minimum(ta, tb)
        axhi = torch.maximum(ta, tb)
        inside = torch.abs(oq) <= b
        axlo = torch.where(ok, axlo, torch.where(inside, _full(oq, -BIG),
                                                 _full(oq, BIG)))
        axhi = torch.where(ok, axhi, torch.where(inside, _full(oq, BIG),
                                                 _full(oq, -BIG)))
        lo = torch.maximum(lo, axlo)
        hi = torch.minimum(hi, axhi)
    hit = (lo <= hi) & (hi > 0.0)
    return torch.where(hit, torch.where(lo > 0.0, lo, hi), _full(lo, BIG))


def _kind_t(kind, g, ro: Vec3, rd: Vec3):
    """Closed-form nearest hit of a (rows, slots) geometry block against
    (lanes,) rays -> (rows, lanes) t."""
    def col(i):
        return g[:, i:i + 1]

    if kind == KIND_SPHERE:
        ocx = ro.x - col(0)
        ocy = ro.y - col(1)
        ocz = ro.z - col(2)
        r = col(3)
        b = ocx * rd.x + ocy * rd.y + ocz * rd.z
        c = ocx * ocx + ocy * ocy + ocz * ocz - r * r
        disc = b * b - c  # |rd| == 1
        hit = disc >= 0.0
        root = sqrt_rn(torch.where(hit, disc, torch.zeros_like(disc)))
        t0 = -b - root
        t1 = -b + root
        big = _full(t0, BIG)
        t = torch.where(t0 > 0.0, t0, torch.where(t1 > 0.0, t1, big))
        return torch.where(hit, t, big)
    if kind == KIND_PLANE:
        denom = col(0) * rd.x + col(1) * rd.y + col(2) * rd.z
        f0 = col(0) * ro.x + col(1) * ro.y + col(2) * ro.z + col(3)
        ok = torch.abs(denom) > 1e-12
        big = _full(f0, BIG)
        t = torch.where(ok, -f0 / torch.where(ok, denom, torch.ones_like(denom)),
                        big)
        return torch.where(t > 0.0, t, big)
    # cube / octahedron: rows of the orthonormal leaf frame
    oq = tuple(col(3 * r) * ro.x + col(3 * r + 1) * ro.y
               + col(3 * r + 2) * ro.z + col(9 + r) for r in range(3))
    dq = tuple(col(3 * r) * rd.x + col(3 * r + 1) * rd.y
               + col(3 * r + 2) * rd.z for r in range(3))
    if kind == KIND_CUBE:
        return _slab_t(oq, dq, tuple(col(12 + r) for r in range(3)))
    s = col(12)
    oqs = tuple(a[0] * oq[0] + a[1] * oq[1] + a[2] * oq[2] for a in OCT_AXES)
    dqs = tuple(a[0] * dq[0] + a[1] * dq[1] + a[2] * dq[2] for a in OCT_AXES)
    return _slab_t(oqs, dqs, (s,) * 4)


def _kind_normal(kind, g, p: Vec3) -> Vec3:
    """Exact surface normal from per-lane geometry rows (lanes, slots)."""
    def col(i):
        return g[:, i]

    zero = torch.zeros_like(p.x)
    if kind == KIND_SPHERE:
        return Vec3(p.x - col(0), p.y - col(1),
                    p.z - col(2)).normalize_safe()
    if kind == KIND_PLANE:
        return Vec3(zero + col(0), zero + col(1), zero + col(2))
    q = tuple(col(3 * r) * p.x + col(3 * r + 1) * p.y
              + col(3 * r + 2) * p.z + col(9 + r) for r in range(3))
    if kind == KIND_CUBE:
        # Hit face = axis where |q| reaches its half-extent, signed by q.
        r0 = torch.abs(q[0]) - col(12)
        r1 = torch.abs(q[1]) - col(13)
        r2 = torch.abs(q[2]) - col(14)
        ax0 = (r0 >= r1) & (r0 >= r2)
        ax1 = (~ax0) & (r1 >= r2)
        nl = (torch.where(ax0, torch.sign(q[0]), zero),
              torch.where(ax1, torch.sign(q[1]), zero),
              torch.where(ax0 | ax1, zero, torch.sign(q[2])))
    else:
        # Hit face = diagonal slab whose |value| reaches s, signed by it.
        s = col(12)
        best = _full(p.x, -BIG)
        nl = [zero, zero, zero]
        for ax in OCT_AXES:
            v = ax[0] * q[0] + ax[1] * q[1] + ax[2] * q[2]
            r = torch.abs(v) - s
            take = r > best
            best = torch.where(take, r, best)
            sgn = torch.sign(v)
            nl = [torch.where(take, sgn * ax[i], nl[i]) for i in range(3)]
    # World normal = Mw^T n_leaf (Mw orthonormal).
    return Vec3(
        col(0) * nl[0] + col(3) * nl[1] + col(6) * nl[2],
        col(1) * nl[0] + col(4) * nl[1] + col(7) * nl[2],
        col(2) * nl[0] + col(5) * nl[1] + col(8) * nl[2],
    ).normalize_safe()


def _slab_hit(box, ro: Vec3, rd: Vec3):
    """(rows, lanes) AABB check of (rows, 6) boxes (aabb.glsl:21-33)."""
    t_min = Vec3(*((box[:, k:k + 1] - o) / d
                   for k, o, d in zip(range(3), ro, rd)))
    t_max = Vec3(*((box[:, 3 + k:4 + k] - o) / d
                   for k, o, d in zip(range(3), ro, rd)))
    tn = Vec3(torch.minimum(t_min.x, t_max.x), torch.minimum(t_min.y, t_max.y),
              torch.minimum(t_min.z, t_max.z)).max_component()
    tf = Vec3(torch.maximum(t_min.x, t_max.x), torch.maximum(t_min.y, t_max.y),
              torch.maximum(t_min.z, t_max.z)).min_component()
    return (tn < tf) & (tf > 0.0)


def _membership(aabb, guard, anc, anc_valid, ro: Vec3, rd: Vec3):
    """(rows, lanes) map membership: own AABB pass (or unguarded) AND no
    clobbering ancestor first-shape guard passes."""
    incl = _slab_hit(aabb, ro, rd) | (guard[:, None] == 0)
    rows, a = anc_valid.shape
    if a:
        anc_hit = _slab_hit(anc.reshape(rows * a, 6), ro, rd)
        anc_hit = anc_hit.reshape(rows, a, -1) & (anc_valid[..., None] != 0)
        incl = incl & ~anc_hit.any(dim=1)
    return incl


def _kind_tables(kd: SmemKind, soa_f, soa_i):
    geom = soa_f[kd.f_geom:kd.f_geom + kd.n_pad * kd.w].view(kd.n_pad, kd.w)
    aabb = soa_f[kd.f_aabb:kd.f_aabb + kd.n_pad * 6].view(kd.n_pad, 6)
    anc = soa_f[kd.f_anc:kd.f_anc + kd.n_pad * kd.a * 6].view(kd.n_pad,
                                                              kd.a, 6)
    sid = soa_i[kd.i_sid:kd.i_sid + kd.n_pad]
    guard = soa_i[kd.i_guard:kd.i_guard + kd.n_pad]
    anc_valid = soa_i[kd.i_anc_valid:kd.i_anc_valid + kd.n_pad * kd.a].view(
        kd.n_pad, kd.a)
    return geom, aabb, anc, sid, guard, anc_valid


def _flat(v: Vec3) -> Vec3:
    return Vec3(v.x.reshape(-1), v.y.reshape(-1), v.z.reshape(-1))


def make_cast_soa(layout: SoaSmemLayout):
    """``(ro, rd, soa_f, soa_i) -> (t, idx)``: nearest analytic hit over the
    whole scene (BIG and -1 on a miss), ``UNROLL`` table rows at a time."""

    def cast(ro: Vec3, rd: Vec3, soa_f, soa_i):
        shape = ro.x.shape
        ro_f, rd_f = _flat(ro), _flat(rd)
        t_best = _full(ro_f.x, BIG)
        sid_best = torch.full_like(ro_f.x, SID_NONE, dtype=torch.int32)
        for kd in layout.kinds:
            geom, aabb, anc, sid, guard, anc_valid = _kind_tables(kd, soa_f,
                                                                  soa_i)
            t_k = _full(ro_f.x, BIG)
            s_k = torch.full_like(sid_best, SID_NONE)
            for c0 in range(0, kd.n, UNROLL):
                rows = slice(c0, min(c0 + UNROLL, kd.n))
                t = _kind_t(kd.kind, geom[rows], ro_f, rd_f)
                incl = _membership(aabb[rows], guard[rows], anc[rows],
                                   anc_valid[rows], ro_f, rd_f)
                t = torch.where(incl, t, _full(t, BIG))
                # Rows are in walk order: a strict < keeps the earlier
                # shape on an equal t.
                for j in range(t.shape[0]):
                    better = t[j] < t_k
                    t_k = torch.where(better, t[j], t_k)
                    s_k = torch.where(better, sid[c0 + j], s_k)
            better = (t_k < t_best) | ((t_k == t_best) & (s_k < sid_best))
            t_best = torch.where(better, t_k, t_best)
            sid_best = torch.where(better, s_k, sid_best)
        idx = torch.where(sid_best == SID_NONE, torch.full_like(sid_best, -1),
                          sid_best)
        return t_best.reshape(shape), idx.reshape(shape)

    return cast


def make_normal_soa(layout: SoaSmemLayout):
    """``(p, idx, soa_f, soa_i) -> Vec3``: the winner's exact normal, read
    from its own table row (zero where ``idx`` is -1)."""

    def normal(p: Vec3, idx, soa_f, soa_i):
        shape = p.x.shape
        p_f = _flat(p)
        idx_f = idx.reshape(-1).to(torch.int64)
        safe = torch.where(idx_f >= 0, idx_f,
                           torch.full_like(idx_f, layout.n_shapes))
        zero = torch.zeros_like(p_f.x)
        n = Vec3(zero, zero, zero)
        for kd in layout.kinds:
            geom, _, _, sid, _, _ = _kind_tables(kd, soa_f, soa_i)
            # shape id -> row of this kind (-1 elsewhere; last slot = miss)
            lut = torch.full((layout.n_shapes + 1,), -1, dtype=torch.int64,
                             device=idx.device)
            lut[sid[:kd.n].to(torch.int64)] = torch.arange(
                kd.n, device=idx.device)
            row = lut[safe]
            cand = _kind_normal(kd.kind, geom[row.clamp(min=0)], p_f)
            mine = row >= 0
            n = Vec3(*(torch.where(mine, c, o) for c, o in zip(cand, n)))
        return Vec3(*(c.reshape(shape) for c in n))

    return normal


def material_table(layout: SoaSmemLayout, soa_f):
    """The (n_shapes_pad, 18) material rows of the f32 table."""
    return soa_f[layout.f_mat:layout.f_len].view(layout.n_shapes_pad,
                                                 MAT_SIZE)
