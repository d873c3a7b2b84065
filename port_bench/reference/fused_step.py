"""The fused inverse step's loss and gradient, written again over the
frozen renderer: the MSE between one sample of the frame and the target,
and its gradient in the flat parameter vector, with the fused step's
semantics (the program's ``kernels/train.py``, commit 8039d02): baked
geometry, the t-culled march, the 6-tap normal detached in the backward,
the hit distance linearised by the implicit identity, each bounce's
shading replayed under autograd, the winning leaf's partials, and the
primary-silhouette coverage term (``edge_grad``).  It takes the union-only
trees the benchmark's configurations hold (the winner-leaf mode), without
the secondary edge term, the closed-form caps or K1's closed form.

Phase 1 and the phase-2 sweep follow ``fused_planes_plain`` line for line
over the flat-union map (``fastmap.py``, bit for bit the frozen map); the
bake and its vjp are the frozen ``bake`` under autograd."""

from __future__ import annotations

import numpy as np
import torch

from . import tcull
from .count import fused_ops, make_tally_taps
from .fastmap import make_flat_map
from .tracer.constants import BIG, FP, MHD
from .tracer.ops.rng import random_float01
from .tracer.precision import quantize
from .tracer.render.baked import (
    GEOM_CHANNELS,
    GEOM_SLOTS,
    bake,
    baked_geom_slot_matrix,
    baked_shapes_in_order,
    leaf_distance,
)
from .tracer.render.reference import (
    Mat,
    calc_grad,
    calc_normal,
    camera_rays,
    cast_ray,
    gather_material,
    shade_bounce,
)
from .tracer.render.scenegen import material_slot_matrix
from .tracer.vecmath import Vec3, sqrt_rn

EPS_N = 1e-4       # central-difference epsilon
DENOM_EPS = 1e-6   # implicit-gradient denominator clamp
EDGE_STEP = 2e-3   # floored step of the signed continuation march
MAT_CHANNELS = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13)
_F32 = np.float32


def _tally(count, key, n):
    if count is not None:
        count[key] = count.get(key, 0) + int(n)


def _continue_march(map_fn, ro: Vec3, rd: Vec3, chk, t0, cap):
    """The signed continuation: from ``t0``, steps of ``max(|d|,
    EDGE_STEP)`` under the guards ``chk``, tracking the smallest signed map
    value, until the ray leaves the first shape it entered, passes FP, or
    ``cap`` steps."""
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


def _edge_closest(map_fn, ro: Vec3, rd: Vec3, chk):
    """The closest approach of the primary rays without t-cull: the exact
    march tracking the smallest map value, then the signed continuation
    through the surface a ray hit (32 steps).  Returns ``(d_min, t_min,
    id)``, the id of the map tap at t_min (-1 where nothing was
    tracked)."""
    t_ex, _, d_min, t_min = cast_ray(lambda p, c: map_fn(p, c[0]), ro, rd,
                                     (chk,), closest=True)
    lanes = torch.nonzero(d_min < MHD).flatten()
    c_dmin, c_tmin = _continue_march(
        map_fn, Vec3(*(c[lanes] for c in ro)), Vec3(*(c[lanes] for c in rd)),
        chk[lanes], t_ex[lanes], 32)
    deeper = c_dmin < d_min[lanes]
    t_min[lanes] = torch.where(deeper, c_tmin, t_min[lanes])
    d_min[lanes] = torch.minimum(d_min[lanes], c_dmin)
    _, e_id = map_fn(ro + rd * t_min, chk)
    return d_min, t_min, torch.where(d_min < 0.5 * BIG, e_id,
                                     torch.full_like(e_id, -1))


def _edge_slope(map_checked, ro: Vec3, rd: Vec3, t, chk):
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


def _leaf_partials(spec, kinds, bv, p: Vec3, idx, seed, acc, count=None):
    """Add to ``acc`` (S, 15) ``seed * d leaf_idx(p) / d slots`` of each
    lane's leaf ``idx`` (-1: none), summed per shape."""
    gslots = torch.as_tensor(baked_geom_slot_matrix(spec), device=idx.device)
    ok = (idx >= 0) & (seed != 0.0)
    if not bool(ok.any()):
        return
    sel = torch.nonzero(ok).flatten()
    lane_kind = kinds[idx[sel].to(torch.int64)]
    for kind, nsl in GEOM_SLOTS.items():
        lanes = sel[lane_kind == kind]
        if lanes.numel() == 0:
            continue
        _tally(count, ("partials", kind), lanes.numel())
        lid = idx[lanes].to(torch.int64)
        with torch.enable_grad():
            sl = bv[gslots[lid, :nsl]].requires_grad_()
            d = leaf_distance(kind, Vec3(*(c[lanes] for c in p)),
                              [sl[:, c] for c in range(nsl)])
            (g,) = torch.autograd.grad(d, sl, seed[lanes])
        acc[:, :nsl].index_add_(0, lid, g)


def _replay_adjoint(rng, ro_b: Vec3, rd_b: Vec3, thr_b: Vec3, t_b, g_b,
                    invd, mat_vals: Mat, cot):
    """Autograd of one bounce's shading replay on the lanes that hit: the
    cotangents of (ro, rd, thr), of t_aux and of the MAT_CHANNELS, given
    those ``cot`` of the outputs (ro2, rd2, thr2, ret_incr)."""
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
        flat = [mat_vals.col.x, mat_vals.col.y, mat_vals.col.z,
                mat_vals.brightness, mat_vals.light.x, mat_vals.light.y,
                mat_vals.light.z, mat_vals.spec, mat_vals.spec_col.x,
                mat_vals.spec_col.y, mat_vals.spec_col.z, mat_vals.roughness,
                mat_vals.ior, mat_vals.refract_chance,
                mat_vals.refract_roughness, mat_vals.refract_col.x,
                mat_vals.refract_col.y, mat_vals.refract_col.z]
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


def _planes(spec, bv, mats, rows, target, frame, *, width, height, bounces,
            fov, edge_beta, count=None):
    """Phase 1 and phase 2 over the pixels of the frame's ``rows``:
    returns ``(col (3, n), mat_acc (S, 13), geom_acc (S, 15))``."""
    device = bv.device
    leaves = tcull.boxed_leaves(spec)
    cull = torch.tensor([leaf[4] for leaf in leaves], dtype=torch.bool,
                        device=device)
    column = {leaf[0]: j for j, leaf in enumerate(leaves)}
    box, sph = tcull.boxes(leaves, bv), tcull.bounding_spheres(leaves, bv)
    flat = make_flat_map(spec, column)
    if flat is None:
        raise ValueError("the reference's fused step takes a flat union")
    kinds = torch.zeros(spec.n_shapes, dtype=torch.int64, device=device)
    for bs in baked_shapes_in_order(spec):
        kinds[bs.shape_id] = bs.kind

    tally_taps = make_tally_taps(spec, column)

    def map_fn(p, active):
        if count is not None:
            tally_taps(count, active)
        return flat(p, bv, active)

    def map_checked(p, checks):
        return map_fn(p, checks[0])

    ys, xs = torch.meshgrid(torch.as_tensor(rows, dtype=torch.int32,
                                            device=device),
                            torch.arange(width, dtype=torch.int32,
                                         device=device), indexing="ij")
    rng, ro, rd = camera_rays(xs, ys, frame, fov, width / height,
                              width=width, height=height)
    n = ro.x.shape[0]
    ro0, rd0 = ro, rd
    zero = torch.zeros(n, dtype=torch.float32, device=device)
    ret = Vec3(zero, zero, zero)
    thr = Vec3.splat(torch.ones_like(zero))
    alive = torch.ones(n, dtype=torch.bool, device=device)
    seg = []
    for b in range(bounces + 1):
        al = torch.nonzero(alive).flatten()
        ro_a, rd_a = (Vec3(*(c[al] for c in v)) for v in (ro, rd))
        _tally(count, "segments", al.numel())
        chk, lo, hi = tcull.bounds(ro_a, rd_a, box, sph)
        t_a, idx_a = tcull.cast(lambda p, a, rest: map_fn(p, a), ro_a, rd_a,
                                (chk, lo, hi), cull)
        h = ~(t_a > FP)
        hl = al[h]
        hp = Vec3(*(quantize(o[h] + d[h] * t_a[h]) for o, d in zip(ro_a, rd_a)))
        g_h = calc_grad(map_checked, hp, (chk[h],))
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

        seg.append(dict(ro=ro, rd=rd, thr=thr, rng=rng, alive=alive,
                        t=full(t_a, lanes=al),
                        idx=full(idx_a, -1, torch.int32, al),
                        g=Vec3(*(full(c) for c in g_h)), invd=full(invd_h)))
        mat = gather_material(mats, idx_a[h])
        thr_h = Vec3(*(c[hl] for c in thr))
        rng2, new_ro, new_rd, emit, thr_f, ray_p = shade_bounce(
            rng[hl], rd_h, hp, n_h, mat)
        ret = Vec3(*(c.index_add(0, hl, quantize(e))
                     for c, e in zip(ret, emit * thr_h)))
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
    S = spec.n_shapes
    mat_acc = zero.new_zeros((S, len(MAT_CHANNELS)))
    geom_acc = zero.new_zeros((S, GEOM_CHANNELS))

    ro_c = rd_c = thr_c = Vec3(zero, zero, zero)
    for b in range(bounces, -1, -1):
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
        ok = idx_b >= 0
        mat_acc.index_add_(0, idx_b[ok].to(torch.int64),
                           torch.stack(mat_g, 1)[ok])
        _leaf_partials(spec, kinds, bv, ro_b + rd_b * t_b, idx_b, scale,
                       geom_acc, count)

    chk0 = tcull.bounds(ro0, rd0, box, sph)[0]
    _tally(count, "edge_rays", n)
    e_dmin, e_tmin, e_imin = _edge_closest(map_fn, ro0, rd0, chk0)
    foot = float(_F32(_F32(2.0 * edge_beta / height) / _F32(fov)))
    w = torch.zeros_like(zero)
    e = torch.nonzero(e_imin >= 0).flatten()
    if e.numel():
        ro_e, rd_e = (Vec3(*(c[e] for c in v)) for v in (ro0, rd0))
        tm = e_tmin[e]
        beta = (torch.clamp(tm, min=0.2) * foot
                * _edge_slope(map_checked, ro_e, rd_e, tm, chk0[e]))
        proxy_hit = e_dmin[e] < MHD
        emit = _emission(gather_material(mats, e_imin[e]))
        proxy = Vec3(*(torch.where(proxy_hit, r_[e], m_)
                       for r_, m_ in zip(ret, emit)))
        w[e] = _coverage_seed(Vec3(*(c[e] for c in col_cot)), proxy,
                              e_dmin[e], beta)
    _leaf_partials(spec, kinds, bv, ro0 + rd0 * e_tmin, e_imin, w, geom_acc,
                   count)
    return col, mat_acc, geom_acc


def value_and_grad(spec, params: torch.Tensor, target: torch.Tensor, *,
                   width: int, height: int, bounces: int, fov: float,
                   frame: int = 0, edge_beta: float = 0.5, rows=None,
                   count=None):
    """``(loss, grad)`` of one fused step at ``params`` against ``target``
    ((3, H, W) planes), over the whole frame or, with ``rows``, over those
    rows only (the loss and gradient of their pixels, still scaled by the
    whole frame's size)."""
    if rows is None:
        rows = np.arange(height)
    p = params.detach().to(torch.float32).requires_grad_()
    with torch.enable_grad():
        bv = bake(spec, p)
    mat_slots = torch.as_tensor(material_slot_matrix(spec), dtype=torch.int64,
                                device=params.device)
    mats = p.detach()[mat_slots]
    tgt = target[:, torch.as_tensor(np.asarray(rows), dtype=torch.int64,
                                    device=params.device), :]
    col, mat_acc, geom_acc = _planes(
        spec, bv.detach(), mats, np.asarray(rows), tgt, frame, width=width,
        height=height, bounces=bounces, fov=fov, edge_beta=edge_beta,
        count=count)
    sse = torch.sum((col.view(tgt.shape) - tgt) ** 2)
    gslots = torch.as_tensor(baked_geom_slot_matrix(spec), device=params.device)
    ok = gslots >= 0
    gv_cot = torch.zeros_like(bv).index_add_(0, gslots[ok], geom_acc[ok])
    (g_geom,) = torch.autograd.grad(bv, p, gv_cot)
    slots = mat_slots[:, list(MAT_CHANNELS)]
    g_mat = torch.zeros_like(g_geom).index_add_(0, slots.reshape(-1),
                                                mat_acc.reshape(-1))
    loss = sse * (1.0 / float(width * height * 3))
    return loss.detach(), (g_geom + g_mat).detach()


def job_step(spec, params: torch.Tensor, target: torch.Tensor, *,
             options: dict, width: int, height: int, bounces: int,
             fov: float, rows=None, count=None):
    """The step of the program's ``optimize_to_target(**options)`` that
    this module stands for: the fused step with the edge term, at
    ``edge_beta`` when the options set it; ``target`` (H, W, 3).  Other
    options have no reference here."""
    opts = dict(options)
    if (opts.pop("fused", False) is not True
            or opts.pop("edge_grad", False) is not True
            or set(opts) - {"edge_beta"}):
        raise ValueError(f"no reference here for the job options {options}")
    return value_and_grad(spec, params, target.permute(2, 0, 1).contiguous(),
                          width=width, height=height, bounces=bounces,
                          fov=fov, edge_beta=opts.get("edge_beta", 0.5),
                          rows=rows, count=count)


def pinned_slots(spec) -> np.ndarray:
    """The slots the job leaves at their start: every refract_chance, as
    ``optimize_to_target(fused=True)`` pins them."""
    return material_slot_matrix(spec)[:, 13]


def work_ops(count: dict, spec) -> float:
    """FP32 operations of the work :func:`job_step` counted."""
    return fused_ops(count, spec)
