"""Differentiation of rendered pixels with respect to the scene parameters
(JAX package: ``diff/vjp.py``): gradients of the image with respect to the
flat parameter vector, for inverse rendering.

Two paths, as in the JAX package:

* **plain autodiff** (``implicit=False``): autograd through the oracle
  renderer, whose march and bounce loop update their state out of place;
* **implicit-function march** (``implicit=True``, the default): the march
  is wrapped in ``kernels.march.ImplicitCast``, which treats the hit
  distance t* as the root of f(ro + t rd, theta) = 0 and back-propagates
  with

      dt*/dtheta = -f_theta / (f_p . rd),
      dt*/dro    = -f_p     / (f_p . rd),
      dt*/drd    = -t* f_p  / (f_p . rd),

  evaluated at the hit point: one map vjp instead of an 80-step tape.

Both capture the smooth shading and geometry terms.  The silhouette
(visibility) terms are the JAX package's XLA edge estimators, in plain
torch here (they are outside every Pallas kernel there too):
``edge_grad`` adds the primary term, the Danskin-differentiable closest
approach of each primary ray (:func:`make_closest_approach` over
:func:`_march_closest`) driving a detached soft coverage; ``edge_secondary``
(with ``edge_grad``) adds the same per secondary segment, over the segments
``path_trace(collect_segments=True)`` returns.  The fused step of
kernels/train.py has its own edge terms.

Names: the JAX ``march="xla"`` (the march in the XLA graph) is the port's
``march="plain"`` (``cast_ray`` in torch), and ``march="pallas"`` (the
Pallas kernel K3) is ``march="kernel"``: on a CUDA tensor the CUDA kernel
``kernels/csrc/march_rays.cu``, t-interval-culled as the JAX kernel is by
default, and on a CPU tensor its plain torch version.  ``march_interpret``
has no counterpart.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import DEFAULT_FOV, FP, MHD, STEPS
from ..kernels.march import (
    BACKWARD_CHUNK,
    ImplicitCast,
    cast_outputs,
    make_kernel_cast,
)
from ..render.baked import bake, make_bounds_baked, make_map_baked
from ..render.reference import (
    calc_normal,
    calc_normal_autodiff,
    camera_rays,
    cast_ray,
    gather_material,
    path_trace,
    render_pixels,
    take_lanes,
)
from ..render.scenegen import make_bounds, make_map, material_slot_matrix
from ..scene.compile import SceneSpec
from ..vecmath import Vec3, sqrt_rn, vwhere

MARCHES = ("plain", "kernel")
NORMALS = ("central", "autodiff", "detached", "kernel")

# The secondary estimator excludes the surface a segment respawned from
# only for taps with t <= this (10x the OFFSET respawn distance): near the
# origin it would floor the minimum at about OFFSET, while far taps that
# skim its own edge are real self-occlusion edges (JAX ``_EDGE_T_SELF``).
EDGE_T_SELF = 0.3
# The least step while the closest-approach march crosses a surface.
CROSS_FLOOR = 2e-3
# The least t-separation of the second tracked valley from the running
# argmin: closer taps refine the same silhouette valley.
VALLEY_SEP = 0.05
# The empty closest-approach slot (JAX's 1e9).
EMPTY = 1e9


def make_implicit_cast(map_fn, gv: torch.Tensor):
    """``cast_fn(ro, rd, checks) -> (t, idx)`` for ``path_trace`` with an
    O(1)-memory implicit-gradient backward (JAX ``make_implicit_cast``): the
    forward is ``cast_ray`` over ``map_fn(p, gv, checks)`` with ``gv``
    detached, the backward one vjp of the same map at the hit points."""
    gv_fixed = gv.detach()

    def cast_fn(ro, rd, checks):
        def march(o, d):
            return cast_ray(lambda p, c: map_fn(p, gv_fixed, c), o, d, checks)

        return cast_outputs(ImplicitCast.apply(
            march, map_fn, lambda o, d: checks, gv, *ro, *rd))

    return cast_fn


@torch.no_grad()
def _march_closest(map_fn, ro: Vec3, rd: Vec3, checks, excl=(),
                   excl_tmax=None, t_stop=None):
    """The signed closest-approach march of (n,) rays (JAX ``_march_closest``):
    ``cast_ray``'s march through ``map_fn(p, checks) -> (d, idx)``, tracking
    over its taps the smallest signed map value ``d_min``, the t and the
    winner id it was taken at (``t_min``, ``i_min``), and the best tap
    ``(d2, t2)`` at least ``VALLEY_SEP`` along the ray from the running
    argmin (the second valley of a silhouette corner).

    The march goes on through the first surface it meets, its steps floored
    at ``CROSS_FLOOR``, and a ray stops on leaving the first shape it
    entered (d > 0 after d < 0), past the far plane, after ``STEPS`` taps or,
    with ``t_stop`` ((n,)), once its next t passes ``t_stop``.  ``excl``
    (per-ray int32 ids) keeps a tap whose winner is one of them out of the
    tracking (the march itself is unchanged); ``excl_tmax`` (one bound or
    None per id) limits an exclusion to taps with t at or below it.  At a
    tap that takes the argmin from a distinct valley the old minimum is
    demoted to slot 2; a tap that does not take it competes for slot 2,
    both against the old slot-1 state (the reference's order: slot 2 is
    admitted by t-separation alone).

    Each step evaluates only the rays still marching, which is the JAX
    version's masked 80-step loop lane by lane.  Returns ``(d_min, t_min,
    i_min, d2, t2)`` (``EMPTY``, 0, -1, ``EMPTY``, 0 on a ray that tracked
    no tap)."""
    n = ro.x.shape[0]
    d_min = torch.full_like(ro.x, EMPTY)
    t_min = torch.zeros_like(ro.x)
    i_min = torch.full((n,), -1, dtype=torch.int32, device=ro.x.device)
    d2, t2 = d_min.clone(), t_min.clone()
    tmaxes = tuple(excl_tmax or (None,) * len(excl))
    live = torch.arange(n, device=ro.x.device)
    t = torch.zeros_like(ro.x)
    was_neg = torch.zeros((n,), dtype=torch.bool, device=ro.x.device)
    for _ in range(STEPS):
        if live.numel() == 0:
            break
        d, mi = map_fn(ro + rd * t, checks)
        track = torch.ones_like(was_neg)
        for e, tm in zip(excl, tmaxes):
            skip = mi == e
            if tm is not None:
                skip = skip & (t <= tm)
            track = track & ~skip
        dm, tn, db, tb = d_min[live], t_min[live], d2[live], t2[live]
        better = track & (d < dm)
        sep = torch.abs(t - tn) > VALLEY_SEP
        demote = better & sep & (dm < db)
        db = torch.where(demote, dm, db)
        tb = torch.where(demote, tn, tb)
        better2 = track & ~better & sep & (d < db)
        d2[live] = torch.where(better2, d, db)
        t2[live] = torch.where(better2, t, tb)
        d_min[live] = torch.where(better, d, dm)
        t_min[live] = torch.where(better, t, tn)
        i_min[live] = torch.where(better, mi, i_min[live])
        nt = t + torch.clamp(torch.abs(d), min=CROSS_FLOOR)
        done = (nt > FP) | (was_neg & (d > 0.0))
        was_neg = was_neg | (d < 0.0)
        if t_stop is not None:
            done = done | (nt > t_stop)
        # One nonzero for every tensor of the step's survivors (a boolean
        # mask would find them again for each guard).
        keep = torch.nonzero(~done).flatten()
        live, t, was_neg = live[keep], nt[keep], was_neg[keep]
        ro, rd = Vec3(*(c[keep] for c in ro)), Vec3(*(c[keep] for c in rd))
        checks = take_lanes(checks, keep)
        excl = tuple(e[keep] for e in excl)
        if t_stop is not None:
            t_stop = t_stop[keep]
    return d_min, t_min, i_min, d2, t2


def _map_vjp(map_fn, gv, p: Vec3, cot, checks):
    """``(p_cot, gv_cot)``: the cotangent ``cot`` ((m,)) of the map value at
    the points ``p`` pulled back to the points (per ray) and to ``gv``
    (summed), over the rays with a non-zero ``cot`` in chunks of
    ``BACKWARD_CHUNK``."""
    gv_cot = torch.zeros_like(gv)
    p_cot = Vec3(*(torch.zeros_like(cot) for _ in range(3)))
    live = torch.nonzero(cot != 0).flatten()
    for lo in range(0, live.numel(), BACKWARD_CHUNK):
        sel = live[lo:lo + BACKWARD_CHUNK]
        with torch.enable_grad():
            q = [c[sel].detach().requires_grad_() for c in p]
            g = gv.detach().requires_grad_()
            dist, _ = map_fn(Vec3(*q), g, take_lanes(checks, sel))
            *gq, gg = torch.autograd.grad(dist, [*q, g], cot[sel],
                                          allow_unused=True)
        gv_cot = gv_cot + (torch.zeros_like(gv) if gg is None else gg)
        for acc, v in zip(p_cot, gq):
            if v is not None:
                acc.index_copy_(0, sel, v)
    return p_cot, gv_cot


class ClosestApproach(torch.autograd.Function):
    """``(d_min, t_min, i_min) = _march_closest(...)`` with the Danskin
    (envelope-theorem) backward of JAX ``make_closest_approach``: at the
    along-ray minimum, d(d_min) is the map's gradient at the fixed argmin
    point p* = ro + rd t_min,

        d(d_min)/dgv = f_gv(p*),  d(d_min)/dro = f_p(p*),
        d(d_min)/drd = t_min f_p(p*),

    one map vjp instead of an 80-step tape (the trick of
    kernels/march.py:ImplicitCast, beside which this sits).  With
    ``tie_scale`` the backward blends the Danskin gradients of the two
    valleys with ``w2 = sigmoid((d_min - d2) / (max(t_min, 0.2)
    tie_scale))``, at p* with weight 1 - w2 and at ro + rd t2 with w2 (an
    empty slot 2 gives w2 = 0 exactly).  ``t_min`` and ``i_min`` get no
    gradient.

    ``apply(map_fn, checks, excl, excl_tmax, t_stop, tie_scale, gv, ro.x,
    ro.y, ro.z, rd.x, rd.y, rd.z)``: ``map_fn(p, gv, checks)`` is the
    differentiable scene map, run with ``gv`` detached in the forward."""

    @staticmethod
    def forward(ctx, map_fn, checks, excl, excl_tmax, t_stop, tie_scale, gv,
                rox, roy, roz, rdx, rdy, rdz):
        gv_fixed = gv.detach()
        ro, rd = Vec3(rox, roy, roz), Vec3(rdx, rdy, rdz)
        d_min, t_min, i_min, d2, t2 = _march_closest(
            lambda p, c: map_fn(p, gv_fixed, c), ro, rd, checks, excl,
            excl_tmax, t_stop)
        ctx.save_for_backward(gv, rox, roy, roz, rdx, rdy, rdz, d_min, t_min,
                              d2, t2)
        ctx.map_fn, ctx.checks, ctx.tie_scale = map_fn, checks, tie_scale
        ctx.mark_non_differentiable(t_min, i_min)
        return d_min, t_min, i_min

    @staticmethod
    def backward(ctx, d_cot, *_):
        gv, rox, roy, roz, rdx, rdy, rdz, d_min, t_min, d2, t2 = \
            ctx.saved_tensors
        ro, rd = Vec3(rox, roy, roz), Vec3(rdx, rdy, rdz)
        p1 = ro + rd * t_min
        if ctx.tie_scale is None:
            g1, gv_cot = _map_vjp(ctx.map_fn, gv, p1, d_cot, ctx.checks)
            gro, grd = g1, g1 * t_min
        else:
            gamma = torch.clamp(t_min, min=0.2) * ctx.tie_scale
            w2 = torch.sigmoid((d_min - d2) / gamma)
            w1 = 1.0 - w2
            g1, gv1 = _map_vjp(ctx.map_fn, gv, p1, d_cot * w1, ctx.checks)
            g2, gv2 = _map_vjp(ctx.map_fn, gv, ro + rd * t2, d_cot * w2,
                               ctx.checks)
            gro = g1 + g2
            grd = g1 * t_min + g2 * t2
            gv_cot = gv1 + gv2
        return (None,) * 6 + (gv_cot, *gro, *grd)


def make_closest_approach(map_fn, excl_tmax=None):
    """``closest(ro, rd, gv, checks, excl=(), t_stop=None, tie_scale=None)
    -> (d_min, t_min, i_min)`` (JAX ``make_closest_approach``) through
    :class:`ClosestApproach`: ``map_fn(p, gv, checks) -> (d, idx)`` is the
    differentiable map, ``checks`` its guards on the rays (computed without
    a gradient), ``excl`` and ``t_stop`` as :func:`_march_closest`'s, and
    ``tie_scale`` (a float) switches on the two-valley blend."""

    def closest(ro: Vec3, rd: Vec3, gv, checks, excl=(), t_stop=None,
                tie_scale=None):
        return ClosestApproach.apply(
            map_fn, checks, tuple(e.detach() for e in excl), excl_tmax,
            None if t_stop is None else t_stop.detach(), tie_scale, gv,
            *ro, *rd)

    return closest


def _footprint(beta: float, height: int, fov: float) -> float:
    """``2 beta / (height fov)`` in float32, as the JAX estimator forms it:
    the pixel footprint per unit distance (one pixel subtends about
    2 / (height fov) of the image plane, ops/camera.py:calc_uv), times the
    bandwidth scale."""
    return float(np.float32(2.0 * beta)
                 / (np.float32(height) * np.float32(fov)))


def _blur5(p, shape):
    """The sum over the 5x5 neighbourhood of each pixel of ``p`` ((n,), laid
    out as ``shape``), wrapping around the image edges as ``jnp.roll``
    does."""
    p = p.reshape(shape)
    acc = torch.zeros_like(p)
    for dy in range(-2, 3):
        r = torch.roll(p, dy, 0)
        for dx in range(-2, 3):
            acc = acc + torch.roll(r, dx, 1)
    return acc.reshape(-1)


def _edge_terms(map_fn, bounds, gv, gather_mat, ro: Vec3, rd: Vec3, col: Vec3,
                segs, xs, *, bounces: int, height: int, fov: float,
                edge_beta: float, edge_secondary: bool, edge_beta2: float):
    """The silhouette corrections of JAX ``render_pixels_diff`` (``edge_grad``
    and ``edge_secondary``): a Vec3 of (n,) whose value is exactly zero and
    whose gradient is the estimator's.

    Primary: the closest approach of each primary ray (with the two-valley
    blend) drives the coverage ``c = sigmoid((MHD - d_min) / beta)``, beta
    the pixel footprint at ``t_min`` widened by the silhouette's slope, and
    the pixel gains ``(c - sg(c)) * sg(proxy)``: its own radiance where the
    ray hit, else the emission of the closest shape or, when ``xs`` is a
    2-D block of at least 5x5, the mean radiance of the hit pixels in its
    5x5 neighbourhood (wrapping around the edges).

    Secondary, per bounce b >= 1, on the lanes alive at b: the closest
    approach of the segment with its own hit and (below ``EDGE_T_SELF``)
    its respawn surface excluded, stopped at its hit distance, with the
    proxy ``thr_b * emit(i_b) - (col - ret_before_b)``, gated by ``i_b >=
    0``."""
    gv_fixed = gv.detach()

    def guards(o, d):
        with torch.no_grad():
            return bounds(o, d, gv_fixed)[0]

    @torch.no_grad()
    def edge_slope(o, d, t, checks):
        """The silhouette's slope factor: the share of the map gradient at
        o + d t across the ray, clipped to [0.15, 1]; dividing the
        bandwidth by it turns d_min into screen-space edge distance."""
        nrm = calc_normal(lambda q, c: map_fn(q, gv_fixed, c), o + d * t,
                          checks)
        g_par = nrm.dot(d)
        perp = sqrt_rn(torch.clamp(1.0 - g_par * g_par, min=1e-6))
        return torch.clamp(perp, 0.15, 1.0)

    def emission(idx):
        mat = gather_mat(idx)
        return Vec3(*(c.detach() for c in
                      mat.light.normalize_safe() * mat.brightness))

    sg = Vec3(*(c.detach() for c in col))
    foot = _footprint(edge_beta, height, fov)
    checks0 = guards(ro, rd)
    d_min, t_min, i_min = make_closest_approach(map_fn)(
        ro, rd, gv, checks0, tie_scale=foot)
    beta = (torch.clamp(t_min, min=0.2) * foot
            * edge_slope(ro, rd, t_min, checks0))
    c = torch.sigmoid((MHD - d_min) / beta)
    hit = d_min.detach() < MHD
    proxy_miss = emission(i_min)
    if xs.dim() == 2 and xs.shape[0] >= 5 and xs.shape[1] >= 5:
        hm = hit.to(d_min.dtype)
        den = _blur5(hm, xs.shape)
        nb = Vec3(*(_blur5(ch * hm, xs.shape) for ch in sg)) / torch.clamp(
            den, min=1e-6)
        proxy_miss = vwhere(den > 0.5, nb, proxy_miss)
    corr = vwhere(hit, sg, proxy_miss) * (c - c.detach())
    if not edge_secondary:
        return corr
    foot2 = _footprint(edge_beta2, height, fov)
    closest2 = make_closest_approach(map_fn, excl_tmax=(None, EDGE_T_SELF))
    for b in range(1, bounces + 1):
        lanes = torch.nonzero(segs.alive[b]).flatten()
        if lanes.numel() == 0:
            continue
        ro_b = Vec3(*(c[b][lanes] for c in segs.ro))
        rd_b = Vec3(*(c[b][lanes] for c in segs.rd))
        checks_b = guards(ro_b, rd_b)
        d_b, t_b, i_b = closest2(
            ro_b, rd_b, gv, checks_b, (segs.idx[b][lanes],
                                       segs.idx[b - 1][lanes]),
            t_stop=segs.t[b][lanes], tie_scale=foot2)
        beta_b = (torch.clamp(t_b, min=0.2) * foot2
                  * edge_slope(ro_b, rd_b, t_b, checks_b))
        c_b = torch.sigmoid((MHD - d_b) / beta_b)
        emit_b = emission(i_b)
        thr_b = Vec3(*(c[b][lanes].detach() for c in segs.thr))
        rem_b = Vec3(*(ch[lanes] - r[b][lanes].detach()
                       for ch, r in zip(sg, segs.ret_before)))
        proxy_b = thr_b * emit_b - rem_b
        corr_b = (c_b - c_b.detach()) * (i_b >= 0).to(c_b.dtype)
        corr = Vec3(*(acc.index_add(0, lanes, v)
                      for acc, v in zip(corr, proxy_b * corr_b)))
    return corr


def render_pixels_diff(
    spec: SceneSpec,
    params: torch.Tensor,
    xs,
    ys,
    frame,
    bounces: int,
    fov: float,
    aspect: float,
    *,
    width: int,
    height: int,
    implicit: bool = True,
    geometry: str = "faithful",
    edge_grad: bool = False,
    edge_beta: float = 0.5,
    edge_secondary: bool = False,
    edge_beta2: float = 2.0,
    march: str = "plain",
    normals: str = "central",
    remat: bool = False,
) -> Vec3:
    """Differentiable path-traced pixels ``(xs, ys)`` (int32, any shape;
    ``width``/``height`` are the full image's) on ``params``' device.

    ``implicit=False`` differentiates through the oracle renderer
    (``render_pixels``; ``march``, ``normals`` and ``remat`` are not read,
    as in the JAX package).  With ``implicit=True``:

    * ``march="plain"`` marches with ``cast_ray`` in torch,
      ``march="kernel"`` with K3 (``kernels/march.py``), t-culled; both
      back-propagate the implicit gradient at the hit;
    * ``normals``: ``"central"`` the 6-tap central difference, differentiated;
      ``"autodiff"`` the exact map gradient by autograd
      (``calc_normal_autodiff``); ``"detached"`` the central difference with
      no gradient (the shading-normal term is dropped, values unchanged);
      ``"kernel"`` (requires ``march="kernel"``) the normal K3 computes in
      the march, detached: the fused form of ``"detached"``;
    * ``geometry="baked"`` marches the leaf-baked map; ``bake`` is
      differentiable, so the baked vector's cotangent reaches the params;
    * ``remat=True`` checkpoints each bounce (recomputed in the backward).

    ``edge_grad=True`` adds the primary silhouette term and, with
    ``edge_secondary=True``, the secondary one (:func:`_edge_terms`; JAX
    reads ``edge_secondary`` only with ``edge_grad``, and so does this).
    The value is bit for bit the image without them; ``edge_beta`` and
    ``edge_beta2`` scale their bandwidths in pixel footprints (the JAX
    package's calibrated defaults).  The closest-approach marches are plain
    torch whatever ``march`` is, as they are XLA in the JAX package, and
    read the real AABB guards whatever ``normals`` is.
    """
    if march not in MARCHES:
        raise ValueError(f"march must be one of {MARCHES}, not {march!r}")
    if normals not in NORMALS:
        raise ValueError(f"normals must be one of {NORMALS}, not {normals!r}")
    if not implicit:
        return render_pixels(spec, params, xs, ys, frame, bounces, fov, aspect,
                             width=width, height=height, debug=0,
                             geometry=geometry)
    if geometry == "baked":
        map_fn, bounds = make_map_baked(spec), make_bounds_baked(spec)
        gv = bake(spec, params)
    elif geometry == "faithful":
        map_fn, bounds = make_map(spec), make_bounds(spec)
        gv = params
    else:
        raise ValueError("geometry must be 'faithful' or 'baked'")
    if normals == "kernel" and march != "kernel":
        raise ValueError('normals="kernel" requires march="kernel"')
    mats = params[torch.as_tensor(material_slot_matrix(spec),
                                  dtype=torch.int64, device=params.device)]
    rng, ro, rd = camera_rays(xs, ys, frame, fov, aspect, width=width,
                              height=height)
    gv_fixed = gv.detach()

    def bounds_fn(o, d):
        # The guards of the torch map taps; K3 computes its own, so with its
        # normal no tap runs outside the kernel in the forward.
        return () if normals == "kernel" else bounds(o, d, gv_fixed)[0]

    def map_gv(p, checks):
        return map_fn(p, gv, checks)

    normal_fn = None
    if march == "kernel":
        cast_fn = make_kernel_cast(spec, params, gv, geometry=geometry,
                                   with_normal=normals == "kernel")
    else:
        cast_fn = make_implicit_cast(map_fn, gv)
    if normals == "central":
        def normal_fn(p, _idx, checks):
            return calc_normal(map_gv, p, checks)
    elif normals == "autodiff":
        def normal_fn(p, _idx, checks):
            return calc_normal_autodiff(map_gv, p, checks)
    elif normals == "detached":
        # The normal as a constant of the backward: values bit-identical to
        # "central", the second-order shading-normal term dropped.
        @torch.no_grad()
        def normal_fn(p, _idx, checks):
            return calc_normal(lambda q, c: map_fn(q, gv_fixed, c),
                               Vec3(*(c.detach() for c in p)), checks)

    def gather_mat(idx):
        return gather_material(mats, idx)

    collect = edge_grad and edge_secondary
    col, _, *segs = path_trace(bounds_fn, cast_fn, normal_fn, gather_mat, ro,
                               rd, rng, bounces, remat=remat,
                               collect_segments=collect)
    if edge_grad:
        corr = _edge_terms(map_fn, bounds, gv, gather_mat, ro, rd, col,
                           segs[0] if segs else None, xs, bounces=bounces,
                           height=height, fov=fov, edge_beta=edge_beta,
                           edge_secondary=collect, edge_beta2=edge_beta2)
        col = col + corr
    return Vec3(*(c.reshape(xs.shape) for c in col))


def render_image_diff(
    spec: SceneSpec,
    params: torch.Tensor,
    *,
    width: int,
    height: int,
    bounces: int = 2,
    spp: int = 1,
    fov: float = DEFAULT_FOV,
    aspect: float = None,
    implicit: bool = True,
    geometry: str = "faithful",
    edge_grad: bool = False,
    edge_beta: float = 0.5,
    edge_secondary: bool = False,
    edge_beta2: float = 2.0,
    march: str = "plain",
    normals: str = "central",
    remat: bool = False,
) -> torch.Tensor:
    """Differentiable full-frame render on ``params``' device, averaging
    ``spp`` RNG streams (frames 0..spp-1) per pixel.  Returns (H, W, 3)."""
    if aspect is None:
        aspect = width / height
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.int32, device=params.device),
        torch.arange(width, dtype=torch.int32, device=params.device),
        indexing="ij")
    acc = None
    for f in range(spp):
        img = render_pixels_diff(
            spec, params, xs, ys, f, bounces, fov, aspect, width=width,
            height=height, implicit=implicit, geometry=geometry,
            edge_grad=edge_grad, edge_beta=edge_beta,
            edge_secondary=edge_secondary, edge_beta2=edge_beta2, march=march,
            normals=normals, remat=remat).stack()
        acc = img if acc is None else acc + img
    return acc / float(spp)


def make_loss(
    spec: SceneSpec,
    target,
    *,
    width: int,
    height: int,
    bounces: int = 2,
    spp: int = 1,
    fov: float = DEFAULT_FOV,
    implicit: bool = True,
    geometry: str = "faithful",
    edge_grad: bool = False,
    edge_beta: float = 0.5,
    edge_secondary: bool = False,
    edge_beta2: float = 2.0,
    march: str = "plain",
    normals: str = "central",
    remat: bool = False,
):
    """``loss(params)``: the MSE of the differentiable render against
    ``target`` (an (H, W, 3) array or tensor, moved to the params' device);
    call ``.backward()`` on it or pass it to ``torch.autograd.grad``."""
    target = torch.as_tensor(np.array(target, np.float32) if isinstance(
        target, np.ndarray) else target, dtype=torch.float32)

    def loss(params: torch.Tensor) -> torch.Tensor:
        img = render_image_diff(
            spec, params, width=width, height=height, bounces=bounces,
            spp=spp, fov=fov, implicit=implicit, geometry=geometry,
            edge_grad=edge_grad, edge_beta=edge_beta,
            edge_secondary=edge_secondary, edge_beta2=edge_beta2, march=march,
            normals=normals, remat=remat)
        nonlocal target
        target = target.to(img.device)
        return torch.mean((img - target) ** 2)

    return loss
