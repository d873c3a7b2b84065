"""The torch oracle renderer: sphere march, normals, shading, bounce loop,
debug modes (JAX package: ``render/reference.py``).

``shade_bounce`` and ``path_trace`` are the reference kernel's hit shading,
Monte-Carlo bounce loop and Russian roulette (test_compute.glsl:91-166) with
the refraction extension; ``cast_ray`` is its 80-step sphere march and
``calc_normal`` the 6-tap central difference.  They work on flat (n,)
tensors of rays and evaluate, at each step and bounce, only the rays still
running: a lane's result is the JAX version's, whose fixed-trip loops mask
finished lanes instead.

The scene comes in as functions, so the same loop serves the oracle
(``render_pixels`` / ``render_frame`` over the per-spec map closures of
render/scenegen.py and render/baked.py), the plain full-analytic frame
(render/soa.py) and the plain marching frame (render/program.py).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..constants import BIG, DEFAULT_BOUNCES, DEFAULT_FOV, FP, MHD, OFFSET, STEPS
from ..ops.camera import calc_uv, primary_ray
from ..ops.rng import gen_rng, random_float01, random_unit_vector
from ..scene.compile import SceneSpec
from ..vecmath import Vec3, div_exact, reflect, sqrt_rn, vmix, vwhere
from .baked import bake, make_bounds_baked, make_map_baked
from .scenegen import make_bounds, make_map, material_slot_matrix
from ..precision import quantize


class Mat(NamedTuple):
    """SoA material planes, one entry per field of the reference's ``Mat``
    struct (test_compute.glsl:45-59)."""

    col: Vec3
    brightness: Any
    light: Vec3
    spec: Any
    spec_col: Vec3
    roughness: Any
    ior: Any
    refract_chance: Any
    refract_roughness: Any
    refract_col: Vec3


def gather_material(mat_table, idx) -> Mat:
    """Per-ray materials by winning-shape id from an (n, 18) table;
    ``idx < 0`` yields the all-zero MDEF material (test_compute.glsl:63)."""
    if mat_table.shape[0] == 0:
        mat_table = mat_table.new_zeros((1, mat_table.shape[1]))
    valid = idx >= 0
    # index_select, not indexing: the indexing backward sums each row's
    # millions of duplicate ids serially (32 ms per 1080p bounce on an H100,
    # profile_main.py --mode train); index_select's is an index_add, whose
    # atomics on CUDA sum in no fixed order (the last bits vary by run).
    rows = mat_table.index_select(0, torch.clamp(idx, min=0).to(torch.int64))

    def chan(c):
        return torch.where(valid, rows[..., c], torch.zeros_like(rows[..., c]))

    def chan3(c):
        return Vec3(chan(c), chan(c + 1), chan(c + 2))

    return Mat(
        col=chan3(0),
        brightness=chan(3),
        light=chan3(4),
        spec=chan(7),
        spec_col=chan3(8),
        roughness=chan(11),
        ior=chan(12),
        refract_chance=chan(13),
        refract_roughness=chan(14),
        refract_col=chan3(15),
    )


def refract_dir(i: Vec3, n: Vec3, eta):
    """GLSL ``refract(I, N, eta)``: Snell refraction, zero vector on total
    internal reflection (the sqrt guard is strict, as in the JAX version)."""
    cosi = n.dot(i)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    pos = k > 0.0
    zero = torch.zeros_like(k)
    root = torch.where(pos, sqrt_rn(torch.where(pos, k, torch.ones_like(k))),
                       zero)
    ok = k >= 0.0
    out = i * eta - n * (eta * cosi + root)
    return vwhere(ok, out, Vec3.splat(zero)), ok


def shade_bounce(rng, rd: Vec3, hit_pos: Vec3, n: Vec3, mat: Mat):
    """One hit's scatter + emission (test_compute.glsl:118-149) with the
    refraction extension: one RNG draw three-way-splits specular / refract /
    diffuse; the refractive index is ``1 + ior``.

    Returns ``(rng, new_ro, new_rd, emit, thr_factor, ray_prob)``.
    """
    rng, r_branch = random_float01(rng)
    spec_c = mat.spec
    refr_c = mat.refract_chance
    do_spec = r_branch < spec_c
    do_refr = (~do_spec) & (r_branch < spec_c + refr_c)
    ray_prob = torch.where(
        do_spec, spec_c, torch.where(do_refr, refr_c, 1.0 - spec_c - refr_c))
    ray_prob = torch.clamp(ray_prob, min=1e-4)

    rng, ruv = random_unit_vector(rng)
    diffuse_dir = (n + ruv).normalize_safe()
    spec_dir = vmix(
        reflect(rd, n), diffuse_dir, mat.roughness * mat.roughness
    ).normalize_safe()

    # Refraction: flip the normal when exiting, eta = n1/n2.
    entering = rd.dot(n) < 0.0
    n_eff = vwhere(entering, n, -n)
    idx_ref = 1.0 + mat.ior
    eta = torch.where(entering, 1.0 / idx_ref, idx_ref)
    refr, ok = refract_dir(rd, n_eff, eta)
    refr = vwhere(ok, refr, reflect(rd, n_eff))
    trans_diffuse = (-n_eff + ruv).normalize_safe()
    refr = vmix(
        refr, trans_diffuse, mat.refract_roughness * mat.refract_roughness
    ).normalize_safe()

    new_rd = vwhere(do_spec, spec_dir, vwhere(do_refr, refr, diffuse_dir))
    # Respawn along +n, except refracted rays, which continue through.
    offset_n = vwhere(do_refr, -n_eff, n)
    new_ro = hit_pos + offset_n * OFFSET

    emit = mat.light.normalize_safe() * mat.brightness
    thr_factor = vwhere(
        do_spec, mat.spec_col, vwhere(do_refr, mat.refract_col, mat.col)
    )
    return rng, new_ro, new_rd, emit, thr_factor, ray_prob




def take_lanes(checks, sel):
    """The lanes ``sel`` of a bounce's guard state: a tuple of per-lane
    tensors (or None for an unguarded shape), indexed along dim 0."""
    return tuple(None if c is None else c[sel] for c in checks)


def cast_ray(map_fn, ro: Vec3, rd: Vec3, checks, closest: bool = False,
             t_cap=None):
    """The 80-step sphere march of (n,) rays (test_compute.glsl:74-89, JAX
    package ``render/reference.py:cast_ray``): ``t += |d|``, a hit at ``|d|
    < MHD``, far once ``t > FP``.  Returns ``(t, idx)``, ``idx`` the id of
    the last map tap (-1 when far).  ``map_fn(p, checks) -> (d, idx)``.
    ``closest=True`` also returns the closest approach ``(d_min, t_min)``:
    the smallest signed map value over the ray's taps and the t it was
    taken at (JAX ``with_closest``; BIG and 0 before any tap).  ``t_cap``
    ((n,), the closed-form cap of ``analytic_unboxed``) stops a ray on it:
    ``t = min(t, t_cap)``, done once ``t >= t_cap``.

    Each step evaluates only the rays still marching, so a lane's result is
    that of the JAX version's masked fixed-trip loop.  ``t`` is updated out
    of place, so autograd can differentiate the march (``implicit=False``
    in diff/vjp.py)."""
    t = torch.zeros_like(ro.x)
    idx = torch.full_like(ro.x, -1, dtype=torch.int32)
    if closest:
        d_min = torch.full_like(t, BIG)
        t_min = torch.zeros_like(t)
    live = torch.arange(t.shape[0], device=t.device)
    lt = t
    for _ in range(STEPS):
        if live.numel() == 0:
            break
        d, mi = map_fn(ro + rd * lt, checks)
        d = quantize(d)
        if closest:
            better = d < d_min[live]
            d_min[live] = torch.where(better, d, d_min[live])
            t_min[live] = torch.where(better, lt, t_min[live])
        ad = torch.abs(d)
        nt = quantize(lt + ad)
        if t_cap is not None:
            nt = torch.minimum(nt, t_cap)
        far = nt > FP
        t = t.index_put((live,), nt)
        idx[live] = torch.where(far, torch.full_like(mi, -1), mi)
        done = (ad < MHD) | far
        if t_cap is not None:
            done = done | (nt >= t_cap)
            t_cap = t_cap[~done]
        keep = ~done
        live, ro, rd, lt = live[keep], _sel(ro, keep), _sel(rd, keep), nt[keep]
        checks = take_lanes(checks, keep)
    return (t, idx, d_min, t_min) if closest else (t, idx)


def _sel(v: Vec3, mask) -> Vec3:
    return Vec3(v.x[mask], v.y[mask], v.z[mask])


_NORMAL_EPS = 1e-4
_TAPS = ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1))


def calc_grad(map_fn, p: Vec3, checks) -> Vec3:
    """The 6-tap central differences of the map (eps 1e-4, funcs.glsl:21-35)
    before normalisation, evaluated as one map call over the 6 offset copies
    of the points."""
    e = _NORMAL_EPS
    pts = Vec3(*(torch.cat([c + e * tap[k] for tap in _TAPS])
                 for k, c in enumerate(p)))
    d, _ = map_fn(pts, tuple(None if c is None else c.repeat(6, *[1] * (c.dim() - 1))
                             for c in checks))
    d = d.view(6, -1)
    return Vec3(d[0] - d[1], d[2] - d[3], d[4] - d[5])


def calc_normal(map_fn, p: Vec3, checks) -> Vec3:
    """Central-difference SDF gradient, normalised (funcs.glsl:21-35)."""
    return calc_grad(map_fn, p, checks).normalize_safe()


def calc_normal_autodiff(map_fn, p: Vec3, checks) -> Vec3:
    """The exact SDF gradient by reverse-mode autodiff of one map tap (JAX
    package: ``calc_normal_autodiff``): exact for every fold the map
    performs, where the 6-tap central difference is an eps=1e-4 estimate.
    Under an enabled autograd the result stays differentiable (the second
    order term flows through ``p`` and the map's parameters); otherwise it
    is a plain value."""
    outer = torch.is_grad_enabled()
    with torch.enable_grad():
        pts = [c if outer and c.requires_grad else c.detach().requires_grad_()
               for c in p]
        d, _ = map_fn(Vec3(*pts), checks)
        g = torch.autograd.grad(d, pts, torch.ones_like(d), create_graph=outer,
                                allow_unused=True)
    return Vec3(*(torch.zeros_like(c) if gc is None else gc
                  for c, gc in zip(p, g))).normalize_safe()


def roulette(rng, new_thr: Vec3):
    """Russian roulette on the max throughput channel
    (test_compute.glsl:153-159): returns ``(rng, survives, new_thr / p)``,
    ``p`` the largest channel (the throughput is zero where ``p`` is not
    positive)."""
    p_rr = new_thr.max_component()
    rng, r_rr = random_float01(rng)
    p_pos = p_rr > 0.0
    inv_p = torch.where(p_pos, 1.0 / torch.where(p_pos, p_rr,
                                                 torch.ones_like(p_rr)),
                        torch.zeros_like(p_rr))
    return rng, ~(r_rr > p_rr), new_thr * inv_p


class Segments(NamedTuple):
    """Per-bounce ray-segment state of :func:`path_trace` over all ``n``
    rays, stacked on a leading ``bounces + 1`` axis: ``ro``, ``rd``, ``thr``
    (Vec3 of (bounces + 1, n)), ``ret_before`` (the radiance gathered before
    the bounce) and ``alive`` (int32, 1 where the path enters the bounce)
    are the state entering bounce b; ``t`` (detached) and ``idx`` are bounce
    b's cast.  Lanes with ``alive == 0`` hold zeros (``idx`` -1) and are
    not read."""

    ro: Vec3
    rd: Vec3
    thr: Vec3
    ret_before: Vec3
    alive: Any
    t: Any
    idx: Any


def path_trace(bounds_fn, cast_fn, normal_fn, gather_mat, ro: Vec3, rd: Vec3,
               rng, bounces: int, remat: bool = False, on_bounce=None,
               collect_segments: bool = False):
    """Monte-Carlo bounce loop (test_compute.glsl:91-166) over (n,) rays.

    Per bounce ``bounds_fn(ro, rd) -> checks`` is computed once and handed to
    both ``cast_fn(ro, rd, checks) -> (t, idx)`` (a miss has t > FP) and
    ``normal_fn(p, idx, checks) -> Vec3``; ``gather_mat(idx) -> Mat``.  A
    cast that computes the normal itself returns ``(t, idx, n)``, and
    ``normal_fn`` is not called.  Returns ``(radiance Vec3, i_exit int32)``,
    ``i_exit`` the GLSL loop variable at exit (the bounce heatmap,
    test_compute.glsl:163).

    Each bounce runs on the paths still alive only, which is what the JAX
    version's alive masks give for every lane.  Every update of the state
    is out of place, so autograd differentiates the loop; ``remat=True``
    checkpoints each bounce (``torch.utils.checkpoint``, JAX's
    ``jax.checkpoint`` of the bounce body): its forward is recomputed in the
    backward instead of taped, exactly, since the hash RNG is
    deterministic.  ``on_bounce(lanes)``, when given, receives at each
    bounce the indices of the rays the bounce casts among the ``n`` it
    started with (debug 4's statistics map the rays back to their pixels
    with them).

    ``collect_segments=True`` also returns the per-bounce state the
    secondary edge estimator reads (diff/vjp.py), as :class:`Segments`:
    each bounce's live lanes are scattered out of place into full-``n``
    planes, so a secondary segment's ``ro`` and ``rd`` stay differentiable
    back to the previous bounce's hit point and its cast.  JAX ignores
    ``remat`` when it collects; here ``remat`` still checkpoints each
    bounce, and values and gradients are the same either way."""
    n = ro.x.shape[0]
    zero = torch.zeros_like(ro.x)
    ret = Vec3(zero, zero, zero)
    i_exit = torch.full_like(ro.x, bounces + 1, dtype=torch.int32)
    lanes = torch.arange(n, device=ro.x.device)
    thr = Vec3.splat(torch.ones_like(ro.x))
    segs = []

    def bounce(lanes, ro, rd, thr, rng):
        """One bounce of the live paths: returns the lanes that missed, the
        lanes that hit with their emission times throughput, the lanes the
        roulette killed, the survivors' state, and the cast of every lane
        of the bounce."""
        checks = bounds_fn(ro, rd)
        t, idx, *cast_n = cast_fn(ro, rd, checks)
        cast = (t.detach(), idx)
        hit = ~(t > FP)
        missed = lanes[~hit]
        lanes, ro, rd, thr, rng = (lanes[hit], _sel(ro, hit), _sel(rd, hit),
                                   _sel(thr, hit), rng[hit])
        t, idx, checks = t[hit], idx[hit], take_lanes(checks, hit)

        hit_pos = Vec3(*map(quantize, ro + rd * t))
        n_ = _sel(cast_n[0], hit) if cast_n else normal_fn(hit_pos, idx, checks)
        mat = gather_mat(idx)
        rng, ro, rd, emit, thr_factor, ray_prob = shade_bounce(
            rng, rd, hit_pos, n_, mat)
        gain = Vec3(*map(quantize, emit * thr))
        rng, surv, new_thr = roulette(rng, thr * thr_factor / ray_prob)
        return (missed, lanes, gain, lanes[~surv], lanes[surv], _sel(ro, surv),
                _sel(rd, surv), rng[surv], _sel(new_thr, surv), *cast)

    def full(v, fill=0):
        """A per-lane tensor of the live lanes as a full-n plane."""
        return torch.full((n,), fill, dtype=v.dtype,
                          device=v.device).index_put((lanes,), v)

    for i in range(bounces + 1):
        if lanes.numel() == 0:
            if not collect_segments:
                break
            segs.append((Vec3(zero, zero, zero),) * 3 + (
                ret, torch.zeros_like(i_exit), zero,
                torch.full_like(i_exit, -1)))
            continue
        if on_bounce is not None:
            on_bounce(lanes)
        state = (lanes, ro, rd, thr, rng)
        out = (checkpoint(bounce, *state, use_reentrant=False) if remat
               else bounce(*state))
        if collect_segments:
            segs.append((Vec3(*map(full, ro)), Vec3(*map(full, rd)),
                         Vec3(*map(full, thr)), ret,
                         full(torch.ones_like(lanes, dtype=torch.int32)),
                         full(out[9]), full(out[10], -1)))
        missed, hit_lanes, gain, dead, lanes, ro, rd, rng, thr = out[:9]
        i_exit[missed] = i
        ret = Vec3(*(acc.index_add(0, hit_lanes, g) for acc, g in zip(ret, gain)))
        i_exit[dead] = i
    if not collect_segments:
        return ret, i_exit

    def stack(k):
        return torch.stack([s[k] for s in segs])

    def stack3(k):
        return Vec3(*(torch.stack([s[k][c] for s in segs]) for c in range(3)))

    return ret, i_exit, Segments(stack3(0), stack3(1), stack3(2), stack3(3),
                                 stack(4), stack(5), stack(6))


def normals_debug(bounds_fn, cast_fn, normal_fn, ro, rd) -> Vec3:
    """Debug mode 1: surface normals + AABB-hit tint
    (test_compute.glsl:170-179).  ``bounds_fn`` returns ``(checks, dbg)``."""
    checks, dbg = bounds_fn(ro, rd)
    t, idx = cast_fn(ro, rd, checks)[:2]
    n = normal_fn(ro + rd * t, idx, checks)
    shaded = (n.normalize_safe() * 0.5 + 0.5) * 0.2 + Vec3.splat(dbg)
    return vwhere(t > FP, Vec3.splat(dbg), shaded)


def colors_debug(bounds_fn, cast_fn, gather_mat, ro, rd) -> Vec3:
    """Debug mode 2: first-hit albedo (test_compute.glsl:183-195)."""
    checks, _dbg = bounds_fn(ro, rd)
    _t, idx = cast_fn(ro, rd, checks)[:2]
    return gather_mat(idx).col


def camera_rays(xs, ys, frame, fov: float, aspect: float, *, width: int,
                height: int):
    """The per-pixel RNG state and the jittered primary rays of the pixels
    ``(xs, ys)``, flattened to (n,) (test_compute.glsl:218-235)."""
    xs, ys = xs.reshape(-1), ys.reshape(-1)
    # Per-pixel RNG + subpixel AA jitter (test_compute.glsl:224-229).
    rng = gen_rng(xs, ys, frame, width, height)
    rng, jx = random_float01(rng)
    rng, jy = random_float01(rng)
    u, v = calc_uv(xs.to(torch.float32) + (jx - 0.5),
                   ys.to(torch.float32) + (jy - 0.5), width, height, aspect)
    ro, rd = primary_ray(u, v, fov)
    return rng, ro, rd


def trace_pixels(bounds_fn, cast_fn, normal_fn, gather_mat, xs, ys, frame,
                 bounces: int, fov: float, aspect: float, *, width: int,
                 height: int, debug: int, on_bounce=None) -> Vec3:
    """One sample of the pixels ``(xs, ys)`` (int32, any shape; ``width`` /
    ``height`` are the full image's, seeding the RNG and the NDC mapping)
    through the given scene functions, in debug mode 0-3.
    ``bounds_fn(ro, rd) -> (checks, dbg)``; ``on_bounce`` goes to
    :func:`path_trace` (debug 0 and 3), whose lanes are the pixels' flat
    indices."""
    shape = xs.shape
    rng, ro, rd = camera_rays(xs, ys, frame, fov, aspect, width=width,
                              height=height)
    if debug in (0, 3):
        col, i_exit = path_trace(lambda o, d: bounds_fn(o, d)[0], cast_fn,
                                 normal_fn, gather_mat, ro, rd, rng, bounces,
                                 on_bounce=on_bounce)
        if debug == 3:
            col = Vec3.splat(div_exact(i_exit.to(torch.float32),
                                       float(bounces)))
    elif debug == 1:
        col = normals_debug(bounds_fn, cast_fn, normal_fn, ro, rd)
    elif debug == 2:
        col = colors_debug(bounds_fn, cast_fn, gather_mat, ro, rd)
    else:
        raise ValueError(f"debug must be 0..3, not {debug}")
    return Vec3(*(c.reshape(shape) for c in col))


def render_pixels(spec: SceneSpec, params, xs, ys, frame, bounces: int,
                  fov: float, aspect: float, *, width: int, height: int,
                  debug: int, geometry: str = "faithful",
                  normals: str = "central") -> Vec3:
    """The oracle renderer over a block of pixels (JAX package:
    ``render_pixels``): the per-spec map closures of render/scenegen.py
    (``geometry="faithful"``) or over the baked coefficients
    (``"baked"``), the exact march and the 6-tap normal, or with
    ``normals="autodiff"`` the exact gradient of the same map at the hit
    (``calc_normal_autodiff``, under an enabled autograd also where the
    caller runs without one)."""
    if normals not in ("central", "autodiff"):
        raise ValueError("normals must be 'central' or 'autodiff'")
    if geometry == "baked":
        bv = bake(spec, params)
        bmap, bbounds = make_map_baked(spec), make_bounds_baked(spec)

        def map_fn(p, checks):
            return bmap(p, bv, checks)

        def bounds_fn(ro, rd):
            return bbounds(ro, rd, bv)
    elif geometry == "faithful":
        smap, sbounds = make_map(spec), make_bounds(spec)

        def map_fn(p, checks):
            return smap(p, params, checks)

        def bounds_fn(ro, rd):
            return sbounds(ro, rd, params)
    else:
        raise ValueError("geometry must be 'faithful' or 'baked'")
    mats = params[torch.as_tensor(material_slot_matrix(spec),
                                  dtype=torch.int64, device=params.device)]
    normal = calc_normal_autodiff if normals == "autodiff" else calc_normal
    return trace_pixels(
        bounds_fn,
        lambda ro, rd, c: cast_ray(map_fn, ro, rd, c),
        lambda p, _idx, c: normal(map_fn, p, c),
        lambda idx: gather_material(mats, idx),
        xs, ys, frame, bounces, fov, aspect, width=width, height=height,
        debug=debug)


def running_mean(accum, img, last_clear: int):
    """accum*(1-w) + img*w with w = 1/(last_clear+1) in float32
    (test_compute.glsl:242-245)."""
    w = np.float32(1.0) / np.float32(last_clear + 1)
    return accum * float(np.float32(1.0) - w) + img * float(w)


def render_frame(spec: SceneSpec, params, accum=None, frame: int = 0,
                 last_clear: int = 0, *, width: int = 256, height: int = 256,
                 debug: int = 0, bounces: int = DEFAULT_BOUNCES,
                 fov: float = DEFAULT_FOV, aspect: float = None,
                 geometry: str = "faithful",
                 normals: str = "central") -> torch.Tensor:
    """One oracle frame on ``params``' device (JAX package:
    ``render_frame``); returns the (H, W, 3) image, or the running mean
    with ``accum`` in debug 0.  ``debug``: 0 path trace, 1 normals + AABB,
    2 albedo, 3 bounce heatmap (path_tracer.rs:159); ``normals``:
    "central" (the 6-tap difference) or "autodiff" (:func:`render_pixels`)."""
    if aspect is None:
        aspect = width / height
    device = params.device
    ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.int32, device=device),
                            torch.arange(width, dtype=torch.int32, device=device),
                            indexing="ij")
    with torch.no_grad():
        img = render_pixels(spec, params, xs, ys, frame, bounces, fov, aspect,
                            width=width, height=height, debug=debug,
                            geometry=geometry, normals=normals).stack()
    if debug != 0:
        return img  # debug modes bypass accumulation (test_compute.glsl:240)
    if accum is None:
        accum = torch.zeros_like(img)
    return running_mean(accum, img, last_clear)


def render_accumulated(spec: SceneSpec, params, n_frames: int, *,
                       width: int = 256, height: int = 256,
                       bounces: int = DEFAULT_BOUNCES,
                       fov: float = DEFAULT_FOV,
                       aspect: float = None) -> torch.Tensor:
    """``n_frames`` progressive oracle frames into one accumulator (JAX
    package: ``render_accumulated``).  Frame f uses RNG stream f and
    running-mean weight 1/(f+1); f = 0 overwrites the zero accumulator (the
    reference mixes its first frame against stale texture memory at weight
    1/2, path_tracer.rs:101-115)."""
    if aspect is None:
        aspect = width / height
    accum = None
    for f in range(int(n_frames)):
        accum = render_frame(spec, params, accum, f, f, width=width,
                             height=height, debug=0, bounces=bounces, fov=fov,
                             aspect=aspect)
    if accum is None:
        accum = torch.zeros((height, width, 3), dtype=torch.float32,
                            device=params.device)
    return accum
