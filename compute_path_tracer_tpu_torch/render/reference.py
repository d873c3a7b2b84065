"""Plain torch shading and bounce loop (JAX package: ``render/reference.py``).

``shade_bounce`` and ``path_trace`` are the reference kernel's hit shading,
Monte-Carlo bounce loop and Russian roulette (test_compute.glsl:91-166) with
the refraction extension, over whole tensors of rays with per-lane alive
masks standing in for the GLSL ``break``s.  The nearest hit and the surface
normal come in through ``cast_fn`` / ``normal_fn``; the plain full-analytic
versions are in render/soa.py.  The 80-step sphere march (``cast_ray``) and
the central-difference normal arrive with the marching kernel.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..constants import FP, OFFSET
from ..ops.rng import random_float01, random_unit_vector
from ..vecmath import Vec3, reflect, sqrt_rn, vmix, vwhere


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
    rows = mat_table[torch.clamp(idx, min=0).to(torch.int64)]

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


def path_trace(cast_fn, normal_fn, gather_mat, ro: Vec3, rd: Vec3, rng,
               bounces: int):
    """Monte-Carlo bounce loop (test_compute.glsl:91-166): ``bounces + 1``
    iterations with per-lane alive masks.

    ``cast_fn(ro, rd) -> (t, idx)`` is the nearest hit (a miss has t > FP),
    ``normal_fn(p, idx) -> Vec3`` the surface normal there and
    ``gather_mat(idx) -> Mat`` the material.  Returns ``(radiance Vec3,
    i_exit int32)``: ``i_exit`` is the GLSL loop variable at exit, feeding
    the bounce-heatmap debug mode (test_compute.glsl:163).
    """
    zero = torch.zeros_like(ro.x)
    one = torch.ones_like(ro.x)
    ret = Vec3(zero, zero, zero)
    thr = Vec3(one, one, one)
    alive = torch.ones_like(ro.x, dtype=torch.bool)
    i_exit = torch.full_like(ro.x, -1, dtype=torch.int32)

    for i in range(bounces + 1):
        t, idx = cast_fn(ro, rd)
        miss = t > FP
        i_exit = torch.where(alive & miss, i, i_exit)
        act = alive & ~miss

        hit_pos = ro + rd * t
        n = normal_fn(hit_pos, idx)
        mat = gather_mat(idx)

        rng, new_ro, new_rd, emit, thr_factor, ray_prob = shade_bounce(
            rng, rd, hit_pos, n, mat)
        ro = vwhere(act, new_ro, ro)
        rd = vwhere(act, new_rd, rd)
        ret = vwhere(act, ret + emit * thr, ret)
        new_thr = thr * thr_factor / ray_prob

        # Russian roulette on the max throughput channel
        # (test_compute.glsl:153-159).
        p_rr = new_thr.max_component()
        rng, r_rr = random_float01(rng)
        rr_dead = act & (r_rr > p_rr)
        i_exit = torch.where(rr_dead, i, i_exit)
        surv = act & ~rr_dead
        p_pos = p_rr > 0.0
        inv_p = torch.where(p_pos, 1.0 / torch.where(p_pos, p_rr, one), zero)
        thr = vwhere(surv, new_thr * inv_p, vwhere(act, new_thr, thr))
        alive = surv
        # Dead lanes change nothing in later iterations.
        if not bool(alive.any()):
            break

    # Natural loop exit leaves i == bounces + 1 in the GLSL.
    i_exit = torch.where(i_exit < 0, bounces + 1, i_exit)
    return ret, i_exit
