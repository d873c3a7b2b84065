"""Port parity: the full-analytic frame (the K1 megakernel's mode) against
the JAX package.

On the CPU ``render_frame_megakernel`` runs its plain torch version, so
these tests hold that version, in its ``geometry="baked",
analytic_all=True`` mode, to JAX ``render_frame_soa`` (plain XLA with
analytic_all semantics) under the contract of
tests/test_analytic_all.py:166-191: at most 0.5% of pixels off by more than
1e-2, and 0.1% at bounces=0.  The CUDA kernel is held to the plain version
on the card by chip_smoke.py."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compute_path_tracer_tpu.ops.camera import calc_uv, primary_ray
from compute_path_tracer_tpu.ops.rng import gen_rng, random_float01
from compute_path_tracer_tpu.render import baked as jb
from compute_path_tracer_tpu.render import soa as js
from compute_path_tracer_tpu.render.reference import gather_material, path_trace
from compute_path_tracer_tpu.render.scenegen import material_slot_matrix
from compute_path_tracer_tpu.scene import compile_scene as j_compile
from compute_path_tracer_tpu.scene import library as j_lib
from compute_path_tracer_tpu.scene.model import KIND_SPHERE as J_SPHERE
from compute_path_tracer_tpu.scene.model import Scene as JScene
from compute_path_tracer_tpu.scene.model import Shape as JShape
from compute_path_tracer_tpu.scene.model import Union as JUnion
from compute_path_tracer_tpu.vecmath import Vec3 as JVec3
from compute_path_tracer_tpu_torch.kernels import megakernel as mk
from compute_path_tracer_tpu_torch.render import soa as ts
from compute_path_tracer_tpu_torch.scene import compile_scene as t_compile
from compute_path_tracer_tpu_torch.scene import convert_scene
from compute_path_tracer_tpu_torch.vecmath import Vec3 as TVec3

W, H, BOUNCES = 128, 64, 3
DIFF_TOL = 1e-2
ANALYTIC = dict(geometry="baked", analytic_all=True)


def _pair(scene):
    return j_compile(scene), t_compile(convert_scene(scene))


def _clobber_scene():
    root = JUnion(name="R")
    child = JUnion(name="C")
    inner = child.add_shape(JShape(J_SPHERE, name="inner"))
    inner.transform.aabb = False
    inner.size.set(0.8)
    root.add_union(child)
    first = root.add_shape(JShape(J_SPHERE, name="first"))
    first.transform.position.set(0.5, 0.0, 0.0)
    return JScene([root])


def _rays(n, seed):
    r = np.random.default_rng(seed)
    ro = r.uniform(-6, 6, (n, 3)).astype(np.float32)
    rd = r.uniform(-2, 2, (n, 3)).astype(np.float32) - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, rd


def _j3(a):
    return JVec3(*(jnp.asarray(a[:, i]) for i in range(3)))


def _t3(a):
    return TVec3(*(torch.from_numpy(np.ascontiguousarray(a[:, i]))
                   for i in range(3)))


def _casts(scene, n, seed):
    jc, tc = _pair(scene)
    bv = jb.bake(jc.spec, jnp.asarray(jc.params))
    plan = js.build_soa_plan(jc.spec)
    ro, rd = _rays(n, seed)
    t_j, i_j = map(np.asarray, js.make_cast_soa(plan)(_j3(ro), _j3(rd), bv))
    # Both casts read the same baked vector: bake has its own tests.
    layout = ts.build_soa_smem_layout(tc.spec)
    f, i = ts.pack_soa_smem(layout, torch.from_numpy(np.array(bv)),
                            torch.from_numpy(tc.params))
    t_t, i_t = ts.make_cast_soa(layout)(_t3(ro), _t3(rd), f, i)
    return (jc, plan, bv, layout, f, i, ro, rd, t_j, i_j, t_t.numpy(),
            i_t.numpy())


@pytest.mark.parametrize("n_prims", [8, 16, 64])
def test_cast_and_normal_match_jax(n_prims):
    (_jc, plan, bv, layout, f, i, ro, rd, t_j, i_j, t_t, i_t) = _casts(
        j_lib.benchmark_scene(n_prims), 1024, 3)
    hit = t_j < 100.0
    assert hit.any() and (~hit).any()
    np.testing.assert_allclose(t_t[hit], t_j[hit], rtol=1e-5, atol=1e-5)
    assert (i_t == i_j).mean() >= 0.999  # fp-tie lanes only
    assert (t_t[~hit] > 100.0).all()
    # Normals at the JAX hit points; JAX's make_normal_soa returns shape 0's
    # normal on misses where the port returns zero, so hits only.
    p = ro + rd * t_j[:, None]
    n_j = js.make_normal_soa(plan)(_j3(p), jnp.asarray(i_j), bv)
    n_t = ts.make_normal_soa(layout)(_t3(p), torch.from_numpy(i_j.copy()), f,
                                     i)
    for a, b in zip(n_j, n_t):
        np.testing.assert_allclose(b.numpy()[hit], np.asarray(a)[hit],
                                   rtol=0, atol=1e-5)


def test_cast_clobber_scene_matches_jax():
    (_jc, _plan, _bv, layout, f, _i, ro, rd, t_j, i_j, t_t, i_t) = _casts(
        _clobber_scene(), 2048, 11)
    hit = t_j < 100.0
    assert hit.any() and (~hit).any()
    assert (i_t == i_j).all()
    # Every leaf is a sphere.  On near-grazing rays b*b - c cancels, and
    # XLA's fused multiply-adds round it otherwise than the port's separate
    # float32 operations (which the CUDA kernel keeps with -fmad=false), so
    # t is compared where the discriminant is not small next to b*b.
    (kd,) = layout.kinds
    g = f.numpy()[kd.f_geom:kd.f_geom + kd.n * kd.w].reshape(kd.n, kd.w)
    g = g.astype(np.float64)[np.maximum(i_j, 0)]
    oc = ro.astype(np.float64) - g[:, :3]
    b = (oc * rd).sum(axis=1)
    disc = b * b - ((oc * oc).sum(axis=1) - g[:, 3] ** 2)
    clean = hit & (disc > 1e-2 * b * b)
    assert clean.mean() > 0.5 * hit.mean()
    np.testing.assert_allclose(t_t[clean], t_j[clean], rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def bench16():
    return _pair(j_lib.benchmark_scene(16))


def _share_off(a, b):
    assert np.isfinite(a).all() and np.isfinite(b).all()
    return float((np.abs(a - b).max(axis=-1) > DIFF_TOL).mean())


def _port_frame(tc, **kw):
    before = dict(mk.LAUNCHES)
    out = mk.render_frame_megakernel(tc.spec, torch.from_numpy(tc.params),
                                     width=W, height=H, **ANALYTIC, **kw)
    assert mk.LAUNCHES == before  # CPU tensors never reach the kernels
    assert out.dtype == torch.float32 and out.shape == (H, W, 3)
    return out.numpy()


@pytest.mark.parametrize("frame", [0, 5])
def test_frame_matches_jax_soa(bench16, frame):
    jc, tc = bench16
    a = np.asarray(js.render_frame_soa(jc.spec, jc.params, width=W, height=H,
                                       bounces=BOUNCES, fov=1.0, frame=frame))
    b = _port_frame(tc, frame=frame, bounces=BOUNCES)
    assert _share_off(a, b) <= 5e-3


@pytest.mark.parametrize("name", ["glass_demo", "sphere_and_plane",
                                  "clobber"])
def test_other_scenes_match_jax_soa(name):
    """Refraction (glass_demo), unguarded leaves and the clobber's ancestor
    guards, which the benchmark scene does not exercise."""
    scene = _clobber_scene() if name == "clobber" else getattr(j_lib, name)()
    jc, tc = _pair(scene)
    a = np.asarray(js.render_frame_soa(jc.spec, jc.params, width=W, height=H,
                                       bounces=BOUNCES, fov=1.0))
    assert _share_off(a, _port_frame(tc, bounces=BOUNCES)) <= 5e-3


def test_frame_bounces0_matches_jax_soa(bench16):
    jc, tc = bench16
    a = np.asarray(js.render_frame_soa(jc.spec, jc.params, width=W, height=H,
                                       bounces=0, fov=1.0))
    assert _share_off(a, _port_frame(tc, bounces=0)) <= 1e-3


@partial(jax.jit, static_argnames=("spec", "bounces"))
def _jax_bounce_heatmap(spec, params, bounces):
    """render_pixels_soa's bounce loop, keeping i_exit (debug 3)."""
    plan = js.build_soa_plan(spec)
    bv = jb.bake(spec, params)
    cast = js.make_cast_soa(plan)
    normal = js.make_normal_soa(plan)
    mats = params[jnp.asarray(material_slot_matrix(spec))]
    ys, xs = jnp.meshgrid(jnp.arange(H, dtype=jnp.int32),
                          jnp.arange(W, dtype=jnp.int32), indexing="ij")
    rng = gen_rng(xs, ys, 0, W, H)
    rng, jx = random_float01(rng)
    rng, jy = random_float01(rng)
    u, v = calc_uv(xs.astype(jnp.float32) + (jx - 0.5),
                   ys.astype(jnp.float32) + (jy - 0.5), W, H,
                   jnp.float32(W / H))
    ro, rd = primary_ray(u, v, jnp.float32(1.0))
    _, i_exit = path_trace(
        None, lambda ro_, rd_, _pv: (None, None),
        lambda idx: gather_material(mats, idx), ro, rd, params, rng, bounces,
        cast_fn=lambda _m, ro_, rd_, _pv, _c: cast(ro_, rd_, bv),
        normal_fn=lambda _m, p, _pv, _c, idx: normal(p, idx, bv))
    img = i_exit.astype(jnp.float32) / bounces
    return jnp.stack([img, img, img], axis=-1)


def test_frame_debug3_matches_jax(bench16):
    jc, tc = bench16
    a = np.asarray(_jax_bounce_heatmap(jc.spec, jnp.asarray(jc.params),
                                       BOUNCES))
    assert _share_off(a, _port_frame(tc, bounces=BOUNCES, debug=3)) <= 5e-3


def test_empty_scene_renders_black():
    _, tc = _pair(JScene())
    assert tc.spec.n_shapes == 0
    out = mk.render_frame_megakernel(tc.spec, torch.from_numpy(tc.params),
                                     width=16, height=8, bounces=2, **ANALYTIC)
    assert out.shape == (8, 16, 3) and not out.any()


def test_rejects_non_union_tree():
    _, tc = _pair(j_lib.csg_demo())
    with pytest.raises(ValueError):
        mk.render_frame_megakernel(tc.spec, torch.from_numpy(tc.params),
                                   width=16, height=8, bounces=0, **ANALYTIC)


@pytest.mark.parametrize("kw", [dict(debug=4), dict(analytic_unboxed=True),
                                dict(omega=1.5), dict(dist_grid=True)],
                         ids=str)
def test_unported_modes_raise(bench16, kw):
    _, tc = bench16
    with pytest.raises(NotImplementedError):
        mk.render_frame_megakernel(tc.spec, torch.from_numpy(tc.params),
                                   width=16, height=8, bounces=0, **kw)


@pytest.mark.slow
def test_frame_matches_pallas_interpret(bench16):
    from compute_path_tracer_tpu.kernels.megakernel import render_frame_pallas

    jc, tc = bench16
    a = np.asarray(render_frame_pallas(
        jc.spec, jc.params, width=W, height=H, bounces=BOUNCES,
        geometry="baked", analytic_all=True, interpret=True))
    assert _share_off(a, _port_frame(tc, bounces=BOUNCES)) <= 5e-3

