"""Port parity: the secondary silhouette term of the autograd path
(``edge_grad=True, edge_secondary=True``, diff/vjp.py) and the per-bounce
segments it reads (``path_trace(collect_segments=True)``,
render/reference.py), against the JAX package.

* The segments of tests/test_diff.py's sphere over a plane and of
  tests/test_edge.py:159's occluder scene at 16x16 with 2 bounces, against
  JAX ``path_trace(collect_segments=True)``, both shading with the exact
  autodiff normal (the 6-tap central difference differs across the
  frameworks by up to 2.4e-3 on scattered rays, ROADMAP queue 3, which
  moves the later bounces' rays by more than the rounding): ``alive``
  equal on every lane and bounce, and on the alive lanes ``idx`` equal,
  ``rd``, ``thr`` and ``ret_before`` within 1e-5 of JAX's, ``ro`` and the
  hits' ``t`` within 5e-5, the misses' ``t`` past the far plane in both
  (the port's oracle rounds each operation, XLA contracts multiply-adds:
  ROADMAP queue 3; the march's t drifts by a few ulps, measured 4.2e-5 on
  a grazing plane hit 11.4 away, which the next segment's origin
  inherits).  The port
  holds zeros on the dead lanes, which the estimator never reads.
* The gradient of the MSE with both edge terms against JAX ``make_loss``
  on the occluder scene at 16x16, 1 bounce: within 2e-4 of the largest JAX
  entry and a cosine above 1 - 1e-6.  The bound is twice the measured
  1.26e-4 (cosine 1 - 6e-8), which the primary term alone gives: a lane's
  coverage gradient sigma'((MHD - d_min) / beta) / beta moves by about
  delta / beta relative where XLA's d_min differs by delta (up to 1.25e-5
  at a silhouette, tests/test_torch_edge_closest.py), and at fov 3 and 16
  rows beta is down to about 0.09, a third of tests/test_torch_edge_grad.py's
  scenes', whose 1e-4 holds.
  JAX's reverse-mode compile of this graph took 671 s on the default lane's
  CPU (at 8x8 already), so this one case is marked slow; the closest march
  and its Danskin backward on secondary rays with both exclusions, the stop
  distance and the blend are held to JAX in the default lane
  (tests/test_torch_edge_closest.py), and so are the segments here.

In the port alone: the image bit for bit the same with and without the
secondary term, ``remat`` exact (value and gradient) with it, and
tests/test_edge.py:199 on the occluder scene at 32x32: the occluder's
position gradient is about zero without the edge terms and the secondary
term brings it within 0.3-3x the loss's central finite difference, with
its sign.
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compute_path_tracer_tpu.diff import make_loss as j_make_loss
from compute_path_tracer_tpu.ops.camera import calc_uv as j_calc_uv
from compute_path_tracer_tpu.ops.camera import primary_ray as j_primary_ray
from compute_path_tracer_tpu.ops.rng import gen_rng as j_gen_rng
from compute_path_tracer_tpu.ops.rng import random_float01 as j_rf01
from compute_path_tracer_tpu.render import reference as j_ref
from compute_path_tracer_tpu.render.scenegen import make_bounds as j_bounds
from compute_path_tracer_tpu.render.scenegen import make_map as j_map
from compute_path_tracer_tpu.render.scenegen import (
    material_slot_matrix as j_slots,
)
from compute_path_tracer_tpu.scene import compile_scene as j_compile
from compute_path_tracer_tpu_torch.constants import FP
from compute_path_tracer_tpu_torch.diff import make_loss, render_image_diff
from compute_path_tracer_tpu_torch.render.reference import (
    calc_normal_autodiff,
    camera_rays,
    cast_ray,
    gather_material,
    path_trace,
)
from compute_path_tracer_tpu_torch.render.scenegen import (
    make_bounds,
    make_map,
    material_slot_matrix,
)
from compute_path_tracer_tpu_torch.scene import compile_scene as t_compile
from compute_path_tracer_tpu_torch.scene import convert_scene
from test_diff import _scene as sphere_plane_scene
from test_edge import _occluder_scene

S = 16
SEG_TOL = 1e-5
POS_TOL = 5e-5
OCC_GRAD_TOL = 2e-4
COS_TOL = 1e-6
OCC = dict(bounces=1, fov=3.0)


@lru_cache(maxsize=None)
def scenes(name):
    scene = _occluder_scene() if name == "occluder" else sphere_plane_scene()
    return j_compile(scene), t_compile(convert_scene(scene))


def _occ_slot(tc):
    return tc.spec.roots[0].children_shapes[2].transform.pos[1]


def jax_segments(name, bounces, fov):
    jc, _ = scenes(name)
    map_fn, bounds_fn = j_map(jc.spec), j_bounds(jc.spec)

    @jax.jit
    def run(pv):
        mats = pv[jnp.asarray(j_slots(jc.spec))]
        ys, xs = jnp.meshgrid(jnp.arange(S, dtype=jnp.int32),
                              jnp.arange(S, dtype=jnp.int32), indexing="ij")
        rng = j_gen_rng(xs, ys, 0, S, S)
        rng, jx = j_rf01(rng)
        rng, jy = j_rf01(rng)
        u, v = j_calc_uv(xs.astype(jnp.float32) + (jx - 0.5),
                         ys.astype(jnp.float32) + (jy - 0.5), S, S, 1.0)
        ro, rd = j_primary_ray(u, v, jnp.float32(fov))
        return j_ref.path_trace(
            map_fn, bounds_fn, lambda i: j_ref.gather_material(mats, i), ro,
            rd, pv, rng, bounces, normal_fn=lambda m, p, q, c, _i:
            j_ref.calc_normal_autodiff(m, p, q, c), collect_segments=True)

    return run(jnp.asarray(jc.params))


def port_segments(name, bounces, fov):
    _, tc = scenes(name)
    params = torch.from_numpy(tc.params.copy())
    map_fn, bounds = make_map(tc.spec), make_bounds(tc.spec)
    mats = params[torch.as_tensor(material_slot_matrix(tc.spec),
                                  dtype=torch.int64)]
    ys, xs = torch.meshgrid(torch.arange(S, dtype=torch.int32),
                            torch.arange(S, dtype=torch.int32), indexing="ij")
    rng, ro, rd = camera_rays(xs, ys, 0, fov, 1.0, width=S, height=S)

    def mapc(p, c):
        return map_fn(p, params, c)

    return path_trace(lambda o, d: bounds(o, d, params)[0],
                      lambda o, d, c: cast_ray(mapc, o, d, c),
                      lambda p, _i, c: calc_normal_autodiff(mapc, p, c),
                      lambda i: gather_material(mats, i), ro, rd, rng,
                      bounces, collect_segments=True)


@pytest.mark.parametrize("name,fov", [("sphere_plane", 1.0),
                                      ("occluder", 3.0)])
def test_segments_match_jax(name, fov):
    ret_j, iex_j, seg_j = jax_segments(name, 2, fov)
    ret_t, iex_t, seg_t = port_segments(name, 2, fov)
    np.testing.assert_array_equal(iex_t.numpy(), np.asarray(iex_j).ravel())
    alive_j = np.asarray(seg_j[4]).reshape(3, -1)
    alive_t = seg_t.alive.numpy()
    np.testing.assert_array_equal(alive_t, alive_j)
    live = alive_t != 0
    assert live[1].any() and not live[1].all()
    idx_j = np.asarray(seg_j[6]).reshape(3, -1)
    np.testing.assert_array_equal(seg_t.idx.numpy()[live], idx_j[live])
    assert (seg_t.idx.numpy()[~live] == -1).all()
    for k, field, tol in ((0, "ro", POS_TOL), (1, "rd", SEG_TOL),
                          (2, "thr", SEG_TOL), (3, "ret_before", SEG_TOL)):
        for c in range(3):
            got = getattr(seg_t, field)[c].detach().numpy()
            want = np.asarray(seg_j[k][c]).reshape(3, -1)
            np.testing.assert_allclose(got[live], want[live], rtol=0,
                                       atol=tol, err_msg=field)
    # t on the hits; a miss is past the far plane in both.
    t_j = np.asarray(seg_j[5]).reshape(3, -1)
    t_t = seg_t.t.numpy()
    hits = live & (t_j <= FP)
    np.testing.assert_array_equal(t_t[live] <= FP, hits[live])
    np.testing.assert_allclose(t_t[hits], t_j[hits], rtol=0, atol=POS_TOL)
    for c in range(3):
        np.testing.assert_allclose(ret_t[c].numpy(),
                                   np.asarray(ret_j[c]).ravel(), rtol=0,
                                   atol=SEG_TOL)


def _port_grad(tc, params, target, **kw):
    p = torch.from_numpy(params.copy()).requires_grad_()
    loss = make_loss(tc.spec, target, **kw)(p)
    loss.backward()
    return float(loss.detach()), p.grad.numpy()


@pytest.mark.slow
def test_secondary_gradient_matches_jax():
    jc, tc = scenes("occluder")
    target = np.zeros((S, S, 3), np.float32)
    kw = dict(width=S, height=S, edge_grad=True, edge_secondary=True, **OCC)
    g_j = np.asarray(jax.jit(jax.grad(j_make_loss(jc.spec, target, **kw)))(
        jnp.asarray(jc.params)))
    _, g_t = _port_grad(tc, tc.params, target, **kw)
    assert np.isfinite(g_t).all()
    scale = np.abs(g_j).max()
    assert scale > 0
    np.testing.assert_allclose(g_t, g_j, rtol=0, atol=OCC_GRAD_TOL * scale)
    cos = float(g_t @ g_j / (np.linalg.norm(g_t) * np.linalg.norm(g_j)))
    assert cos >= 1 - COS_TOL


def test_secondary_term_leaves_the_image_and_remat_exact():
    _, tc = scenes("occluder")
    p = torch.from_numpy(tc.params.copy())
    kw = dict(width=S, height=S, **OCC)
    with torch.no_grad():
        a = render_image_diff(tc.spec, p, **kw)
        b = render_image_diff(tc.spec, p, edge_grad=True, edge_secondary=True,
                              **kw)
    assert torch.equal(a, b)
    target = np.zeros((S, S, 3), np.float32)
    for march in ("plain", "kernel"):
        ekw = dict(kw, edge_grad=True, edge_secondary=True, march=march,
                   geometry="baked", normals="detached")
        la, ga = _port_grad(tc, tc.params, target, **ekw)
        lb, gb = _port_grad(tc, tc.params, target, remat=True, **ekw)
        assert la == lb
        np.testing.assert_array_equal(ga, gb)


def test_secondary_term_recovers_the_occluder_gradient():
    """tests/test_edge.py:199 in the port (32x32, 1 bounce, spp 1, fov 3):
    the finite difference is real, the smooth gradient is about zero, and
    the secondary term's gradient has the finite difference's sign and
    0.3-3x its size."""
    _, tc = scenes("occluder")
    slot = _occ_slot(tc)
    target = np.zeros((32, 32, 3), np.float32)
    kw = dict(width=32, height=32, spp=1, **OCC)
    p0 = torch.from_numpy(tc.params.copy())
    loss = make_loss(tc.spec, target, **kw)
    dp = torch.zeros_like(p0)
    dp[slot] = 0.1
    with torch.no_grad():
        fd = (float(loss(p0 + dp)) - float(loss(p0 - dp))) / 0.2
    _, g_smooth = _port_grad(tc, tc.params, target, **kw)
    _, g_sec = _port_grad(tc, tc.params, target, edge_grad=True,
                          edge_secondary=True, **kw)
    assert abs(fd) > 0.2, fd
    assert abs(g_smooth[slot]) < 0.05 * abs(fd), (g_smooth[slot], fd)
    ratio = g_sec[slot] / fd
    assert 0.3 < ratio < 3.0, (g_sec[slot], fd, ratio)
