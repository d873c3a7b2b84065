"""Port parity: the primary silhouette term of the autograd path
(``edge_grad=True``, diff/vjp.py) against the JAX package's
``render_image_diff`` and ``make_loss``, and its behaviour in the port.

Scenes: tests/test_edge.py's flat-lit sphere (bounces 0, the target the
sphere shifted by 0.2 along x) here, and tests/test_diff.py's sphere over a
plane (bounces 1, the target 0.9 times the image) in
tests/test_torch_edge_grad_bounce.py, at 16x16, through the
port's plain march (against JAX's XLA march, faithful geometry, central
normals) and through K3's plain version (baked, the kernel's normal,
against JAX's XLA march with detached normals, which JAX holds bit-equal to
its Pallas march).  The primary term always takes the two-valley blend
(JAX passes ``tie_scale``).  Tolerances, with their reasons:

* the image bit for bit the same with and without the edge terms (their
  correction is ``c - sg(c)`` times a detached proxy), and within 1e-6 of
  JAX's (tests/test_torch_diff.py);
* the gradient within 1e-4 of the largest JAX entry and a cosine above
  1 - 1e-6, tests/test_torch_diff.py's: autograd sums in another order than
  XLA, which also contracts the closest march's multiply-adds (its d_min is
  within 2e-5 of JAX's at the silhouette, tests/test_torch_edge_closest.py).

In the port alone: the flat sphere's smooth position gradient is zero and
its edge gradient has the sign of the loss's central finite difference and
its scale within 5x (tests/test_edge.py:87), and ``optimize_to_target(
edge_grad=True)`` recovers the position the smooth gradient cannot move
(tests/test_edge.py:126, 48x48, 60 steps).  The edge terms with
``edge_secondary`` and the collected segments are in
tests/test_torch_edge_secondary.py.
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compute_path_tracer_tpu.diff import make_loss as j_make_loss
from compute_path_tracer_tpu.diff import render_image_diff as j_render
from compute_path_tracer_tpu.scene import compile_scene as j_compile
from compute_path_tracer_tpu_torch.diff import (
    make_loss,
    optimize_to_target,
    render_image_diff,
)
from compute_path_tracer_tpu_torch.kernels import march as km
from compute_path_tracer_tpu_torch.scene import compile_scene as t_compile
from compute_path_tracer_tpu_torch.scene import convert_scene
from test_diff import _scene as sphere_plane_scene
from test_edge import _flat_scene

S = 16
IMG_TOL = 1e-6
GRAD_TOL = 1e-4
COS_TOL = 1e-6
SHIFT = 0.2


@lru_cache(maxsize=None)
def scenes(name):
    scene = _flat_scene() if name == "flat" else sphere_plane_scene()
    return j_compile(scene), t_compile(convert_scene(scene))


def _sx(tc):
    return tc.spec.roots[0].children_shapes[0].transform.pos[0]


@lru_cache(maxsize=None)
def jax_case(name, items):
    """The JAX image, the target and the gradient of its MSE to it, with
    the edge term."""
    jc, tc = scenes(name)
    kw = dict(items)
    pv = jnp.asarray(jc.params)
    img = np.asarray(j_render(jc.spec, pv, width=S, height=S, **kw))
    if name == "flat":
        p = np.asarray(jc.params, np.float32).copy()
        p[_sx(tc)] += SHIFT
        target = np.asarray(j_render(jc.spec, jnp.asarray(p), width=S,
                                     height=S, **kw))
    else:
        target = img * 0.9
    loss = j_make_loss(jc.spec, target, width=S, height=S, edge_grad=True,
                       **kw)
    return img, target, np.asarray(jax.jit(jax.grad(loss))(pv))


def port_case(name, target, **kw):
    """The port's image without and with the edge term, and the gradient
    of the MSE to ``target`` with it."""
    _, tc = scenes(name)
    p = torch.from_numpy(tc.params.copy()).requires_grad_()
    before = dict(km.LAUNCHES)
    with torch.no_grad():
        smooth = render_image_diff(tc.spec, p, width=S, height=S, **kw)
        edge = render_image_diff(tc.spec, p, width=S, height=S,
                                 edge_grad=True, **kw)
    make_loss(tc.spec, target, width=S, height=S, edge_grad=True,
              **kw)(p).backward()
    assert km.LAUNCHES == before  # CPU tensors never reach the kernel
    return smooth.numpy(), edge.numpy(), p.grad.numpy()


# (JAX options, port options): the port's march="plain" is JAX's "xla".
CASES = {
    "plain": (dict(), dict()),
    "kernel": (dict(geometry="baked", normals="detached"),
               dict(geometry="baked", normals="kernel", march="kernel")),
}


def check_edge_gradient(name, bounces, case):
    """The port's image and edge gradient against JAX's, at the module
    docstring's tolerances."""
    jkw, tkw = CASES[case]
    img_j, target, g_j = jax_case(name, tuple(sorted(dict(
        jkw, bounces=bounces).items())))
    smooth, edge, g_t = port_case(name, target, bounces=bounces, **tkw)
    np.testing.assert_array_equal(edge, smooth)
    np.testing.assert_allclose(edge, img_j, rtol=0, atol=IMG_TOL)
    assert np.isfinite(g_t).all()
    scale = np.abs(g_j).max()
    assert scale > 0
    np.testing.assert_allclose(g_t, g_j, rtol=0, atol=GRAD_TOL * scale)
    cos = float(g_t @ g_j / (np.linalg.norm(g_t) * np.linalg.norm(g_j)))
    assert cos >= 1 - COS_TOL
    if name == "flat":
        # The position moves only through the silhouette.
        assert g_j[_sx(scenes(name)[1])] != 0.0


@pytest.mark.parametrize("case", sorted(CASES))
def test_flat_sphere_edge_gradient_matches_jax(case):
    check_edge_gradient("flat", 0, case)


def _flat_target(tc, width, dx):
    p = tc.params.copy()
    p[_sx(tc)] += dx
    with torch.no_grad():
        return render_image_diff(tc.spec, torch.from_numpy(p), width=width,
                                 height=width, bounces=0)


def test_flat_sphere_edge_gradient_against_finite_difference():
    """tests/test_edge.py:56 and :87 in the port, at 48x48: no smooth
    position gradient, and an edge gradient of the finite difference's sign
    within 5x of its size."""
    _, tc = scenes("flat")
    s = _sx(tc)
    target = _flat_target(tc, 48, SHIFT)
    p0 = torch.from_numpy(tc.params.copy())

    def grad(edge):
        p = p0.clone().requires_grad_()
        make_loss(tc.spec, target, width=48, height=48, bounces=0,
                  edge_grad=edge)(p).backward()
        return float(p.grad[s])

    assert abs(grad(False)) < 1e-6
    g = grad(True)
    loss = make_loss(tc.spec, target, width=48, height=48, bounces=0)
    dp = torch.zeros_like(p0)
    dp[s] = 0.1
    with torch.no_grad():
        fd = (float(loss(p0 + dp)) - float(loss(p0 - dp))) / 0.2
    assert g != 0.0 and np.sign(g) == np.sign(fd), (g, fd)
    assert 0.2 < abs(g) / abs(fd) < 5.0, (g, fd)


def test_edge_grad_recovers_position():
    """tests/test_edge.py:126 in the port: the position comes back through
    the silhouette, and without the edge term it cannot move."""
    _, tc = scenes("flat")
    s = _sx(tc)
    target = _flat_target(tc, 48, 0.0)
    init = tc.params.copy()
    init[s] += 0.3
    mask = np.zeros_like(init)
    mask[s] = 1.0
    kw = dict(width=48, height=48, bounces=0, learning_rate=2e-2,
              param_mask=mask)
    res = optimize_to_target(tc.spec, torch.from_numpy(init), target,
                             steps=60, edge_grad=True, **kw)
    assert abs(float(res.params[s]) - float(tc.params[s])) < 0.25 * 0.3
    frozen = optimize_to_target(tc.spec, torch.from_numpy(init), target,
                                steps=5, **kw)
    assert abs(float(frozen.params[s]) - init[s]) < 1e-5
