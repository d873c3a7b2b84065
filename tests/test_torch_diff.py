"""Port parity: the differentiable renderer (diff/vjp.py) against the JAX
package's ``render_image_diff`` and ``make_loss`` gradients, on
tests/test_diff.py's 24x24 sphere-and-plane scene, params carried across by
JSON and the target the JAX image times 0.9 (as tests/test_diff.py:128).

The port's ``march="kernel"`` runs K3's plain version here (a CPU tensor)
and is held to the JAX ``march="xla"``, which the JAX package holds bit-equal
to its Pallas march (tests/test_diff.py:189).  Tolerances, with their
reasons:

* images within 1e-6, the JAX package's own diff-versus-oracle contract
  (tests/test_diff.py:87);
* gradients within 1e-4 of the largest JAX entry, and a cosine similarity
  above 1 - 1e-6: autograd sums the per-pixel terms in another order than
  XLA, which also contracts multiply-adds where the port rounds each
  operation (ROADMAP queue 3);
* within the port, ``remat`` against no ``remat`` and the kernel's normal
  against ``normals="detached"`` are exact, value and gradient.

The csg_demo scene, ``optimize_to_target``, the CLI and the options not
ported yet are in tests/test_torch_inverse.py.
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
from compute_path_tracer_tpu.scene import library as j_lib
from compute_path_tracer_tpu_torch.diff import make_loss, render_image_diff
from compute_path_tracer_tpu_torch.kernels import march as km
from compute_path_tracer_tpu_torch.scene import compile_scene as t_compile
from compute_path_tracer_tpu_torch.scene import convert_scene
from test_diff import _scene

W = H = 24
IMG_TOL = 1e-6
GRAD_TOL = 1e-4
COS_TOL = 1e-6


@lru_cache(maxsize=None)
def scenes(name):
    scene = _scene() if name == "sphere_plane" else getattr(j_lib, name)()
    return j_compile(scene), t_compile(convert_scene(scene))


@lru_cache(maxsize=None)
def jax_image_grad(name, width, height, items):
    """The JAX image and the gradient of the MSE to 0.9 times it."""
    jc, _ = scenes(name)
    kw = dict(items)
    pv = jnp.asarray(jc.params)
    img = np.asarray(j_render(jc.spec, pv, width=width, height=height, **kw))
    loss = j_make_loss(jc.spec, img * 0.9, width=width, height=height, **kw)
    return img, np.asarray(jax.grad(loss)(pv))


def port_image_grad(name, width, height, target, **kw):
    _, tc = scenes(name)
    p = torch.from_numpy(tc.params.copy()).requires_grad_()
    before = dict(km.LAUNCHES)
    img = render_image_diff(tc.spec, p, width=width, height=height, **kw)
    loss = make_loss(tc.spec, target, width=width, height=height, **kw)(p)
    loss.backward()
    assert km.LAUNCHES == before  # CPU tensors never reach the kernel
    return img.detach().numpy(), p.grad.numpy(), float(loss.detach())


def port_target(**kw):
    _, tc = scenes("sphere_plane")
    with torch.no_grad():
        img = render_image_diff(tc.spec, torch.from_numpy(tc.params), width=W,
                                height=H, **kw)
    return img * 0.9


def check_against_jax(name, width, height, jax_kw, port_kw):
    img_j, g_j = jax_image_grad(name, width, height,
                                tuple(sorted(jax_kw.items())))
    img_t, g_t, _ = port_image_grad(name, width, height, img_j * 0.9,
                                    **port_kw)
    assert img_t.shape == (height, width, 3) and np.isfinite(g_t).all()
    np.testing.assert_allclose(img_t, img_j, rtol=0, atol=IMG_TOL)
    scale = np.abs(g_j).max()
    assert scale > 0
    np.testing.assert_allclose(g_t, g_j, rtol=0, atol=GRAD_TOL * scale)
    cos = float(g_t @ g_j / (np.linalg.norm(g_t) * np.linalg.norm(g_j)))
    assert cos >= 1 - COS_TOL
    return img_t, g_t


# (JAX options, port options): the port's march="plain" is JAX's "xla".
CASES = {
    "autodiff_march": (dict(bounces=0, implicit=False),
                       dict(bounces=0, implicit=False)),
    "implicit_faithful": (dict(bounces=1), dict(bounces=1)),
    "implicit_faithful_remat": (dict(bounces=1), dict(bounces=1, remat=True)),
    "baked_plain_detached": (dict(bounces=1, geometry="baked",
                                  normals="detached"),
                             dict(bounces=1, geometry="baked",
                                  normals="detached")),
    "baked_kernel_detached": (dict(bounces=1, geometry="baked",
                                   normals="detached"),
                              dict(bounces=1, geometry="baked",
                                   normals="detached", march="kernel")),
    "baked_kernel_normals": (dict(bounces=1, geometry="baked",
                                  normals="detached"),
                             dict(bounces=1, geometry="baked",
                                  normals="kernel", march="kernel")),
    "faithful_kernel_central": (dict(bounces=1),
                                dict(bounces=1, march="kernel")),
    "autodiff_normals": (dict(bounces=1, normals="autodiff"),
                         dict(bounces=1, normals="autodiff")),
    "baked_kernel_spp2": (dict(bounces=1, geometry="baked", spp=2),
                          dict(bounces=1, geometry="baked", spp=2,
                               march="kernel")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_image_and_grad_match_jax(case):
    jax_kw, port_kw = CASES[case]
    check_against_jax("sphere_plane", W, H, jax_kw, port_kw)


def test_remat_is_exact():
    """remat=True recomputes each bounce in the backward: value and gradient
    equal to the taped path, as tests/test_diff.py:153 holds JAX's."""
    base = dict(bounces=2, geometry="baked", march="kernel")
    target = port_target(**base)
    a = port_image_grad("sphere_plane", W, H, target, **base)
    b = port_image_grad("sphere_plane", W, H, target, remat=True, **base)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_kernel_normals_equal_detached():
    """normals="kernel" is the fused form of "detached": the same values
    and the same gradient (tests/test_diff.py:171)."""
    base = dict(bounces=2, geometry="baked", march="kernel")
    target = port_target(**base)
    a = port_image_grad("sphere_plane", W, H, target, normals="detached",
                        **base)
    b = port_image_grad("sphere_plane", W, H, target, normals="kernel", **base)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_kernel_normals_need_the_kernel_march():
    _, tc = scenes("sphere_plane")
    with pytest.raises(ValueError):
        render_image_diff(tc.spec, torch.from_numpy(tc.params), width=4,
                          height=4, normals="kernel")
