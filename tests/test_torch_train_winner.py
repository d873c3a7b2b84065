"""Port parity: the fused train step (kernels/train.py) in the winner-leaf
mode with the march, against the JAX package's
``make_fused_value_and_grad(..., interpret=True)``, plus the port's own
checks of its host pieces, its ``spp`` and its rejections.

The port runs ``fused_planes_plain`` here (CPU tensors).  Tolerances, with
their reasons (the JAX package's own, tests/test_train_fused.py:100-104):

* loss within 1e-6 and image within 1e-5: the port's per-thread t-culled
  march and JAX's per-tile one land on the same surfaces in these scenes;
* gradient within rtol 1e-3 and atol 1e-4 of the largest JAX entry: autograd
  sums the per-pixel terms in another order than XLA.
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compute_path_tracer_tpu.kernels import train as jt
from compute_path_tracer_tpu.render import baked as jb
from compute_path_tracer_tpu.scene import compile_scene as j_compile
from compute_path_tracer_tpu.scene import library as j_lib
from compute_path_tracer_tpu_torch.kernels import train as tt
from compute_path_tracer_tpu_torch.render import baked as tb
from compute_path_tracer_tpu_torch.scene import compile_scene as t_compile
from compute_path_tracer_tpu_torch.scene import convert_scene

LOSS_TOL, IMG_TOL, RTOL, ATOL = 1e-6, 1e-5, 1e-3, 1e-4


@lru_cache(maxsize=None)
def scenes(name):
    """(JAX compiled, port compiled) of a library scene or a test scene."""
    scene = SCENES[name]() if name in SCENES else getattr(j_lib, name)()
    return j_compile(scene), t_compile(convert_scene(scene))


def flat_ball():
    """tests/test_train_fused.py:246's black, uniformly emissive ball: its
    smooth geometry gradient is zero, only the edge term moves it."""
    from compute_path_tracer_tpu.scene import KIND_SPHERE, Scene, Shape, Union

    root = Union(name="Root")
    ball = root.add_shape(Shape(KIND_SPHERE, name="Ball"))
    ball.size.set(0.8)
    ball.material.color.set(0.0, 0.0, 0.0)
    ball.material.brightness.set(2.0)
    ball.material.light_col.set(1.0, 1.0, 1.0)
    return Scene([root])


def occluder():
    """benchmarks/secondary_edge.py:33's adversarial occluder scene."""
    import sys

    sys.path.insert(0, "benchmarks")
    from secondary_edge import _scene

    return _scene()


SCENES = {"flat_ball": flat_ball, "bench8": lambda: j_lib.benchmark_scene(8),
          "occluder": occluder}


def target_of(height, width, seed=1, scale=0.3):
    return (np.random.default_rng(seed).random((height, width, 3))
            .astype(np.float32) * scale)


@lru_cache(maxsize=None)
def jax_step(name, width, height, target_key, items):
    """The JAX fused step's (loss, grad, image), interpret mode, run op by
    op (``jax.disable_jit``): the same function on the same inputs, in
    about two thirds of the time that its one-off XLA compile and run take
    on the CPU backend (benchmark_scene(8), 32x16, ``analytic_unboxed``:
    45.8 s against 68.6 s, the same loss, gradient and image)."""
    jc, _ = scenes(name)
    target = TARGETS[target_key](name, width, height)
    with jax.disable_jit():
        loss, grad, img = jt.make_fused_value_and_grad(
            jc.spec, target, width=width, height=height, interpret=True,
            with_image=True, **dict(items))(jnp.asarray(jc.params))
    return float(loss), np.asarray(grad), np.asarray(img)


def port_step(name, width, height, target_key, frame=0, **kw):
    _, tc = scenes(name)
    target = TARGETS[target_key](name, width, height)
    before = dict(tt.LAUNCHES)
    loss, grad, img = tt.make_fused_value_and_grad(
        tc.spec, target, width=width, height=height, with_image=True, **kw)(
            torch.from_numpy(tc.params.copy()), frame)
    assert tt.LAUNCHES == before  # CPU tensors never reach the kernel
    return float(loss), grad.numpy(), img.numpy()


def _self_target(name, width, height):
    """The port's own fused image of the ball shifted 0.25 in x."""
    from compute_path_tracer_tpu.diff import render_image_diff

    jc, _ = scenes(name)
    sx = jc.spec.roots[0].children_shapes[0].transform.pos[0]
    p = np.asarray(jc.params).copy()
    p[sx] += 0.25
    return np.asarray(render_image_diff(jc.spec, jnp.asarray(p), width=width,
                                        height=height, bounces=0))


TARGETS = {"noise": lambda name, w, h: target_of(h, w),
           "zero": lambda name, w, h: np.zeros((h, w, 3), np.float32),
           "shifted": _self_target}


def check(name, width, height, target_key="noise", rtol=RTOL, atol=ATOL,
          **kw):
    """The port against JAX: loss, image and gradient; returns both
    gradients."""
    lj, gj, ij = jax_step(name, width, height, target_key,
                          tuple(sorted(kw.items())))
    lt, gt, it = port_step(name, width, height, target_key, **kw)
    assert np.isfinite(gt).all() and it.shape == (height, width, 3)
    assert abs(lt - lj) <= LOSS_TOL * max(1.0, abs(lj))
    np.testing.assert_allclose(it, ij, rtol=0, atol=IMG_TOL)
    scale = np.abs(gj).max()
    np.testing.assert_allclose(gt, gj, rtol=rtol, atol=atol * scale)
    return gt, gj


@pytest.mark.parametrize("bounces", [1, 2])
def test_winner_march_matches_jax(bounces):
    """sphere_and_plane, 32x16: the winner-leaf mode over the march."""
    gt, _ = check("sphere_and_plane", 32, 16, bounces=bounces)
    assert np.abs(gt).max() > 0


def test_spp_averages_frame_streams():
    """spp=2 at frame f is the mean of spp=1 at frames 2f and 2f+1
    (tests/test_train_fused.py:403)."""
    kw = dict(bounces=1)
    l0, g0, _ = port_step("sphere_and_plane", 32, 16, "noise", 6, **kw)
    l1, g1, _ = port_step("sphere_and_plane", 32, 16, "noise", 7, **kw)
    l2, g2, _ = port_step("sphere_and_plane", 32, 16, "noise", 3, spp=2, **kw)
    np.testing.assert_allclose(l2, (l0 + l1) / 2, rtol=1e-6)
    np.testing.assert_allclose(g2, (g0 + g1) / 2, rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("name", ["sphere_and_plane", "csg_demo",
                                  "benchmark_scene"])
def test_baked_helpers_match_jax(name):
    """The winner-leaf mode's static tables: union-only, the geometry slot
    matrix and the leaves in walk order."""
    jc, tc = scenes(name)
    assert tb.spec_is_union_only(tc.spec) == jb.spec_is_union_only(jc.spec)
    assert tb.GEOM_CHANNELS == jb.GEOM_CHANNELS
    np.testing.assert_array_equal(tb.baked_geom_slot_matrix(tc.spec),
                                  jb.baked_geom_slot_matrix(jc.spec))
    assert ([(s.kind, s.shape_id, s.off) for s in tb.baked_shapes_in_order(
        tc.spec)] == [(s.kind, s.shape_id, s.off)
                      for s in jb.baked_shapes_in_order(jc.spec)])


def test_segment_matmul_matches_jax():
    rng = np.random.default_rng(0)
    idx = rng.integers(-1, 5, (3, 40)).astype(np.int32)
    cot = rng.normal(size=(3, 13, 40)).astype(np.float32)
    want = np.asarray(jt._segment_matmul(jnp.asarray(idx), jnp.asarray(cot), 5))
    got = tt._segment_matmul(torch.from_numpy(idx), torch.from_numpy(cot), 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_rejections():
    """The fused step's ValueErrors as JAX raises them."""
    _, glass = scenes("glass_demo")
    _, csg = scenes("csg_demo")
    tgt = np.zeros((8, 8, 3), np.float32)
    kw = dict(width=8, height=8, bounces=1)
    with pytest.raises(ValueError, match="refract"):
        tt.make_fused_value_and_grad(glass.spec, tgt, **kw)(
            torch.from_numpy(glass.params))
    with pytest.raises(ValueError):
        tt.make_fused_value_and_grad(csg.spec, tgt, analytic_all=True, **kw)
    with pytest.raises(ValueError, match="edge_secondary"):
        tt.make_fused_value_and_grad(csg.spec, tgt, edge_secondary=True, **kw)
    with pytest.raises(ValueError, match="analytic_all"):
        tt.make_fused_value_and_grad(csg.spec, tgt, analytic_unboxed=True,
                                     analytic_all=True, **kw)


def test_mat_channels_match_jax():
    assert tt.MAT_CHANNELS == jt._MAT_CHANNELS
    _, tc = scenes("sphere_and_plane")
    assert tb.spec_is_union_only(tc.spec)
