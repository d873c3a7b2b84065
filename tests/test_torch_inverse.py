"""Port parity: the training path's entry points (JAX package:
``diff/inverse.py:optimize_to_target``, ``app/cli.py optimize``), the
differentiable renderer on a CSG scene with a subtraction, and the options
not ported yet (the fused step's entry points are in
tests/test_torch_train_edge.py).

Tolerances, with their reasons:

* csg_demo image and gradient: as tests/test_torch_diff.py (1e-6; 1e-4 of
  the largest JAX entry, cosine above 1 - 1e-6);
* the first 5 losses of ``optimize_to_target`` within 2e-4 relative:
  optax's Adam takes its bias corrections in float32, torch's in float64,
  so an early update differs by about 6e-6 relative (diff/inverse.py); the
  loss, quadratic in the distance to the optimum, doubles the relative
  difference of that distance, which grows as it shrinks (5e-5 at step 5);
* the recovery run is tests/test_diff.py:90's: the final loss below 0.2 of
  the first, the parameter within 0.05.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compute_path_tracer_tpu.diff import optimize_to_target as j_optimize
from compute_path_tracer_tpu.diff import render_image_diff as j_render
from compute_path_tracer_tpu_torch.app.cli import main as cli_main
from compute_path_tracer_tpu_torch.diff import make_loss, optimize_to_target
from compute_path_tracer_tpu_torch.diff import render_image_diff
from compute_path_tracer_tpu_torch.kernels.train import make_fused_value_and_grad
from test_torch_diff import W, H, check_against_jax, scenes


def test_csg_demo_kernel_march_matches_jax():
    """Baked geometry, K3's plain march and normal, against JAX's XLA march
    with detached normals, on a scene with a subtraction.  The radiance is
    a product of material constants, so only material slots get a smooth
    gradient (the implicit backward is never reached)."""
    from compute_path_tracer_tpu_torch.render.scenegen import material_slot_matrix

    _, g = check_against_jax("csg_demo", 16, 16,
                             dict(bounces=1, geometry="baked",
                                  normals="detached"),
                             dict(bounces=1, geometry="baked",
                                  normals="kernel", march="kernel"))
    _, tc = scenes("csg_demo")
    assert set(np.flatnonzero(g)) <= set(material_slot_matrix(tc.spec).ravel())


def _recovery_setup():
    """tests/test_diff.py:90's problem: the ball's brightness perturbed."""
    jc, tc = scenes("sphere_plane")
    target = np.asarray(j_render(jc.spec, jnp.asarray(jc.params), width=W,
                                 height=H, bounces=0))
    ball = tc.spec.roots[0].children_shapes[0]
    slot = ball.material[3]
    init = tc.params.copy()
    init[slot] += np.random.default_rng(0).uniform(0.15, 0.3)
    mask = np.zeros_like(init)
    mask[slot] = 1.0
    return jc, tc, target, init, mask, slot


def test_optimize_first_losses_match_jax():
    jc, tc, target, init, mask, _ = _recovery_setup()
    kw = dict(width=W, height=H, bounces=0, steps=5, learning_rate=5e-2,
              param_mask=mask)
    want = np.asarray(j_optimize(jc.spec, init, target, **kw).losses)
    got = optimize_to_target(tc.spec, torch.from_numpy(init), target,
                             **kw).losses.numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=0)


@pytest.mark.parametrize("march", ["plain", "kernel"])
def test_inverse_rendering_recovers(march):
    _, tc, target, init, mask, slot = _recovery_setup()
    seen = []
    result = optimize_to_target(
        tc.spec, torch.from_numpy(init), target, width=W, height=H, bounces=0,
        steps=40, learning_rate=5e-2, param_mask=mask, geometry="baked",
        march=march, callback=lambda i, loss: seen.append((i, loss)))
    losses = result.losses.numpy()
    assert [i for i, _ in seen] == list(range(40))
    assert losses[-1] < losses[0] * 0.2
    assert abs(float(result.params[slot]) - float(tc.params[slot])) < 0.05
    # Frozen slots stay where they started.
    frozen = mask == 0
    np.testing.assert_array_equal(result.params.numpy()[frozen], init[frozen])


def test_unported_options_raise():
    _, tc = scenes("sphere_plane")
    p = torch.from_numpy(tc.params)
    target = np.zeros((4, 4, 3), np.float32)
    with pytest.raises(NotImplementedError, match="item 8"):
        make_loss(tc.spec, target, width=4, height=4, edge_grad=True)
    with pytest.raises(NotImplementedError, match="item 8"):
        render_image_diff(tc.spec, p, width=4, height=4, edge_secondary=True)
    with pytest.raises(ValueError, match="analytic_all"):
        make_fused_value_and_grad(tc.spec, target, width=4, height=4,
                                  analytic_unboxed=True, analytic_all=True)
    for flag in ("--edge-grad", "--edge-secondary"):
        with pytest.raises(NotImplementedError):
            cli_main(["optimize", "--device", "cpu", "--steps", "1", flag])


def test_cli_optimize_on_cpu(capsys):
    assert cli_main(["optimize", "--device", "cpu", "--steps", "3",
                     "--width", "16", "--height", "12", "--bounces", "1"]) == 0
    out = capsys.readouterr().out
    assert "step    0 loss" in out and "final loss" in out
