"""Port parity: the fused step's primary edge term (``edge_grad``) against
the JAX fused kernel, and ``optimize_to_target(fused=True)`` and the CLI
``optimize --fused`` on the CPU.

The edge estimator samples the closest approach of the primary ray at its
march taps.  The port's edge marches do not cull; JAX's cull per (32, 128)
tile, which moves its taps, so the sampled closest approach of a pixel
differs and the edge term agrees to a few per cent, not to rounding.  The
tolerances are measured (flat ball, 48x48, the target the ball shifted by
0.25): the position slot within 1 % of JAX's value (measured 0.36 %), the
whole gradient within 1 % of its largest entry (measured 0.56 %) and a
cosine above 0.9999 (0.99998).  The
smooth part and the loss stay exact: the loss within 1e-6, the gradient
without the edge term as tests/test_torch_train_winner.py.
"""

import numpy as np
import pytest
import torch

from compute_path_tracer_tpu_torch.app.cli import main as cli_main
from compute_path_tracer_tpu_torch.diff import optimize_to_target
from compute_path_tracer_tpu_torch.diff import render_image_diff
from compute_path_tracer_tpu_torch.kernels import train as tt
from test_torch_train_winner import check, jax_step, port_step, scenes

EDGE_SLOT_REL, EDGE_ATOL, EDGE_COS = 1e-2, 1e-2, 0.9999


def _sx():
    _, tc = scenes("flat_ball")
    return tc.spec.roots[0].children_shapes[0].transform.pos[0]


def _cos(a, b):
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_flat_ball_smooth_position_gradient_is_zero():
    """Without the edge term the position gets no gradient, as in JAX."""
    gt, _ = check("flat_ball", 48, 48, "shifted", bounces=0)
    assert gt[_sx()] == 0.0


def test_flat_ball_edge_term_matches_jax():
    sx = _sx()
    l0, _, _ = port_step("flat_ball", 48, 48, "shifted", bounces=0)
    l1, g1, _ = port_step("flat_ball", 48, 48, "shifted", bounces=0,
                          edge_grad=True)
    lj, gj, _ = jax_step("flat_ball", 48, 48, "shifted",
                         (("bounces", 0), ("edge_grad", True)))
    assert l0 == l1  # the edge term changes the gradient only
    assert abs(l1 - lj) < 1e-6
    assert gj[sx] != 0.0
    assert abs(g1[sx] - gj[sx]) < EDGE_SLOT_REL * abs(gj[sx])
    assert np.abs(g1 - gj).max() < EDGE_ATOL * np.abs(gj).max()
    assert _cos(g1, gj) > EDGE_COS


def test_bounces_zero_edge_demo():
    """edge_demo, bounces=0 with the edge term: finite, non-zero and close
    to JAX (tests/test_train_fused.py:383; measured cosine 0.99985)."""
    lt, gt, _ = port_step("edge_demo", 32, 16, "zero", bounces=0,
                          edge_grad=True)
    lj, gj, _ = jax_step("edge_demo", 32, 16, "zero",
                         (("bounces", 0), ("edge_grad", True)))
    assert np.isfinite(gt).all() and np.abs(gt).max() > 0
    assert abs(lt - lj) < 1e-6
    assert _cos(gt, gj) > 0.999


def test_optimize_fused_descends():
    """optimize_to_target(fused=True) drives Adam with the fused step and
    lowers the loss of a material-perturbed self-target
    (tests/test_train_fused.py:108)."""
    _, tc = scenes("sphere_and_plane")
    from compute_path_tracer_tpu_torch.render.scenegen import material_slot_matrix

    with torch.no_grad():
        target = render_image_diff(tc.spec, torch.from_numpy(tc.params),
                                   width=32, height=16, bounces=1,
                                   geometry="baked")
    init = tc.params + np.random.default_rng(2).normal(
        0, 0.05, tc.params.shape).astype(np.float32)
    init[material_slot_matrix(tc.spec)[:, 13]] = 0.0
    res = optimize_to_target(tc.spec, torch.from_numpy(init), target,
                             width=32, height=16, bounces=1, steps=12,
                             learning_rate=2e-2, fused=True)
    losses = res.losses.numpy()
    assert np.isfinite(losses).all()
    assert losses[1:].min() < losses[0]


def test_optimize_fused_edge_recovers_position():
    """The flat ball's x-position, 0.3 off, comes back to within a quarter
    of the error in 60 steps with the edge term, and does not move without
    it (tests/test_train_fused.py:288-319)."""
    _, tc = scenes("flat_ball")
    s = _sx()
    p_true = torch.from_numpy(tc.params.copy())
    with torch.no_grad():
        target = render_image_diff(tc.spec, p_true, width=48, height=48,
                                   bounces=0)
    init = tc.params.copy()
    init[s] += 0.3
    mask = np.zeros_like(init)
    mask[s] = 1.0
    kw = dict(width=48, height=48, bounces=0, learning_rate=2e-2,
              param_mask=mask, fused=True)
    res = optimize_to_target(tc.spec, torch.from_numpy(init), target,
                             steps=60, edge_grad=True, **kw)
    err0 = abs(init[s] - float(p_true[s]))
    assert abs(float(res.params[s]) - float(p_true[s])) < 0.25 * err0
    frozen = optimize_to_target(tc.spec, torch.from_numpy(init), target,
                                steps=5, **kw)
    assert abs(float(frozen.params[s]) - init[s]) < 1e-5


def test_optimize_fused_rejections():
    _, tc = scenes("sphere_and_plane")
    _, glass = scenes("glass_demo")
    tgt = np.zeros((16, 32, 3), np.float32)
    p = torch.from_numpy(tc.params)
    for kw in ({"geometry": "baked"}, {"march": "kernel"},
               {"implicit": False}):
        with pytest.raises(ValueError, match="fused=True ignores"):
            optimize_to_target(tc.spec, p, tgt, width=32, height=16,
                               bounces=1, fused=True, **kw)
    with pytest.raises(ValueError, match="refract"):
        optimize_to_target(glass.spec, torch.from_numpy(glass.params), tgt,
                           width=32, height=16, bounces=1, fused=True)
    # Without fused=True the edge terms are the autograd path's.
    res = optimize_to_target(tc.spec, p, tgt, width=32, height=16, bounces=1,
                             edge_grad=True, edge_secondary=True, steps=2)
    assert torch.isfinite(res.params).all()
    assert np.isfinite(res.losses.numpy()).all()


def test_cli_optimize_fused_on_cpu(capsys):
    assert cli_main(["optimize", "--device", "cpu", "--fused", "--edge-grad",
                     "--edge-secondary", "--width", "16", "--height", "16",
                     "--steps", "3"]) == 0
    out = capsys.readouterr().out
    assert "step    0 loss" in out and "final loss" in out
    assert tt.LAUNCHES["train_fused"] == 0
