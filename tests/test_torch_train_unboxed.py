"""Port parity: the fused train step with ``analytic_unboxed`` (K4's K2b
mode) against the JAX package's ``make_fused_value_and_grad(...,
analytic_unboxed=True, interpret=True)``.

Phase 1 marches the skip program, capped by the closed form of the
guard-less shapes, and a capped winner takes its exact normal; the edge term
folds in the closed-form closest approach of the skipped spheres; phase 2
and the secondary exclusion march read every leaf.  Tolerances are
tests/test_torch_train_winner.py's, with their reasons: loss within 1e-6,
image within 1e-5, gradient within rtol 1e-3 and atol 1e-4 of the largest
JAX entry.  The edge term's marches, which JAX culls per (32, 128) tile and
the port not at all (tests/test_torch_train_analytic.py), find the same
closest approaches on benchmark_scene(8) in this mode, so the tile-cull
stand-in of that file is not needed here (measured: the largest gradient
difference is 9.2e-5 of the largest entry).
"""

import numpy as np
import pytest
import torch

from compute_path_tracer_tpu_torch.kernels import train as tt
from test_torch_train_winner import check, port_step, scenes


@pytest.mark.parametrize("edge_grad", [False, True])
def test_winner_unboxed_matches_jax(edge_grad):
    """benchmark_scene(8), 32x16, one bounce: the ground plane and the two
    lamps are capped."""
    gt, _ = check("bench8", 32, 16, bounces=1, analytic_unboxed=True,
                  edge_grad=edge_grad)
    assert np.abs(gt).max() > 0


def test_map_vjp_unboxed_matches_jax():
    """csg_demo (a subtraction tree), map-vjp mode: its ground plane and
    lamp are capped, the map vjp reads every leaf."""
    gt, _ = check("csg_demo", 32, 16, bounces=1, analytic_unboxed=True)
    assert np.abs(gt).max() > 0


def test_unboxed_image_is_the_k2_frame():
    """The step's image is the unboxed marching frame of the same sample."""
    from compute_path_tracer_tpu_torch.kernels.megakernel import (
        render_frame_megakernel_plain)

    _, tc = scenes("bench8")
    _, _, img = port_step("bench8", 32, 16, "noise", bounces=1,
                          analytic_unboxed=True)
    frame = render_frame_megakernel_plain(
        tc.spec, torch.from_numpy(tc.params), width=32, height=16, bounces=1,
        geometry="baked", t_cull=True, analytic_unboxed=True)
    np.testing.assert_array_equal(img, frame.numpy())


def test_unboxed_rejects_analytic_all():
    _, tc = scenes("bench8")
    with pytest.raises(ValueError, match="analytic_all"):
        tt.make_fused_value_and_grad(tc.spec, np.zeros((8, 8, 3), np.float32),
                                     width=8, height=8, analytic_all=True,
                                     analytic_unboxed=True)
