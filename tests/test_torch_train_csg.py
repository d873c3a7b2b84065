"""Port parity: the fused step's map-vjp mode (trees with a non-union op:
the kernel writes the per-bounce segment planes, the map vjp runs in
torch) on csg_demo, 32x16, one bounce, against the JAX fused kernel;
tolerances as tests/test_torch_train_winner.py (measured: equal to 2.2e-7
of the largest entry)."""

import numpy as np
import torch

from compute_path_tracer_tpu_torch.kernels import megakernel as mk
from compute_path_tracer_tpu_torch.render.baked import spec_is_union_only
from test_torch_train_winner import check, port_step, scenes


def test_map_vjp_mode_matches_jax():
    _, tc = scenes("csg_demo")
    assert not spec_is_union_only(tc.spec)
    gt, _ = check("csg_demo", 32, 16, bounces=1)
    assert np.abs(gt).max() > 0


def test_map_vjp_image_is_k2_tcull_frame():
    """Phase 1 is K2's baked t-culled march: the image is its frame."""
    _, tc = scenes("csg_demo")
    _, _, img = port_step("csg_demo", 32, 16, "noise", bounces=1)
    k2 = mk.render_frame_megakernel_plain(
        tc.spec, torch.from_numpy(tc.params), width=32, height=16, bounces=1,
        geometry="baked", t_cull=True)
    np.testing.assert_array_equal(img, k2.numpy())


def test_map_vjp_edge_terms_add_signal():
    """The edge rows (the primary row through the map vjp, the secondary
    ones reduced per shape) change the gradient, not the loss."""
    l0, g0, _ = port_step("csg_demo", 32, 16, "noise", bounces=1)
    l2, g2, _ = port_step("csg_demo", 32, 16, "noise", bounces=1,
                          edge_grad=True, edge_secondary=True)
    assert l0 == l2
    assert np.isfinite(g2).all() and np.abs(g2 - g0).max() > 0
