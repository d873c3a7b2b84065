"""Port parity: parallel/mesh.py's sharded training steps, on the JAX
package's tests/test_parallel.py scene (sphere_and_plane, 32x32, 1 bounce,
learning rate 1 so that the step's update is the gradient).

The ranks run as threads over gloo groups (tests/test_torch_parallel.py:
``run_ranks``); every rank's step must be the same.  Tolerances, JAX's own
for the same comparisons:

* ``make_sharded_train_step`` over 8 ranks with the plain march against the
  port's single-device ``make_loss(implicit=False)`` (tests/test_parallel.py
  :96-103: loss rtol 1e-5, gradient within 1e-3 of its largest entry and
  rtol 1e-3: the bands sum the per-pixel terms in another order), with K3's
  march (its plain version) against ``make_loss(march="kernel")``
  (:157-162: 5e-3 and 5e-2), and ``normals="kernel"`` giving the loss of
  the central normals (:183, rtol 1e-6);
* ``make_fused_sharded_train_step``, with and without
  ``analytic_unboxed``, against ``make_fused_value_and_grad`` (:217-222,
  :251-256: loss rtol 1e-5, gradient 1e-4 of its largest entry, rtol 1e-3).

* a dry run in the style of ``__graft_entry__.py:dryrun_multichip`` over 2,
  4 and 8 ranks, 16 wide and 8 rows a rank: the sharded frame through K2
  and K1 (their plain versions), the step through K3, the fused step
  without and with ``analytic_unboxed`` and both edge terms, and the sample
  mean, each finite and of its shape on every rank.

JAX's sharded steps are not run: their reverse-mode compiles take minutes
on the CPU (they are ``slow`` in the JAX package's own tests).
"""

import numpy as np
import pytest
import torch

from compute_path_tracer_tpu_torch.diff import make_loss
from compute_path_tracer_tpu_torch.kernels.train import make_fused_value_and_grad
from compute_path_tracer_tpu_torch.parallel import (
    make_fused_sharded_train_step,
    make_sharded_train_step,
    render_frame_sharded,
    render_samples_sharded,
)
from compute_path_tracer_tpu_torch.parallel.mesh import Mesh
from test_torch_parallel import CPU, H, W, run_ranks, scenes


def _grad(loss_fn, params):
    p = params.clone().requires_grad_()
    loss = loss_fn(p)
    (g,) = torch.autograd.grad(loss, p)
    return loss.item(), g


def _steps(n, make_step, params, target):
    """Each rank's (loss, gradient) of one step at learning rate 1."""
    def rank(mesh):
        new, loss = make_step(mesh)(params, target, 0)
        return float(loss), params - new

    out = run_ranks(n, rank)
    for loss, grad in out[1:]:
        assert loss == out[0][0] and torch.equal(grad, out[0][1])
    return out[0]


def _close(got, want, loss_rtol, atol_scale, rtol):
    (loss, grad), (loss_w, grad_w) = got, want
    assert np.isfinite(loss) and torch.isfinite(grad).all()
    np.testing.assert_allclose(loss, loss_w, rtol=loss_rtol)
    scale = float(grad_w.abs().max())
    assert scale > 0.0
    np.testing.assert_allclose(grad.numpy(), grad_w.numpy(),
                               atol=atol_scale * scale, rtol=rtol)


@pytest.mark.parametrize("march", ["plain", "kernel"])
def test_sharded_train_step_matches_single_device(march):
    _, tc, params = scenes()
    target = torch.zeros((H, W, 3))
    kw = dict(width=W, height=H, bounces=1)
    got = _steps(8, lambda mesh: make_sharded_train_step(
        tc.spec, mesh, learning_rate=1.0, march=march, **kw), params, target)
    single = dict(implicit=False) if march == "plain" else dict(march="kernel")
    want = _grad(make_loss(tc.spec, target, **single, **kw), params)
    tol = (1e-5, 1e-3, 1e-3) if march == "plain" else (1e-5, 5e-3, 5e-2)
    _close(got, want, *tol)


def test_sharded_train_step_kernel_normals():
    _, tc, params = scenes()
    target = torch.zeros((H, W, 3))
    kw = dict(width=W, height=H, bounces=1, learning_rate=1.0,
              march="kernel")
    loss_k, grad_k = _steps(8, lambda mesh: make_sharded_train_step(
        tc.spec, mesh, normals="kernel", **kw), params, target)
    loss_c, _ = _steps(8, lambda mesh: make_sharded_train_step(
        tc.spec, mesh, **kw), params, target)
    assert torch.isfinite(grad_k).all()
    np.testing.assert_allclose(loss_k, loss_c, rtol=1e-6)
    with pytest.raises(ValueError, match="normals"):
        make_sharded_train_step(tc.spec, Mesh(None, 0, 1, CPU), width=W,
                                height=H, normals="kernel")


@pytest.mark.parametrize("unboxed", [False, True],
                         ids=["march", "analytic_unboxed"])
def test_fused_sharded_train_step_matches_single_device(unboxed):
    _, tc, params = scenes()
    target = np.random.default_rng(4 if unboxed else 3).random(
        (H, W, 3)).astype(np.float32) * 0.2
    kw = dict(width=W, height=H, bounces=1, analytic_unboxed=unboxed)
    got = _steps(8, lambda mesh: make_fused_sharded_train_step(
        tc.spec, mesh, learning_rate=1.0, **kw), params, target)
    loss, grad = make_fused_value_and_grad(tc.spec, target, **kw)(params)
    _close(got, (float(loss), grad), 1e-5, 1e-4, 1e-3)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_dryrun_multichip(n):
    """``__graft_entry__.py:dryrun_multichip`` over the port: 16 wide, 8
    rows a rank."""
    _, tc, params = scenes()
    width, height = 16, 8 * n
    target = torch.zeros((height, width, 3))
    kw = dict(width=width, height=height, bounces=1)

    def rank(mesh):
        out = [render_frame_sharded(tc.spec, params, mesh, debug=0, **kw),
               render_frame_sharded(tc.spec, params, mesh, debug=0,
                                    geometry="baked", analytic_all=True,
                                    **kw)]
        step = make_sharded_train_step(tc.spec, mesh, march="kernel",
                                       geometry="baked", **kw)
        out += step(params, target, 0)
        fstep = make_fused_sharded_train_step(tc.spec, mesh, **kw)
        out += fstep(params, target, 0)
        fstep2 = make_fused_sharded_train_step(
            tc.spec, mesh, analytic_unboxed=True, edge_grad=True,
            edge_secondary=True, **kw)
        out += fstep2(params, target, 0)
        out.append(render_samples_sharded(tc.spec, params, mesh,
                                          frames_per_device=1, **kw))
        return out

    for out in run_ranks(n, rank):
        img, img_a, p1, l1, p2, l2, p3, l3, mean = out
        for im in (img, img_a, mean):
            assert im.shape == (height, width, 3)
            assert torch.isfinite(im).all()
        for p, loss in ((p1, l1), (p2, l2), (p3, l3)):
            assert p.shape == params.shape and torch.isfinite(p).all()
            assert np.isfinite(float(loss))
