"""Inverse rendering: optimize the scene parameters to match a target image
(JAX package: ``diff/inverse.py``), with torch's Adam over the flat
parameter vector."""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..scene.compile import SceneSpec
from .vjp import check_smooth_only, make_loss


class OptimizeResult(NamedTuple):
    params: torch.Tensor
    losses: torch.Tensor


def optimize_to_target(
    spec: SceneSpec,
    init_params,
    target,
    *,
    width: int,
    height: int,
    bounces: int = 2,
    spp: int = 1,
    steps: int = 100,
    learning_rate: float = 2e-2,
    optimizer: Optional[Callable[[list], torch.optim.Optimizer]] = None,
    implicit: bool = True,
    param_mask=None,
    callback: Optional[Callable[[int, float], None]] = None,
    geometry: str = "faithful",
    edge_grad: bool = False,
    edge_beta: float = 0.5,
    edge_secondary: bool = False,
    edge_beta2: float = 2.0,
    march: str = "plain",
    fused: bool = False,
    device=None,
) -> OptimizeResult:
    """Adam-optimize the parameter vector toward a target image; returns
    the final params and the per-step loss trace (each step's loss is that
    of the params before its update).

    Runs on ``device``: by default ``init_params``' device when it is a
    tensor, else the GPU.  ``param_mask`` (0/1, the params' shape) freezes
    entries: the gradient is multiplied by it before each update.
    ``optimizer`` makes the optimizer from the parameter list (default
    ``torch.optim.Adam(lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)``,
    optax's ``adam`` defaults).  ``fused=True`` (the JAX package's fused
    train kernel K4) and the edge estimators are not ported and raise
    ``NotImplementedError``.
    """
    if fused:
        raise NotImplementedError(
            "fused=True needs the fused train kernel K4, which is not ported "
            "(ROADMAP queue 1, item 9)")
    check_smooth_only(edge_grad, edge_secondary)
    if device is None:
        device = (init_params.device if isinstance(init_params, torch.Tensor)
                  else "cuda")
    loss_fn = make_loss(
        spec, target, width=width, height=height, bounces=bounces, spp=spp,
        implicit=implicit, geometry=geometry, march=march)
    params = torch.as_tensor(np.asarray(init_params, np.float32)
                             if not isinstance(init_params, torch.Tensor)
                             else init_params, dtype=torch.float32)
    params = params.detach().to(device).clone().requires_grad_()
    mask = None if param_mask is None else torch.as_tensor(
        np.asarray(param_mask, np.float32) if not isinstance(
            param_mask, torch.Tensor) else param_mask,
        dtype=torch.float32).to(device)
    # optax.adam updates by -lr * m_hat / (sqrt(v_hat) + eps) with m_hat =
    # m / (1 - b1^t) and v_hat = v / (1 - b2^t), the corrections in float32
    # (1 - 0.999 rounds to 0.0009999871, 1.3e-5 off); torch takes them in
    # float64 and applies them as lr / (1 - b1^t) and sqrt(v) / sqrt(1 -
    # b2^t).  So an early update differs by about 6e-6 relative.
    opt = (optimizer([params]) if optimizer is not None else
           torch.optim.Adam([params], lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8))
    losses = []
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params)
        loss.backward()
        if mask is not None:
            params.grad.mul_(mask)
        opt.step()
        losses.append(float(loss.detach()))
        if callback is not None:
            callback(i, losses[-1])
    return OptimizeResult(params=params.detach(),
                          losses=torch.tensor(losses, dtype=torch.float32))
