"""Inverse rendering: optimize the scene parameters to match a target image
(JAX package: ``diff/inverse.py``), with torch's Adam over the flat
parameter vector."""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..kernels.train import check_no_refraction, make_fused_value_and_grad
from ..render.scenegen import material_slot_matrix
from ..scene.compile import SceneSpec
from .vjp import make_loss


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
    optax's ``adam`` defaults).

    ``fused=True`` takes each step's loss and gradient from the fused train
    step (kernels/train.py, one K4 launch per sample on the GPU): baked
    geometry, the on-chip march and detached normals, so it rejects explicit
    ``implicit``, ``geometry`` or ``march`` knobs, and scenes with a
    non-zero refract_chance (``ValueError``); it pins the refract_chance
    slots at their zero start.  ``edge_grad=True`` adds the silhouette
    term (without it no position can move) and ``edge_secondary`` the
    secondary one, on either path: the fused step's own terms with
    ``fused=True``, the autograd path's estimators (diff/vjp.py) without;
    ``edge_beta`` and ``edge_beta2`` scale their bandwidths.
    """
    if device is None:
        device = (init_params.device if isinstance(init_params, torch.Tensor)
                  else "cuda")
    params = torch.as_tensor(np.asarray(init_params, np.float32)
                             if not isinstance(init_params, torch.Tensor)
                             else init_params, dtype=torch.float32)
    params = params.detach().to(device).clone().requires_grad_()
    mask = None if param_mask is None else torch.as_tensor(
        np.asarray(param_mask, np.float32) if not isinstance(
            param_mask, torch.Tensor) else param_mask,
        dtype=torch.float32).to(device)
    if fused:
        if not implicit or geometry != "faithful" or march != "plain":
            # The fused step has fixed semantics; a caller asking for a knob
            # of the autograd path would silently get something else.
            raise ValueError(
                "fused=True ignores implicit/geometry/march (the fused step "
                "is always baked geometry + on-chip march with detached "
                "normals); leave them at their defaults or use fused=False")
        check_no_refraction(spec, params)
        vag = make_fused_value_and_grad(
            spec, target, width=width, height=height, bounces=bounces,
            edge_grad=edge_grad, edge_beta=edge_beta,
            edge_secondary=edge_secondary, edge_beta2=edge_beta2, spp=spp)
        # Pin refract_chance at its (checked) zero: the fused model shades it
        # as zero, so a step off zero would train the wrong model.
        rc = torch.ones_like(params.detach())
        rc[torch.as_tensor(material_slot_matrix(spec)[:, 13],
                           device=device)] = 0.0
        mask = rc if mask is None else mask * rc
    else:
        loss_fn = make_loss(
            spec, target, width=width, height=height, bounces=bounces,
            spp=spp, implicit=implicit, geometry=geometry, march=march,
            edge_grad=edge_grad, edge_beta=edge_beta,
            edge_secondary=edge_secondary, edge_beta2=edge_beta2)
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
        if fused:
            loss, params.grad = vag(params)
        else:
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
