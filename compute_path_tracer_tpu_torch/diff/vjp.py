"""Differentiation of rendered pixels with respect to the scene parameters
(JAX package: ``diff/vjp.py``): gradients of the image with respect to the
flat parameter vector, for inverse rendering.

Two paths, as in the JAX package:

* **plain autodiff** (``implicit=False``): autograd through the oracle
  renderer, whose march and bounce loop update their state out of place;
* **implicit-function march** (``implicit=True``, the default): the march
  is wrapped in ``kernels.march.ImplicitCast``, which treats the hit
  distance t* as the root of f(ro + t rd, theta) = 0 and back-propagates
  with

      dt*/dtheta = -f_theta / (f_p . rd),
      dt*/dro    = -f_p     / (f_p . rd),
      dt*/drd    = -t* f_p  / (f_p . rd),

  evaluated at the hit point: one map vjp instead of an 80-step tape.

Both capture the smooth shading and geometry terms only.  The JAX
package's XLA silhouette estimators (``edge_grad``, ``edge_secondary``,
``make_closest_approach``, ``_march_closest``) are not ported yet: passing
them raises ``NotImplementedError`` (ROADMAP queue 1, item 8.1); the fused
step of kernels/train.py has its own edge terms.

Names: the JAX ``march="xla"`` (the march in the XLA graph) is the port's
``march="plain"`` (``cast_ray`` in torch), and ``march="pallas"`` (the
Pallas kernel K3) is ``march="kernel"``: on a CUDA tensor the CUDA kernel
``kernels/csrc/march_rays.cu``, t-interval-culled as the JAX kernel is by
default, and on a CPU tensor its plain torch version.  ``march_interpret``
has no counterpart.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import DEFAULT_FOV
from ..kernels.march import ImplicitCast, cast_outputs, make_kernel_cast
from ..render.baked import bake, make_bounds_baked, make_map_baked
from ..render.reference import (
    calc_normal,
    calc_normal_autodiff,
    camera_rays,
    cast_ray,
    gather_material,
    path_trace,
    render_pixels,
)
from ..render.scenegen import make_bounds, make_map, material_slot_matrix
from ..scene.compile import SceneSpec
from ..vecmath import Vec3

MARCHES = ("plain", "kernel")
NORMALS = ("central", "autodiff", "detached", "kernel")


def check_smooth_only(edge_grad: bool = False, edge_secondary: bool = False):
    """Raise for the options of the JAX renderer this port does not have."""
    if edge_grad or edge_secondary:
        raise NotImplementedError(
            "edge_grad / edge_secondary of the autograd path (the XLA "
            "silhouette estimators) are not ported (ROADMAP queue 1, item "
            "8.1); the fused step has them (fused=True)")


def make_implicit_cast(map_fn, gv: torch.Tensor):
    """``cast_fn(ro, rd, checks) -> (t, idx)`` for ``path_trace`` with an
    O(1)-memory implicit-gradient backward (JAX ``make_implicit_cast``): the
    forward is ``cast_ray`` over ``map_fn(p, gv, checks)`` with ``gv``
    detached, the backward one vjp of the same map at the hit points."""
    gv_fixed = gv.detach()

    def cast_fn(ro, rd, checks):
        def march(o, d):
            return cast_ray(lambda p, c: map_fn(p, gv_fixed, c), o, d, checks)

        return cast_outputs(ImplicitCast.apply(
            march, map_fn, lambda o, d: checks, gv, *ro, *rd))

    return cast_fn


def render_pixels_diff(
    spec: SceneSpec,
    params: torch.Tensor,
    xs,
    ys,
    frame,
    bounces: int,
    fov: float,
    aspect: float,
    *,
    width: int,
    height: int,
    implicit: bool = True,
    geometry: str = "faithful",
    edge_grad: bool = False,
    edge_beta: float = 0.5,
    edge_secondary: bool = False,
    edge_beta2: float = 2.0,
    march: str = "plain",
    normals: str = "central",
    remat: bool = False,
) -> Vec3:
    """Differentiable path-traced pixels ``(xs, ys)`` (int32, any shape;
    ``width``/``height`` are the full image's) on ``params``' device.

    ``implicit=False`` differentiates through the oracle renderer
    (``render_pixels``; ``march``, ``normals`` and ``remat`` are not read,
    as in the JAX package).  With ``implicit=True``:

    * ``march="plain"`` marches with ``cast_ray`` in torch,
      ``march="kernel"`` with K3 (``kernels/march.py``), t-culled; both
      back-propagate the implicit gradient at the hit;
    * ``normals``: ``"central"`` the 6-tap central difference, differentiated;
      ``"autodiff"`` the exact map gradient by autograd
      (``calc_normal_autodiff``); ``"detached"`` the central difference with
      no gradient (the shading-normal term is dropped, values unchanged);
      ``"kernel"`` (requires ``march="kernel"``) the normal K3 computes in
      the march, detached: the fused form of ``"detached"``;
    * ``geometry="baked"`` marches the leaf-baked map; ``bake`` is
      differentiable, so the baked vector's cotangent reaches the params;
    * ``remat=True`` checkpoints each bounce (recomputed in the backward).
    """
    check_smooth_only(edge_grad, edge_secondary)
    if march not in MARCHES:
        raise ValueError(f"march must be one of {MARCHES}, not {march!r}")
    if normals not in NORMALS:
        raise ValueError(f"normals must be one of {NORMALS}, not {normals!r}")
    if not implicit:
        return render_pixels(spec, params, xs, ys, frame, bounces, fov, aspect,
                             width=width, height=height, debug=0,
                             geometry=geometry)
    if geometry == "baked":
        map_fn, bounds = make_map_baked(spec), make_bounds_baked(spec)
        gv = bake(spec, params)
    elif geometry == "faithful":
        map_fn, bounds = make_map(spec), make_bounds(spec)
        gv = params
    else:
        raise ValueError("geometry must be 'faithful' or 'baked'")
    if normals == "kernel" and march != "kernel":
        raise ValueError('normals="kernel" requires march="kernel"')
    mats = params[torch.as_tensor(material_slot_matrix(spec),
                                  dtype=torch.int64, device=params.device)]
    rng, ro, rd = camera_rays(xs, ys, frame, fov, aspect, width=width,
                              height=height)
    gv_fixed = gv.detach()

    def bounds_fn(o, d):
        # The guards of the torch map taps; K3 computes its own, so with its
        # normal no tap runs outside the kernel in the forward.
        return () if normals == "kernel" else bounds(o, d, gv_fixed)[0]

    def map_gv(p, checks):
        return map_fn(p, gv, checks)

    normal_fn = None
    if march == "kernel":
        cast_fn = make_kernel_cast(spec, params, gv, geometry=geometry,
                                   with_normal=normals == "kernel")
    else:
        cast_fn = make_implicit_cast(map_fn, gv)
    if normals == "central":
        def normal_fn(p, _idx, checks):
            return calc_normal(map_gv, p, checks)
    elif normals == "autodiff":
        def normal_fn(p, _idx, checks):
            return calc_normal_autodiff(map_gv, p, checks)
    elif normals == "detached":
        # The normal as a constant of the backward: values bit-identical to
        # "central", the second-order shading-normal term dropped.
        @torch.no_grad()
        def normal_fn(p, _idx, checks):
            return calc_normal(lambda q, c: map_fn(q, gv_fixed, c),
                               Vec3(*(c.detach() for c in p)), checks)

    col, _ = path_trace(bounds_fn, cast_fn, normal_fn,
                        lambda idx: gather_material(mats, idx), ro, rd, rng,
                        bounces, remat=remat)
    return Vec3(*(c.reshape(xs.shape) for c in col))


def render_image_diff(
    spec: SceneSpec,
    params: torch.Tensor,
    *,
    width: int,
    height: int,
    bounces: int = 2,
    spp: int = 1,
    fov: float = DEFAULT_FOV,
    aspect: float = None,
    implicit: bool = True,
    geometry: str = "faithful",
    edge_grad: bool = False,
    edge_beta: float = 0.5,
    edge_secondary: bool = False,
    edge_beta2: float = 2.0,
    march: str = "plain",
    normals: str = "central",
    remat: bool = False,
) -> torch.Tensor:
    """Differentiable full-frame render on ``params``' device, averaging
    ``spp`` RNG streams (frames 0..spp-1) per pixel.  Returns (H, W, 3)."""
    if aspect is None:
        aspect = width / height
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.int32, device=params.device),
        torch.arange(width, dtype=torch.int32, device=params.device),
        indexing="ij")
    acc = None
    for f in range(spp):
        img = render_pixels_diff(
            spec, params, xs, ys, f, bounces, fov, aspect, width=width,
            height=height, implicit=implicit, geometry=geometry,
            edge_grad=edge_grad, edge_beta=edge_beta,
            edge_secondary=edge_secondary, edge_beta2=edge_beta2, march=march,
            normals=normals, remat=remat).stack()
        acc = img if acc is None else acc + img
    return acc / float(spp)


def make_loss(
    spec: SceneSpec,
    target,
    *,
    width: int,
    height: int,
    bounces: int = 2,
    spp: int = 1,
    fov: float = DEFAULT_FOV,
    implicit: bool = True,
    geometry: str = "faithful",
    edge_grad: bool = False,
    edge_beta: float = 0.5,
    edge_secondary: bool = False,
    edge_beta2: float = 2.0,
    march: str = "plain",
    normals: str = "central",
    remat: bool = False,
):
    """``loss(params)``: the MSE of the differentiable render against
    ``target`` (an (H, W, 3) array or tensor, moved to the params' device);
    call ``.backward()`` on it or pass it to ``torch.autograd.grad``."""
    check_smooth_only(edge_grad, edge_secondary)
    target = torch.as_tensor(np.array(target, np.float32) if isinstance(
        target, np.ndarray) else target, dtype=torch.float32)

    def loss(params: torch.Tensor) -> torch.Tensor:
        img = render_image_diff(
            spec, params, width=width, height=height, bounces=bounces,
            spp=spp, fov=fov, implicit=implicit, geometry=geometry,
            edge_grad=edge_grad, edge_beta=edge_beta,
            edge_secondary=edge_secondary, edge_beta2=edge_beta2, march=march,
            normals=normals, remat=remat)
        nonlocal target
        target = target.to(img.device)
        return torch.mean((img - target) ** 2)

    return loss
