"""Row-band and sample sharding over ``torch.distributed`` (JAX package:
``parallel/mesh.py``).

One process a device, as PyTorch has it, where the JAX package has one
program over a mesh of devices:

* **row bands** (JAX's ``tiles`` mesh axis): rank r renders the rows
  ``[r * band_h, (r + 1) * band_h)`` of the frame with the megakernels' row
  offset (K1 and K2 take ``row_offset`` and ``crop_h``, as JAX's kernel
  takes ``iparams_ref[3]``), so each pixel keeps the RNG and the camera of
  its row in the whole frame and the sharded frame is the single-device
  frame bit for bit; ``all_gather`` assembles the frame on every rank, as
  JAX's ``out_specs=P(TILE_AXIS)`` gives the global array;
* **samples** (ray batches): every rank renders the whole frame over its
  own frame indices (RNG streams), and ``all_reduce`` takes the mean;
* **replicated parameters, reduced gradients**: each rank differentiates
  its band's squared error in the same flat parameter vector, and
  ``all_reduce`` sums the partial gradients, where JAX has ``psum``.

A :class:`Mesh` names the process group, this rank, the group's size and
the rank's device.  ``make_mesh`` takes them from the default group
(``initialize_distributed``, parallel/distributed.py) or, with no group,
builds a one-rank mesh; any group will do, so the CPU tests run several
ranks as threads over gloo groups of one store.  The functions run on the
mesh's device: the kernels on a CUDA device, their plain versions on the
CPU.  JAX's ``tile`` and ``interpret`` options (Mosaic's block shape and
interpreter) and ``march_interpret`` have no counterpart.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..constants import DEFAULT_BOUNCES, DEFAULT_FOV
from ..diff.vjp import render_pixels_diff
from ..kernels.megakernel import (
    _pixels,
    render_accumulated_megakernel,
    render_frame_megakernel,
)
from ..kernels.train import (
    _fused_sse_and_grad_impl,
    check_no_refraction,
    fused_mode,
)
from ..render.reference import render_pixels, running_mean
from ..scene.compile import SceneSpec
from ..vecmath import div_exact

TILE_AXIS = "tiles"
BACKENDS = ("kernel", "oracle")


class Mesh(NamedTuple):
    """The ranks that share a frame: ``group`` (a process group; None for
    one rank), this ``rank``, the group's ``size`` and the rank's
    ``device``."""

    group: Optional[object]
    rank: int
    size: int
    device: torch.device


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The mesh of the initialised default process group, on ``device``
    (this process's current CUDA device by default); with no group, a
    one-rank mesh.  Raises ``ValueError`` if ``n_devices`` is given and is
    not the group's size (a torch group cannot be cut as JAX's device list
    is)."""
    if dist.is_available() and dist.is_initialized():
        group, rank, size = (dist.group.WORLD, dist.get_rank(),
                             dist.get_world_size())
    else:
        group, rank, size = None, 0, 1
    if n_devices is not None and int(n_devices) != size:
        raise ValueError(f"n_devices={n_devices}, but the process group has "
                         f"{size} rank(s): start one process a device")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                               "kernels' plain versions")
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(group, rank, size, torch.device(device))


def _bands(mesh: Mesh, height: int) -> tuple:
    """(band_h, row0): this rank's band of a frame ``height`` rows high."""
    if height % mesh.size:
        raise ValueError(f"height {height} not divisible by mesh size "
                         f"{mesh.size}")
    band_h = height // mesh.size
    return band_h, mesh.rank * band_h


def _params(mesh: Mesh, params) -> torch.Tensor:
    return torch.as_tensor(params, dtype=torch.float32, device=mesh.device)


def _target(mesh: Mesh, target) -> torch.Tensor:
    """An (H, W, 3) array or tensor as float32 on the mesh's device."""
    if not isinstance(target, torch.Tensor):
        target = torch.from_numpy(np.asarray(target, np.float32))
    return target.to(device=mesh.device, dtype=torch.float32)


def _sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the mesh's ranks, in place."""
    if mesh.group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not {backend!r}")


def render_frame_sharded(
    spec: SceneSpec,
    params,
    mesh: Mesh,
    accum=None,
    frame: int = 0,
    last_clear: int = 0,
    *,
    width: int = 256,
    height: int = 256,
    debug: int = 0,
    bounces: int = DEFAULT_BOUNCES,
    fov: float = DEFAULT_FOV,
    aspect: float = None,
    backend: str = "kernel",
    geometry: str = "faithful",
    t_cull: bool = False,
    analytic_all: bool = False,
) -> torch.Tensor:
    """One progressive frame with its row bands sharded over the mesh; every
    rank returns the whole (height, width, 3) accumulator (``accum``,
    updated in place, or a new one), bit for bit the single-device frame.

    ``backend="kernel"`` (JAX's ``"pallas"``) runs K1 (``analytic_all``)
    or K2 on the rank's band at its row offset (their plain versions on the
    CPU); ``backend="oracle"`` runs ``render.reference.render_pixels`` on
    the band's pixels, then the running mean.  ``height`` must be divisible
    by the mesh size."""
    _check_backend(backend)
    if aspect is None:
        aspect = width / height
    band_h, row0 = _bands(mesh, height)
    params = _params(mesh, params)
    if accum is None:
        accum = torch.zeros((height, width, 3), dtype=torch.float32,
                            device=mesh.device)
    band = accum[row0:row0 + band_h].clone()
    if backend == "kernel":
        render_frame_megakernel(
            spec, params, band, frame, last_clear, width=width, height=height,
            debug=debug, bounces=bounces, fov=fov, aspect=aspect,
            geometry=geometry, t_cull=t_cull, analytic_all=analytic_all,
            row_offset=row0, crop_h=band_h)
    else:
        xs, ys = _pixels(band_h, width, mesh.device, row0)
        with torch.no_grad():
            col = render_pixels(spec, params, xs, ys, frame, bounces, fov,
                                aspect, width=width, height=height,
                                debug=debug).stack()
        band = col if debug != 0 else running_mean(band, col, last_clear)
    if mesh.group is None:
        return accum.copy_(band)
    dist.all_gather(list(accum.chunk(mesh.size)), band, group=mesh.group)
    return accum


def make_sharded_frame_fn(mesh: Mesh):
    """Adapt :func:`render_frame_sharded` to the RenderSession ``frame_fn``
    signature, so a session renders distributed:
    ``RenderSession(scene, w, h, frame_fn=make_sharded_frame_fn(mesh))``."""

    def frame_fn(spec, params, accum=None, frame=0, last_clear=0, **kw):
        return render_frame_sharded(spec, params, mesh, accum=accum,
                                    frame=frame, last_clear=last_clear, **kw)

    return frame_fn


def render_samples_sharded(
    spec: SceneSpec,
    params,
    mesh: Mesh,
    frames_per_device: int = 1,
    frame0: int = 0,
    *,
    width: int = 256,
    height: int = 256,
    bounces: int = DEFAULT_BOUNCES,
    fov: float = DEFAULT_FOV,
    aspect: float = None,
    backend: str = "oracle",
    geometry: str = "baked",
    t_cull: bool = True,
) -> torch.Tensor:
    """Sample parallelism: rank r renders the whole frame over the frame
    indices (RNG streams) ``frame0 + r * frames_per_device + k``, k <
    ``frames_per_device``, and every rank returns the mean over all of them,
    which is a single device's progressive accumulation of ``size *
    frames_per_device`` frames from ``frame0`` (the running mean does not
    depend on the frames' order) up to rounding.

    ``backend="kernel"`` accumulates the rank's frames through K1/K2
    (``render_accumulated_megakernel``, ``geometry`` and ``t_cull``) and
    averages the ranks' means; ``backend="oracle"`` sums the rank's
    ``render_pixels`` frames (faithful geometry, as in JAX) and divides the
    total by the frame count."""
    _check_backend(backend)
    if aspect is None:
        aspect = width / height
    params = _params(mesh, params)
    fpd = int(frames_per_device)
    first = frame0 + mesh.rank * fpd
    if backend == "kernel":
        acc = render_accumulated_megakernel(
            spec, params, fpd, width=width, height=height, bounces=bounces,
            fov=fov, aspect=aspect, geometry=geometry, t_cull=t_cull,
            frame0=first)
        return div_exact(_sum(mesh, acc), float(mesh.size))
    xs, ys = _pixels(height, width, mesh.device)
    acc = torch.zeros((height, width, 3), dtype=torch.float32,
                      device=mesh.device)
    with torch.no_grad():
        for k in range(fpd):
            acc += render_pixels(spec, params, xs, ys, first + k, bounces,
                                 fov, aspect, width=width, height=height,
                                 debug=0).stack()
    return div_exact(_sum(mesh, acc), float(mesh.size * fpd))


def make_sharded_train_step(
    spec: SceneSpec,
    mesh: Mesh,
    *,
    width: int,
    height: int,
    bounces: int = 2,
    fov: float = DEFAULT_FOV,
    aspect: float = None,
    learning_rate: float = 2e-2,
    march: str = "plain",
    geometry: str = "faithful",
    normals: str = "central",
):
    """The distributed inverse-rendering step: ``step(params, target,
    frame) -> (new_params, loss)``, plain SGD on the mean squared error
    between the rendered frame and the (height, width, 3) ``target``.

    Each rank differentiates its band's summed squared error in the
    replicated params through ``diff.vjp.render_pixels_diff``: with
    ``march="plain"`` (JAX's ``"xla"``) autograd through the oracle
    renderer, with ``march="kernel"`` the implicit gradient at K3's hits,
    with ``normals``.  ``all_reduce`` sums the losses and the gradients,
    which are divided by ``width * height * 3``.  ``geometry`` applies to
    both marches.  Raises ``ValueError`` as JAX does: for ``normals`` other
    than "central" without the kernel march, and for a ``height`` the mesh
    size does not divide."""
    if aspect is None:
        aspect = width / height
    if march != "kernel" and normals != "central":
        raise ValueError(
            f'normals="{normals}" requires march="kernel" (the plain march '
            "always uses central-difference normals)")
    band_h, row0 = _bands(mesh, height)
    denom = float(width * height * 3)
    xs, ys = _pixels(band_h, width, mesh.device, row0)

    def step(params, target, frame):
        params, target = _params(mesh, params), _target(mesh, target)
        p = params.detach().requires_grad_()
        with torch.enable_grad():
            col = render_pixels_diff(
                spec, p, xs, ys, int(frame), bounces, fov, aspect,
                width=width, height=height, implicit=march == "kernel",
                geometry=geometry, march=march, normals=normals).stack()
            sse = torch.sum((col - target[row0:row0 + band_h]) ** 2)
            (grad,) = torch.autograd.grad(sse, p)
        both = _sum(mesh, torch.cat([sse.detach().reshape(1), grad]))
        both = div_exact(both, denom)
        return params - learning_rate * both[1:], both[0]

    return step


def make_fused_sharded_train_step(
    spec: SceneSpec,
    mesh: Mesh,
    *,
    width: int,
    height: int,
    bounces: int = 2,
    fov: float = DEFAULT_FOV,
    aspect: float = None,
    learning_rate: float = 2e-2,
    analytic_unboxed: bool = False,
    edge_grad: bool = False,
    edge_beta: float = 0.5,
    edge_secondary: bool = False,
    edge_beta2: float = 2.0,
):
    """The distributed step over the fused train kernel K4
    (``kernels.train._fused_sse_and_grad_impl``): each rank runs the
    forward and per-pixel backward on its band at its row offset (K4's
    plain version on the CPU), and ``all_reduce`` sums the bands' squared
    errors and gradients, each pixel counted once on the rank that owns
    its row.  Returns ``step(params, target, frame) -> (new_params,
    loss)``, plain SGD; raises ``ValueError`` on a scene with refraction
    (``check_no_refraction``) and for the options
    ``make_fused_value_and_grad`` rejects."""
    mode = fused_mode(spec, bounces, analytic_unboxed=analytic_unboxed,
                      edge_grad=edge_grad, edge_beta=edge_beta,
                      edge_secondary=edge_secondary, edge_beta2=edge_beta2)
    if aspect is None:
        aspect = width / height
    band_h, row0 = _bands(mesh, height)
    inv_n = 1.0 / float(width * height * 3)

    def step(params, target, frame):
        check_no_refraction(spec, params)
        params, target = _params(mesh, params), _target(mesh, target)
        planes = target[row0:row0 + band_h].permute(2, 0, 1).contiguous()
        sse, grad, _ = _fused_sse_and_grad_impl(
            spec, params.detach(), planes, int(frame), fov, aspect, row0,
            width=width, height=height, mode=mode)
        both = _sum(mesh, torch.cat([sse.detach().reshape(1), grad]))
        return params - learning_rate * both[1:], both[0] * inv_n

    return step
