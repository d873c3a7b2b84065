"""compute_path_tracer_tpu_torch: the SDF path tracer in PyTorch and CUDA.

The port of ``compute_path_tracer_tpu`` (JAX on a TPU) to PyTorch with
hand-written CUDA kernels for an NVIDIA H100 (``sm_90a``).  It imports torch
and numpy, never jax; the JAX package stays the reference it is tested
against.

Package layout (module names follow the JAX package):
  scene/     editable CSG tree, param registry, compiler, JSON (numpy only)
  ops/       RNG, camera, AABB, tonemap device math
  render/    bake, packed shape tables, shading and bounce loop, session
  kernels/   CUDA kernels (csrc/), their build script and torch wrappers
  diff/      implicit-gradient march, edge estimators, inverse rendering
  io/        PNG export and checkpoints
  parallel/  row-band and sample sharding over torch.distributed, gradient
             all-reduce, multi-process bring-up, checkpoint recovery
  app/       CLI, settings, timing, the live-editing demo and TUI

Functions that take tensors run on those tensors' device; functions that
make tensors from host data take an explicit ``device``.

``__all__`` is the JAX package's.
"""

__version__ = "0.1.0"

from . import constants, vecmath
from .scene import Scene, Shape, Union, compile_scene
from .render import render_accumulated, render_frame

__all__ = [
    "constants",
    "vecmath",
    "Scene",
    "Shape",
    "Union",
    "compile_scene",
    "render_accumulated",
    "render_frame",
    "__version__",
]
