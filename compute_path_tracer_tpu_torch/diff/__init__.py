"""Differentiable rendering and inverse rendering (JAX package: ``diff/``):
the implicit-gradient march, ``make_loss`` and ``optimize_to_target``."""

from .inverse import OptimizeResult, optimize_to_target
from .vjp import make_implicit_cast, make_loss, render_image_diff, render_pixels_diff

__all__ = [
    "OptimizeResult",
    "make_implicit_cast",
    "make_loss",
    "optimize_to_target",
    "render_image_diff",
    "render_pixels_diff",
]
