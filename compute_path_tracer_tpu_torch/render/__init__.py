"""Renderer layers: baked coefficients, packed shape tables, the torch
oracle (shading and bounce loop) and the render session.

``__all__`` is the JAX package's ``render/__init__.py`` less the XLA SoA
lane (``build_soa_plan``, ``render_frame_soa``, ``render_pixels_soa``),
which is not carried over: K5 (``render_frame_megakernel(...,
analytic_soa=True)``) and its plain version answer for it (ROADMAP queue
1, item 14).
"""

from .reference import (
    Mat,
    calc_normal,
    cast_ray,
    colors_debug,
    gather_material,
    normals_debug,
    path_trace,
    render_accumulated,
    render_frame,
)
from .scenegen import apply_transform, make_bounds, make_map, material_slot_matrix
from .session import RenderSession

__all__ = [
    "RenderSession",
    "Mat",
    "calc_normal",
    "cast_ray",
    "colors_debug",
    "gather_material",
    "normals_debug",
    "path_trace",
    "render_accumulated",
    "render_frame",
    "apply_transform",
    "make_bounds",
    "make_map",
    "material_slot_matrix",
]
