"""Pinhole camera and pixel-to-NDC mapping (JAX package: ``ops/camera.py``).

NDC with aspect correction (reference funcs.glsl:1-7) and the fixed pinhole
camera at (0, 0, -3) looking down +z, with the "fov" slider as the z
component of the un-normalized direction (test_compute.glsl:232-235).
"""

from __future__ import annotations

import torch

from ..constants import CAMERA_ORIGIN
from ..vecmath import Vec3, div_exact


def calc_uv(px, py, width: int, height: int, aspect: float):
    """Pixel coords (+ subpixel jitter) -> NDC in [-1, 1], x scaled by aspect
    (funcs.glsl:1-7).  The divisions are true ones on every device
    (``div_exact``), as in the kernels: a reciprocal would move a few rays
    by an ulp, and an edge pixel with them."""
    u = div_exact(px, float(width)) * 2.0 - 1.0
    v = div_exact(py, float(height)) * 2.0 - 1.0
    return u * aspect, v


def primary_ray(u, v, fov: float):
    """Camera ray: origin (0,0,-3), direction normalize(u, v, fov)
    (test_compute.glsl:232-235)."""
    ro = Vec3(*(torch.full_like(u, c) for c in CAMERA_ORIGIN))
    rd = Vec3(u, v, torch.full_like(u, fov)).normalize()
    return ro, rd
