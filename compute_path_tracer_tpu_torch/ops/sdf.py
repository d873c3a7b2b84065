"""Analytic signed-distance functions, the Euler rotation and the CSG
combines (JAX package: ``ops/sdf.py``; reference shapes.glsl).

Elementwise torch over structure-of-arrays ``Vec3`` values, every operation
in the JAX version's order.  A CSG hit is a pair ``(d, idx)``: a distance
and the int32 id of the winning primitive (``idx < 0`` = no primitive).
The CUDA marching kernel (kernels/csrc/megakernel_march.cu) evaluates the
same formulas with the same rounding.
"""

from __future__ import annotations

import torch

from ..scene.compile import OP_SMOOTH_UNION, OP_SUBTRACTION, OP_UNION
from ..vecmath import Vec3, div_exact, vmax

# -- primitive distance functions ------------------------------------------


def sd_sphere(p: Vec3, r):
    """Sphere of radius r at the origin (shapes.glsl:1-3)."""
    return p.length_safe() - r


def sd_cube(p: Vec3, b: Vec3):
    """Axis-aligned box with half-extent b (shapes.glsl:5-9)."""
    q = p.abs() - b
    outside = vmax(q, Vec3.splat(torch.zeros_like(q.x))).length_safe()
    inside = torch.clamp(q.max_component(), max=0.0)
    return outside + inside


def sd_plane(p: Vec3):
    """Horizontal plane through the origin (distance = p.y)."""
    return p.y


def sd_octahedron(p: Vec3, s):
    """Exact octahedron (shapes.glsl:13-25), branch-free."""
    p = p.abs()
    m = p.x + p.y + p.z - s

    def branch(qx, qy, qz):
        k = torch.minimum(torch.clamp(0.5 * (qz - qy + s), min=0.0),
                          torch.as_tensor(s, dtype=qz.dtype, device=qz.device))
        return Vec3(qx, qy - s + k, qz - k).length_safe()

    out = m * 0.57735027
    out = torch.where(3.0 * p.z < m, branch(p.z, p.x, p.y), out)
    out = torch.where(3.0 * p.y < m, branch(p.y, p.z, p.x), out)
    out = torch.where(3.0 * p.x < m, branch(p.x, p.y, p.z), out)
    return out


# -- spatial transforms -----------------------------------------------------


def move(p: Vec3, by: Vec3) -> Vec3:
    """Translation: p - by (shapes.glsl:30-32)."""
    return p - by


def rot3d_cs(p: Vec3, cx, sx, cy, sy, cz, sz) -> Vec3:
    """:func:`rot3d` from the angles' cosines and sines, so that a caller
    may compute them once per frame (the marching kernel reads them from its
    table)."""
    y1 = cx * p.y + sx * p.z
    z1 = -sx * p.y + cx * p.z
    x2 = cy * p.x - sy * z1
    z2 = sy * p.x + cy * z1
    x3 = cz * x2 + sz * y1
    y3 = -sz * x2 + cz * y1
    return Vec3(x3, y3, z2)


def rot3d(p: Vec3, rot: Vec3) -> Vec3:
    """Euler XYZ rotation in the reference's column-major mat3 arrangement,
    X then Y then Z (shapes.glsl:34-68)."""
    return rot3d_cs(p, torch.cos(rot.x), torch.sin(rot.x), torch.cos(rot.y),
                    torch.sin(rot.y), torch.cos(rot.z), torch.sin(rot.z))


# -- CSG combines over (d, idx) hits ---------------------------------------


def op_union(d1, i1, d2, i2):
    """Nearer hit; a tie keeps (d2, i2) (shapes.glsl:72-74)."""
    take1 = d1 < d2
    return torch.where(take1, d1, d2), torch.where(take1, i1, i2)


def op_subtraction(d1, i1, d2, i2):
    """max(-d1, d2); a tie keeps the negated first hit (shapes.glsl:76-81)."""
    nd1 = -d1
    take1 = nd1 >= d2
    return torch.where(take1, nd1, d2), torch.where(take1, i1, i2)


def op_smooth_union(d1, i1, d2, i2, k):
    """Quadratic smooth-min; the id of the side that dominates the blend.
    ``k`` may be a Python number (the CSG program's table): the division is
    a true one on every device (``div_exact``)."""
    h = torch.clamp(0.5 + div_exact(0.5 * (d2 - d1), k), 0.0, 1.0)
    d = d2 * (1.0 - h) + d1 * h - k * h * (1.0 - h)
    return d, torch.where(h > 0.5, i1, i2)


def combine(op: int, d1, i1, d2, i2, index: int, k=None):
    """Fold child hit 2 into accumulator 1 the reference's way: ``index ==
    0`` assigns (containers.rs:244-252), later children combine with the
    node's op.  Unlike the JAX ``combine`` it also takes the smooth union,
    which the JAX package folds in ``render/scenegen.py:_combine``."""
    if index == 0:
        return d2, i2
    if op == OP_UNION:
        return op_union(d1, i1, d2, i2)
    if op == OP_SUBTRACTION:
        return op_subtraction(d1, i1, d2, i2)
    if op == OP_SMOOTH_UNION:
        return op_smooth_union(d1, i1, d2, i2, k)
    raise ValueError(f"unknown CSG op {op}")
