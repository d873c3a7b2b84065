"""Structure-of-arrays 3-vector math on torch tensors.

A ``vec3`` is three separate tensors, one per component, as in the JAX
package's ``vecmath.py``: every operation below evaluates its components in
the same order as the JAX version, so the two agree to rounding.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch


def sqrt_rn(x):
    """Correctly rounded float32 square root.

    torch's vectorized CPU ``sqrt`` can be an ulp off; the float64 root
    rounded to float32 is the correctly rounded float32 root (float64 has
    more than 2*24+2 bits), which is what XLA and the CUDA kernel compute.
    """
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


class Vec3(NamedTuple):
    """A vec3 held as three structure-of-arrays components."""

    x: Any
    y: Any
    z: Any

    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    def dot(self, o: "Vec3"):
        return self.x * o.x + self.y * o.y + self.z * o.z

    def length(self):
        return sqrt_rn(self.dot(self))

    def length_safe(self):
        """Length that is 0 at the 0-vector (the JAX version's
        gradient-safe form; the forward value is the plain length)."""
        l2 = self.dot(self)
        pos = l2 > 0.0
        return torch.where(pos, sqrt_rn(torch.where(pos, l2, torch.ones_like(l2))),
                           torch.zeros_like(l2))

    def abs(self):
        return Vec3(torch.abs(self.x), torch.abs(self.y), torch.abs(self.z))

    def normalize(self):
        """GLSL ``normalize``: divides by the length (0-vector -> nan/inf)."""
        return self / self.length()

    def normalize_safe(self):
        """Zero-vector-safe normalize: ``x * (1/sqrt(l2))``, 0 for the
        0-vector.  The reciprocal is a true divide of a correctly rounded
        sqrt, as in the JAX version (not an approximate rsqrt)."""
        l2 = self.dot(self)
        pos = l2 > 0.0
        one = torch.ones_like(l2)
        inv = torch.where(pos, 1.0 / sqrt_rn(torch.where(pos, l2, one)),
                          torch.zeros_like(l2))
        return self * inv

    def max_component(self):
        return torch.maximum(self.x, torch.maximum(self.y, self.z))

    def min_component(self):
        return torch.minimum(self.x, torch.minimum(self.y, self.z))

    @staticmethod
    def splat(v):
        return Vec3(v, v, v)

    def stack(self, dim=-1):
        """Pack into a conventional (..., 3) tensor (I/O boundary only)."""
        return torch.stack([self.x, self.y, self.z], dim=dim)

    @staticmethod
    def from_stacked(a, dim=-1):
        x, y, z = torch.unbind(a, dim=dim)
        return Vec3(x, y, z)


def vmin(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(torch.minimum(a.x, b.x), torch.minimum(a.y, b.y),
                torch.minimum(a.z, b.z))


def vmax(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(torch.maximum(a.x, b.x), torch.maximum(a.y, b.y),
                torch.maximum(a.z, b.z))


def mix(a, b, t):
    """GLSL ``mix`` = a*(1-t) + b*t."""
    return a * (1.0 - t) + b * t


def vmix(a: Vec3, b: Vec3, t) -> Vec3:
    return Vec3(mix(a.x, b.x, t), mix(a.y, b.y, t), mix(a.z, b.z, t))


def vwhere(c, a: Vec3, b: Vec3) -> Vec3:
    """Componentwise select with a shared boolean mask."""
    return Vec3(torch.where(c, a.x, b.x), torch.where(c, a.y, b.y),
                torch.where(c, a.z, b.z))


def clamp(v, lo, hi):
    return torch.clamp(v, lo, hi)


def vclamp(v: Vec3, lo, hi) -> Vec3:
    return Vec3(clamp(v.x, lo, hi), clamp(v.y, lo, hi), clamp(v.z, lo, hi))


def reflect(i: Vec3, n: Vec3) -> Vec3:
    """GLSL ``reflect(I, N)`` = I - 2*dot(N, I)*N."""
    d = n.dot(i)
    return i - n * (2.0 * d)
