"""Ray/AABB slab intersection used for per-shape culling (JAX package:
``ops/aabb.py``; reference aabb.glsl:13-33).

Division by a zero ray component yields +-inf as in GLSL; ``torch.minimum``
and ``torch.maximum`` propagate NaN (0/0 when a ray starts on a face it runs
along) exactly as ``jnp.minimum``/``jnp.maximum`` do, so such rays miss.
"""

from __future__ import annotations

from ..vecmath import Vec3, vmax, vmin


def aabb_from_pos_size(pos: Vec3, size: Vec3):
    """Box (min, max) = (pos - size, pos + size) (aabb.glsl:13-19)."""
    return pos - size, pos + size


def intersect_aabb(ro: Vec3, rd: Vec3, bmin: Vec3, bmax: Vec3):
    """Slab test; returns (t_near, t_far) (aabb.glsl:21-29)."""
    t_min = (bmin - ro) / rd
    t_max = (bmax - ro) / rd
    t1 = vmin(t_min, t_max)
    t2 = vmax(t_min, t_max)
    return t1.max_component(), t2.min_component()


def aabb_hit(t_near, t_far):
    """Hit iff the slab interval is non-empty and ends in front (aabb.glsl:31-33)."""
    return (t_near < t_far) & (t_far > 0.0)
