"""Per-pixel device math: SDFs and CSG combines, RNG, AABB slabs, camera,
tonemapping (JAX package: ``ops/``; reference shapes.glsl, rng.glsl,
aabb.glsl, funcs.glsl and the WGSL tonemap pass).  ``__all__`` is the JAX
package's."""

from .aabb import aabb_from_pos_size, aabb_hit, intersect_aabb
from .camera import calc_uv, primary_ray
from .rng import gen_rng, random_float01, random_unit_vector, wang_hash
from .sdf import (
    OP_SUBTRACTION,
    OP_UNION,
    combine,
    move,
    op_smooth_union,
    op_subtraction,
    op_union,
    rot3d,
    sd_cube,
    sd_octahedron,
    sd_plane,
    sd_sphere,
)
from .tonemap import (
    aces_film,
    color_correction,
    gamma_encode,
    linear_to_srgb,
    srgb_to_linear,
)

__all__ = [
    "aabb_from_pos_size",
    "aabb_hit",
    "intersect_aabb",
    "calc_uv",
    "primary_ray",
    "gen_rng",
    "random_float01",
    "random_unit_vector",
    "wang_hash",
    "OP_SUBTRACTION",
    "OP_UNION",
    "combine",
    "move",
    "op_smooth_union",
    "op_subtraction",
    "op_union",
    "rot3d",
    "sd_cube",
    "sd_octahedron",
    "sd_plane",
    "sd_sphere",
    "aces_film",
    "color_correction",
    "gamma_encode",
    "linear_to_srgb",
    "srgb_to_linear",
]
