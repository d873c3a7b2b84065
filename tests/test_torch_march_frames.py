"""Port parity: more marching frames against JAX ``render_frame`` (64x32,
2 bounces), under the contracts stated in tests/test_torch_march.py: the
subtraction, smooth-union, refraction, clobber and JSON-map scenes in both
geometries, across the debug modes.  A separate file, so that the test
runner's workers compile these JAX frames beside the ones there."""

import pytest

from test_torch_march import check_against_jax

CASES = [
    ("csg_demo", "baked", 0), ("csg_demo", "faithful", 1),
    ("csg_demo", "faithful", 2), ("blend_demo", "baked", 0),
    ("blend_demo", "baked", 1), ("blend_demo", "faithful", 2),
    ("glass_demo", "faithful", 1), ("clobber", "faithful", 2),
    ("benchmark_16", "baked", 2),
    ("map_csg_demo", "faithful", 2), ("map_csg_demo", "baked", 1),
    ("sphere_and_plane", "baked", 1), ("sphere_and_plane", "faithful", 2),
]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_frame_matches_jax(case):
    check_against_jax(*case)
