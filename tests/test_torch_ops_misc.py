"""Port parity: the helpers carried over with the app/io surface
(``ops/tonemap.py:srgb_to_linear`` and ``gamma_encode``,
``ops/aabb.py:aabb_from_pos_size``, ``ops/sdf.py:move``,
``app/config.py:Constants``) against the JAX package
(tests/test_ops_misc.py), and the five ``__all__`` lists of the package's
``__init__`` modules against the JAX package's.

The helpers are held to JAX on seeded inputs: ``move`` and
``aabb_from_pos_size`` bit for bit (one rounding each), the tonemap curves
within 1e-6 (``pow`` is not correctly rounded in either library).
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compute_path_tracer_tpu.app import config as j_config
from compute_path_tracer_tpu.ops import aabb as j_aabb
from compute_path_tracer_tpu.ops import sdf as j_sdf
from compute_path_tracer_tpu.ops import tonemap as j_tonemap
from compute_path_tracer_tpu.vecmath import Vec3 as JVec3
from compute_path_tracer_tpu_torch.app import config
from compute_path_tracer_tpu_torch.ops import aabb, sdf, tonemap
from compute_path_tracer_tpu_torch.vecmath import Vec3

TONE_TOL = 1e-6


def _vecs(seed, lo, hi, n=257):
    a = np.random.default_rng(seed).uniform(lo, hi, (3, n)).astype(np.float32)
    return Vec3(*map(torch.from_numpy, a)), JVec3(*map(jnp.asarray, a))


def _eq(port, ref, tol=0.0):
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=0, atol=tol)


def test_move_and_aabb_from_pos_size_match_jax():
    (p, jp), (b, jb) = _vecs(0, -5, 5), _vecs(1, 0, 3)
    _eq(sdf.move(p, b), j_sdf.move(jp, jb))
    for got, want in zip(aabb.aabb_from_pos_size(p, b),
                         j_aabb.aabb_from_pos_size(jp, jb)):
        _eq(got, want)
    bmin, bmax = aabb.aabb_from_pos_size(Vec3.splat(torch.zeros(())),
                                         Vec3.splat(torch.ones(())))
    tn, tf = aabb.intersect_aabb(Vec3.splat(torch.tensor(-5.0)),
                                 Vec3(torch.tensor(0.0), torch.tensor(0.0),
                                      torch.tensor(1.0)), bmin, bmax)
    assert bool(aabb.aabb_hit(tn, tf)) is False  # the ray starts off-axis


@pytest.mark.parametrize("gamma", [2.2, 1.8])
def test_gamma_encode_matches_jax(gamma):
    c, jc = _vecs(2, -0.5, 2.0)
    _eq(tonemap.gamma_encode(c, gamma), j_tonemap.gamma_encode(jc, gamma),
        TONE_TOL)
    one = tonemap.gamma_encode(Vec3.splat(torch.tensor([0.25])), 2.2)
    assert np.isclose(float(one.x), 0.25 ** (1 / 2.2), atol=1e-6)


def test_srgb_to_linear_matches_jax_and_round_trips():
    c, jc = _vecs(3, -0.5, 1.5)
    _eq(tonemap.srgb_to_linear(c), j_tonemap.srgb_to_linear(jc), TONE_TOL)
    vals = torch.linspace(0, 1, 64)
    rt = tonemap.srgb_to_linear(tonemap.linear_to_srgb(Vec3(vals, vals, vals)))
    np.testing.assert_allclose(rt.x.numpy(), vals.numpy(), atol=1e-5)


def test_constants_match_jax():
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(config.Constants) == fields(j_config.Constants)
    assert config.Constants(frame=3).last_clear == 0


# Each package module's __all__ is the JAX module's with these names
# absent (ROADMAP queue 1: item 14 drops the XLA SoA lane; the Orbax pair
# is the torch.save pair here) and these added.
ABSENT = {
    "render": {"build_soa_plan", "render_frame_soa", "render_pixels_soa"},
    "io": {"save_checkpoint_orbax", "load_checkpoint_orbax"},
}
ADDED = {"io": {"save_checkpoint_torch", "load_checkpoint_torch"}}


@pytest.mark.parametrize("sub", ["", "render", "ops", "io", "app"])
def test_all_lists_match_jax(sub):
    suffix = f".{sub}" if sub else ""
    port = importlib.import_module("compute_path_tracer_tpu_torch" + suffix)
    ref = importlib.import_module("compute_path_tracer_tpu" + suffix)
    assert len(port.__all__) == len(set(port.__all__))
    assert (set(port.__all__) - ADDED.get(sub, set())
            == set(ref.__all__) - ABSENT.get(sub, set()))
    for name in port.__all__:
        assert getattr(port, name) is not None


def test_top_level_render_frame():
    from compute_path_tracer_tpu_torch import compile_scene, render_frame
    from compute_path_tracer_tpu_torch.scene import sphere_and_plane

    cs = compile_scene(sphere_and_plane())
    img = render_frame(cs.spec, torch.from_numpy(cs.params), width=8,
                       height=8, bounces=1)
    assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
