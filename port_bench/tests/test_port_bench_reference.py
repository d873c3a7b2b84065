"""The reference's parts on the CPU: the flat-union map bit for bit the
frozen one, the running mean, and the work count."""

import numpy as np
import torch

from port_bench.reference import count, render_check, tcull
from port_bench.reference.fastmap import make_flat_map
from port_bench.reference.tracer.render.baked import bake, make_map_baked
from port_bench.reference.tracer.vecmath import Vec3

SCENE = {"n_prims": 64, "seed": 7}


def test_flat_map_is_the_frozen_map_bit_for_bit():
    spec, p0 = render_check.scene_state(SCENE)
    _, p1 = render_check.scene_state(SCENE, {3: (0.1, 0.2, 3.3),
                                             10: (1.0, 1.0, 1.0)})
    leaves = tcull.boxed_leaves(spec)
    column = {leaf[0]: j for j, leaf in enumerate(leaves)}
    flat, frozen = make_flat_map(spec, column), make_map_baked(spec)
    g = torch.Generator().manual_seed(0)
    n = 4096
    p = Vec3(*(torch.randn(n, generator=g) * 3 + c for c in (0.0, 0.0, 3.0)))
    active = torch.rand(n, len(leaves), generator=g) < 0.7
    guards = tuple(active[:, column[s]] if s in column else None
                   for s in range(spec.n_shapes))
    bv0, bv1 = bake(spec, torch.tensor(p0)), bake(spec, torch.tensor(p1))
    per_point = torch.stack([bv0, bv1], 1)[:, torch.randint(0, 2, (n,),
                                                           generator=g)]
    for bv in (bv0, per_point):
        d, i = flat(p, bv, active)
        d0, i0 = frozen(p, bv, guards)
        assert torch.equal(d, d0) and torch.equal(i, i0)


def test_running_mean_rounds_as_the_renderer():
    s = np.random.default_rng(0).random((5, 7, 3)).astype(np.float32)
    acc = np.zeros((5, 3), np.float32)
    for f in range(7):
        w = np.float32(1) / np.float32(f + 1)
        acc = acc * (np.float32(1) - w) + s[:, f] * w
    assert np.array_equal(render_check.running_mean(s), acc)
    assert np.allclose(render_check.running_mean(s), s.mean(1), rtol=1e-5)


def test_rel_l1():
    assert render_check.rel_l1([1.0, 2.0], [1.0, 2.0]) == 0.0
    assert render_check.rel_l1([1.5, 2.0], [1.0, 2.0]) == 0.5 / 3.0
    assert render_check.rel_l1([np.nan, 2.0], [1.0, 2.0]) == float("inf")


def test_the_count_tallies_segments_taps_and_leaves():
    spec, params = render_check.scene_state(SCENE)
    tally = {}
    xs = np.arange(8)
    render_check.trace_samples(
        spec, [params], xs, np.full_like(xs, 9), np.zeros_like(xs),
        np.zeros_like(xs), width=16, height=18, bounces=1, fov=1.0,
        device="cpu", options={"geometry": "baked", "t_cull": True},
        count=tally)
    assert tally["segments"] >= 8
    assert tally["taps"] >= 8
    # Every tap evaluates the three guard-less leaves (ground, two lamps).
    assert int(tally[("leaves", 2)]) == tally["taps"]
    ops = count.march_ops(tally, spec)
    n_boxed = len(tcull.boxed_leaves(spec))
    assert ops > tally["segments"] * n_boxed * count.SLAB_OPS
