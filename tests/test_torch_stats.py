"""Port parity: debug 4, the march statistics (kernels/megakernel.py:
MarchStats), against the JAX package and against the work the plain march
does.

JAX's debug 4 (``render_frame_pallas(..., debug=4)``) counts per (8, 128)
tile, its lockstep unit, over its per-tile t-culled march; the port counts
per warp of K2 over its per-ray march.  So:

* the JAX anchor puts JAX's tile cull back into the plain march (the
  reference boxes' intervals reduced over the tile's live rays, the step
  clamped at the tile's nearest entry ahead) and groups by JAX's tile: x,
  the tile's march iterations over the bounce loop, then equals JAX's on
  every tile (benchmark_scene(16), 128x32, bounces 0 and 2);
* with group (1, 1) the three channels summed over the pixels are the plain
  march's own tallies: x its march taps, y its guarded-leaf evaluations in
  the march, z six times the shapes one normal tap evaluates; a warp's x
  and y are at least its lanes' largest.

chip_smoke.py holds K2's STATS kernel to the plain reducer bit for bit.
"""

from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compute_path_tracer_tpu.kernels.megakernel import render_frame_pallas
from compute_path_tracer_tpu.scene import compile_scene as j_compile
from compute_path_tracer_tpu.scene import library as j_lib
from compute_path_tracer_tpu_torch.constants import FP, MHD, STEPS
from compute_path_tracer_tpu_torch.kernels import megakernel as mk
from compute_path_tracer_tpu_torch.ops.aabb import intersect_aabb
from compute_path_tracer_tpu_torch.render.program import (
    build_program, program_table)
from compute_path_tracer_tpu_torch.scene import compile_scene as t_compile
from compute_path_tracer_tpu_torch.scene import convert_scene
from compute_path_tracer_tpu_torch.vecmath import Vec3

JTILE = (8, 128)
BIG = 4.0 * FP  # JAX's _BIG
MARCH = dict(geometry="baked", t_cull=True)


@lru_cache(maxsize=None)
def pair(name):
    scene = (j_lib.benchmark_scene(16) if name == "bench16"
             else getattr(j_lib, name)())
    return j_compile(scene), t_compile(convert_scene(scene))


def tile_cull_march(stats: mk.MarchStats, table):
    """A stand-in for ``cast_tcull`` with JAX's per-tile cull
    (``_march_while_tcull`` with ``_interval_scalars``): the rays of a
    bounce are grouped by ``stats``' group of their pixels; per group, a
    guarded shape is active while the group's live t-front overlaps the
    interval of its reference box over the group's rays, and the step is
    clamped at the group's nearest entry still ahead.  Returns (t, the last
    tap's id) and feeds ``record`` as ``cast_tcull`` does."""

    def cast(prog, map_fn, ro, rd, checks, t_cap=None, omega=1.0,
             record=None, refresh_every=1):
        assert t_cap is None and omega == 1.0 and refresh_every == 1
        chk = checks[0]
        n, nb = chk.shape
        boxes = table[prog.f_box:prog.f_sph].view(nb, 6)
        tn, tf = intersect_aabb(Vec3(*(c[:, None] for c in ro)),
                                Vec3(*(c[:, None] for c in rd)),
                                Vec3(*(boxes[:, k] for k in range(3))),
                                Vec3(*(boxes[:, k] for k in range(3, 6))))
        _, grp = torch.unique(stats.gid[stats.lanes], return_inverse=True)
        ng = int(grp.max()) + 1 if n else 0
        cols = grp[:, None].expand(-1, nb)
        any_h = torch.zeros((ng, nb)).index_add_(0, grp, chk.float()) > 0
        tn_min = torch.full((ng, nb), BIG).scatter_reduce(
            0, cols, torch.where(chk, torch.clamp(tn, min=0.0),
                                 torch.tensor(BIG)), "amin")
        tf_max = torch.full((ng, nb), -BIG).scatter_reduce(
            0, cols, torch.where(chk, tf, torch.tensor(-BIG)), "amax")
        t = torch.zeros(n)
        idx = torch.full((n,), -1, dtype=torch.int32)
        done = torch.zeros(n, dtype=torch.bool)
        for _ in range(STEPS):
            live = torch.nonzero(~done).flatten()
            if live.numel() == 0:
                break
            g, tl = grp[live], t[live]
            t_hi = torch.full((ng,), -BIG).scatter_reduce(0, g, tl, "amax")
            t_lo = torch.full((ng,), BIG).scatter_reduce(0, g, tl, "amin")
            ahead = tn_min > t_hi[:, None]
            act = any_h & ~ahead & (tf_max >= t_lo[:, None])
            m = torch.where(any_h & ahead, tn_min, torch.tensor(BIG)).amin(1)
            mask = chk[live] & act[g]
            if record is not None:
                record(live, mask)
            d, mi = map_fn(Vec3(*(o[live] + r[live] * tl
                                  for o, r in zip(ro, rd))), mask)
            ad = d.abs()
            nt = tl + torch.minimum(ad, torch.clamp(m[g] - tl, min=MHD))
            far = nt > FP
            t[live] = nt
            idx[live] = torch.where(far, torch.full_like(mi, -1), mi)
            done[live] = (ad < MHD) | far
        return t, idx

    return cast


def tile_cull_stats(monkeypatch, name, width, height, bounces, group=JTILE):
    """The port's debug 4 per ``group`` with JAX's tile cull in the march."""
    _, tc = pair(name)
    params = torch.from_numpy(tc.params)
    stats = mk.MarchStats(group)
    table = program_table(build_program(tc.spec, "baked"), params, True)
    monkeypatch.setattr(mk, "cast_tcull", tile_cull_march(stats, table))
    return mk.render_frame_megakernel_plain(
        tc.spec, params, width=width, height=height, bounces=bounces, debug=4,
        stats=stats, **MARCH).numpy()


@pytest.mark.parametrize("bounces", [0, 2])
def test_steps_match_jax_per_tile_under_its_cull(monkeypatch, bounces):
    jc, _ = pair("bench16")
    j = np.asarray(render_frame_pallas(
        jc.spec, jnp.asarray(jc.params), width=128, height=32, debug=4,
        bounces=bounces, tile=JTILE, interpret=True, **MARCH))
    t = tile_cull_stats(monkeypatch, "bench16", 128, 32, bounces)
    jx, tx = j[::8, ::128, 0], t[::8, ::128, 0]
    assert (jx > 0).all()
    np.testing.assert_array_equal(tx, jx)


def _frame(name, width=64, height=32, bounces=2, group=mk.WARP, **mode):
    _, tc = pair(name)
    return mk.render_frame_megakernel_plain(
        tc.spec, torch.from_numpy(tc.params), width=width, height=height,
        bounces=bounces, debug=4, stats=mk.MarchStats(group),
        **(mode or MARCH)).numpy()


def _tallied(monkeypatch, prog):
    """Tallies of the plain march's map taps and of the normal taps,
    taken by wrapping ``cast_tcull``'s map and ``calc_normal``."""
    tally = dict(taps=0, guarded=0, normal=0)
    march, normal = mk.cast_tcull, mk.calc_normal
    n_free = int(((prog.ops[:, 0] == 1) & (prog.ops[:, 3] < 0)).sum())

    def cast(prog_, map_fn, *a, **kw):
        def counted(p, guard):
            tally["taps"] += p.x.shape[0]
            tally["guarded"] += int(guard.sum())
            return map_fn(p, guard)
        return march(prog_, counted, *a, **kw)

    def calc(map_fn, p, checks):
        tally["normal"] += int(checks[0].sum()) + n_free * p.x.shape[0]
        return normal(map_fn, p, checks)

    monkeypatch.setattr(mk, "cast_tcull", cast)
    monkeypatch.setattr(mk, "calc_normal", calc)
    return tally


@pytest.mark.parametrize("unboxed", [False, True], ids=["march", "unboxed"])
def test_lane_sums_are_the_plain_march_tallies(monkeypatch, unboxed):
    _, tc = pair("bench16")
    prog = build_program(tc.spec, "baked", unboxed)
    tally = _tallied(monkeypatch, prog)
    img = _frame("bench16", group=(1, 1), analytic_unboxed=unboxed, **MARCH)
    sums = img.reshape(-1, 3).sum(0)
    assert tally["taps"] > 0 and tally["normal"] > 0
    assert sums.tolist() == [tally["taps"], tally["guarded"],
                             6 * tally["normal"]]


def test_warp_counts_cover_their_lanes():
    """A warp executes at least its busiest lane's iterations and shapes;
    every pixel of a warp holds the warp's numbers."""
    lane = _frame("bench16", group=(1, 1))
    warp = _frame("bench16")
    gh, gw = mk.WARP
    lanes = lane.reshape(32 // gh, gh, 64 // gw, gw, 3)
    warps = warp.reshape(32 // gh, gh, 64 // gw, gw, 3)
    assert (warps == warps[:, :1, :, :1]).all()
    most = lanes.max(axis=(1, 3))
    assert (warps[:, 0, :, 0, :2] >= most[..., :2]).all()
    # Lanes diverge, so some warp pays for more than its busiest lane.
    assert (warps[:, 0, :, 0, 1] > most[..., 1]).any()


def test_partial_warps():
    """A width that is not a multiple of 16 and a height that is odd: the
    last warps of a row hold fewer pixels, and their numbers cover them."""
    lane = _frame("bench16", width=40, height=21, group=(1, 1))
    warp = _frame("bench16", width=40, height=21)
    for gy in range(0, 21, 2):
        for gx in range(0, 40, 16):
            block = warp[gy:gy + 2, gx:gx + 16]
            assert (block == block[0, 0]).all()
            lanes = lane[gy:gy + 2, gx:gx + 16].reshape(-1, 3)
            assert (block[0, 0, :2] >= lanes[:, :2].max(0)).all()


@pytest.mark.parametrize("geometry", ["faithful", "baked"])
def test_no_tcull_counts_only_the_normal_taps(geometry):
    """x = y = 0 without t_cull, as JAX counts in its t-culled march only;
    z still counts the normal taps."""
    img = _frame("csg_demo", geometry=geometry)
    assert not img[..., :2].any() and img[..., 2].any()


def test_unboxed_caps_skip_the_normal_taps():
    """With analytic_unboxed the capped shapes leave the program and a
    capped hit takes no normal taps: less aux work than the full march."""
    full = _frame("bench16")
    capped = _frame("bench16", analytic_unboxed=True, **MARCH)
    assert capped[..., 2].sum() < full[..., 2].sum()


@pytest.mark.parametrize("kw", [dict(analytic_all=True),
                                dict(analytic_soa=True),
                                dict(dist_grid=True, t_cull=True)], ids=str)
def test_debug4_rejects_what_jax_rejects(kw):
    _, tc = pair("bench16")
    with pytest.raises(ValueError):
        mk.render_frame_megakernel(tc.spec, torch.from_numpy(tc.params),
                                   width=16, height=8, debug=4,
                                   geometry="baked", **kw)


def test_stats_and_frame_from_one_pass():
    """A MarchStats handed to a debug-0 frame fills as debug 4 does, and
    the frame is the plain debug-0 frame: one pass gives both."""
    _, tc = pair("bench16")
    pv = torch.from_numpy(tc.params)
    kw = dict(width=48, height=20, bounces=2, **MARCH)
    stats = mk.MarchStats()
    frame = mk.render_frame_megakernel_plain(tc.spec, pv, stats=stats, **kw)
    assert torch.equal(frame, mk.render_frame_megakernel_plain(tc.spec, pv,
                                                               **kw))
    assert torch.equal(stats.image(), mk.render_frame_megakernel_plain(
        tc.spec, pv, debug=4, **kw))
    assert stats.lanes_xyz.tolist() == mk.render_frame_megakernel_plain(
        tc.spec, pv, debug=4, stats=mk.MarchStats((1, 1)),
        **kw).reshape(-1, 3).sum(0).long().tolist()
