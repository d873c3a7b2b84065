"""Port parity: the over-relaxed march (``omega`` != 1) and debug 4's
statistics on the per-warp walk of the CSG program
(kernels/csrc/csg_program.cuh:march_relax_walk, march_stats_walk).

Both kernels walk, per warp of 32 lanes, the list of the program's records
that the warp's live lanes can need (``render/program.py:warp_records``,
``make_map_program(..., records=)``), as K2's plain march does
(tests/test_torch_warp_walk.py).  On csg_demo (subtraction), blend_demo
(smooth union), the first-shape clobber scene and ``benchmark_scene(64)``,
on primary and scattered rays with lanes that are not live and a partial
warp, these tests hold:

* (a) ``cast_tcull(..., omega=1.6)`` through each warp's list to the march
  of the full walk, bit for bit in t and idx, with reverts among its steps,
  and the list's map at the march's own taps to the JAX package's map under
  the same guards: ids equal, distances to 1e-5;
* (b) the relaxed march's nearest culled entry kept across steps, the
  kernel's rule (recomputed unless tp <= t < m_p), against the per-step
  minimum that ``cast_tcull`` takes, at every step, reverts and steps whose
  clamp is MHD (rays started half MHD before an entry) included;
* (c) debug 4's statistics (``MarchStats``) restricted to each warp's list
  equal, in all three channels, to those of the full walk, and no shape off
  a warp's list ever active for a marching lane or a lane taking the normal
  taps: baked and faithful t_cull, ``analytic_unboxed``, and faithful
  without t_cull;
* the wrapper's checks: the over-relaxed march and debug 4 raise, as the
  plain march does, for a program a block cannot hold.

The kernels run on the card; chip_smoke.py holds their frames and debug 4
to the plain versions there."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compute_path_tracer_tpu.vecmath import Vec3 as JVec3
from compute_path_tracer_tpu_torch.constants import BIG, FP, MHD, STEPS
from compute_path_tracer_tpu_torch.kernels import megakernel as mk
from compute_path_tracer_tpu_torch.render import program as tp
from compute_path_tracer_tpu_torch.render.baked import baked_layout
from compute_path_tracer_tpu_torch.render.reference import take_lanes
from compute_path_tracer_tpu_torch.scene import params_from_numpy
from compute_path_tracer_tpu_torch.vecmath import Vec3 as TVec3
from test_torch_warp_walk import _jax_map, _pair, _primary, _shape_checks

SCENES = ["csg_demo", "blend_demo", "clobber", "benchmark_64"]
OMEGA = 1.6
N_RAYS = 3 * 97        # 10 warps of 32 consecutive rays, the last one partial
DEAD = 0.2             # share of lanes that are not live
JAX_TAPS = 3000        # taps per case held to the JAX map


def _scattered(n=N_RAYS, seed=11):
    """Rays with origins in [-4, 4]^3 and uniform directions, and the warp
    of each (32 consecutive rays)."""
    r = np.random.default_rng(seed)
    ro = r.uniform(-4, 4, (3, n)).astype(np.float32)
    d = r.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return (TVec3(*map(torch.from_numpy, ro)), TVec3(*map(torch.from_numpy, d)),
            torch.arange(n) // 32)


def _setup(name, geometry, unboxed=False):
    jc, tc = _pair(name)
    params = params_from_numpy(tc.params, tc.spec, "cpu")
    prog = tp.build_program(tc.spec, geometry, unboxed)
    return jc, tc, params, prog, tp.program_table(prog, params, True)


def _rays(tc):
    ro, rd, warp = _primary(tc)
    yield ro, rd, warp
    yield _scattered()


def _sel(v, rows):
    return TVec3(*(c[rows] for c in v))


def _near_entry(prog, table, ro, rd):
    """The rays that have a culled interval entry ahead, moved on to half
    MHD before it: their first step's clamp is MHD."""
    checks, _ = tp.program_bounds(prog, table, ro, rd, True)
    m = _next_entry(prog, checks, torch.full_like(ro.x, MHD))
    ok = torch.nonzero(m < FP).flatten()
    s = m[ok] - 0.5 * MHD
    return _sel(ro, ok) + _sel(rd, ok) * s, _sel(rd, ok)


def _next_entry(prog, checks, t):
    """The nearest culled interval entry strictly ahead of t per ray, BIG
    when none (csg_program.cuh:next_entry; cast_tcull's per-step m)."""
    chk, lo, _ = checks
    if not chk.shape[1]:
        return torch.full_like(t, BIG)
    cull = torch.from_numpy(prog.box_cull != 0)
    return torch.where(chk & cull & (lo > t[:, None]), lo,
                       torch.full_like(lo, BIG)).amin(1)


def relax_kept_entry(prog, map_fn, ro, rd, checks, omega, t_cap=None):
    """``cast_tcull``'s over-relaxed march, step for step, with the nearest
    entry ``m`` kept across steps as march_relax_walk keeps it: after each
    step, ``m = m_p`` where ``tp <= t < m_p`` (``tp``, ``m_p``: the t and m
    of the last sample that did not revert) and the entry recomputed
    elsewhere.  At every step the kept ``m`` must equal the per-step
    minimum.  Returns (t, idx, {"steps", "reverts", "floored", "kept"}):
    "floored" counts the steps whose clamp is MHD (the nearest entry less
    than MHD ahead), "kept" the steps that reused m_p."""
    om = float(np.float32(omega))
    n = ro.x.shape[0]
    t = torch.zeros(n)
    idx = torch.full((n,), -1, dtype=torch.int32)
    tp, dp, sp, fp = (torch.zeros(n) for _ in range(4))
    m = _next_entry(prog, checks, t)
    mp = m.clone()
    live = torch.ones(n, dtype=torch.bool)
    tally = dict(steps=0, reverts=0, floored=0, kept=0)
    cull = torch.from_numpy(prog.box_cull != 0)
    chk, lo, hi = checks
    for _ in range(STEPS):
        rows = torch.nonzero(live).flatten()
        if rows.numel() == 0:
            break
        lt = t[rows]
        assert torch.equal(m[rows], _next_entry(prog, take_lanes(checks, rows),
                                                lt))
        tt = lt[:, None]
        active = chk[rows] & (~cull | ((lo[rows] <= tt) & (hi[rows] >= tt)))
        d, mi = map_fn(_sel(ro, rows) + _sel(rd, rows) * lt, active)
        ad = torch.abs(d)
        clamp = torch.clamp(m[rows] - lt, min=MHD)
        exact = torch.minimum(ad, clamp)
        over = (dp[rows] > 0.0) & (sp[rows] > dp[rows] + d)
        step = torch.where(d > 0.0, torch.minimum(om * ad, clamp), exact)
        nt = torch.where(over, tp[rows] + fp[rows], lt + step)
        hit = ~over & (ad < MHD)
        if t_cap is not None:
            nt = torch.minimum(nt, t_cap[rows])
        far = nt > FP
        idx[rows] = torch.where(far, torch.full_like(mi, -1), mi)
        tally["steps"] += rows.numel()
        tally["reverts"] += int(over.sum())
        tally["floored"] += int((m[rows] - lt < MHD).sum())
        tp[rows] = torch.where(over, tp[rows], lt)
        dp[rows] = torch.where(over, dp[rows], d)
        sp[rows] = torch.where(over, fp[rows], step)
        fp[rows] = torch.where(over, fp[rows], exact)
        mp[rows] = torch.where(over, mp[rows], m[rows])
        t[rows] = nt
        done = hit | far
        if t_cap is not None:
            done = done | (nt >= t_cap[rows])
        live[rows[done]] = False
        rest = rows[~done]
        kept = (tp[rest] <= t[rest]) & (t[rest] < mp[rest])
        tally["kept"] += int(kept.sum())
        m[rest] = torch.where(kept, mp[rest], _next_entry(
            prog, take_lanes(checks, rest), t[rest]))
    return t, idx, tally


CASES = [("csg_demo", "baked"), ("csg_demo", "faithful"), ("blend_demo", "baked"),
         ("clobber", "faithful"), ("benchmark_64", "baked")]


@pytest.mark.parametrize("name,geometry", CASES)
def test_relaxed_march_through_warp_lists(name, geometry):
    """(a): the over-relaxed march through each warp's list is the march
    of the full walk bit for bit, and its taps agree with the JAX map."""
    jc, tc, _, prog, table = _setup(name, geometry)
    vals = table.tolist()
    full = tp.make_map_program(prog, vals)
    jmap = _jax_map(jc, geometry)
    live_rng = np.random.default_rng(5)
    taps, reverts = [], 0
    for ro, rd, warp in _rays(tc):
        checks, _ = tp.program_bounds(prog, table, ro, rd, True)
        live = torch.from_numpy(live_rng.random(warp.shape[0]) >= DEAD)
        lists = tp.warp_records(prog, checks[0][live], warp[live],
                                int(warp.max()) + 1)
        t_full, i_full = tp.cast_tcull(prog, full, ro, rd, checks, omega=OMEGA)
        t_m, i_m, tally = relax_kept_entry(prog, full, ro, rd, checks, OMEGA)
        assert torch.equal(t_m, t_full) and torch.equal(i_m, i_full)
        reverts += tally["reverts"]
        for w in torch.unique(warp[live]).tolist():
            rows = torch.nonzero((warp == w) & live).flatten()
            walk = tp.make_map_program(prog, vals,
                                       records=torch.nonzero(lists[w]).flatten())

            def tapped(p, guard, walk=walk):
                d, i = walk(p, guard)
                taps.append((p, guard, d, i))
                return d, i

            t_w, i_w = tp.cast_tcull(prog, tapped, _sel(ro, rows), _sel(rd, rows),
                                     take_lanes(checks, rows), omega=OMEGA)
            assert torch.equal(t_w, t_full[rows])
            assert torch.equal(i_w, i_full[rows])
    assert reverts > 0
    p = TVec3(*(torch.cat([tap[0][k] for tap in taps]) for k in range(3)))
    guard, d, i = (torch.cat([tap[k] for tap in taps]) for k in (1, 2, 3))
    pick = torch.from_numpy(np.random.default_rng(2).permutation(
        d.shape[0])[:JAX_TAPS])
    dj, ij = jmap(JVec3(*(jnp.asarray(c[pick].numpy()) for c in p)),
                  _shape_checks(prog, guard[pick]))
    np.testing.assert_allclose(d[pick].numpy(), np.asarray(dj), rtol=0,
                               atol=1e-5)
    assert np.array_equal(i[pick].numpy(), np.asarray(ij))


@pytest.mark.parametrize("name,omega", [(name, OMEGA) for name in SCENES]
                         + [("csg_demo", 0.7), ("csg_demo", 2.5)])
def test_kept_entry_model(name, omega):
    """(b): the kept entry is the per-step minimum at every step of the
    relaxed march, after reverts and MHD-floored clamps too (checked inside
    ``relax_kept_entry``), with and without the closed-form cap of
    ``analytic_unboxed``; the march it gives is cast_tcull's.  (The entries
    are the guards', the same in both geometries.)"""
    total = dict(steps=0, reverts=0, floored=0, kept=0)
    for unboxed in (False, True):
        _, tc, _, prog, table = _setup(name, "baked", unboxed)
        t_cap = None
        if unboxed:
            if not prog.caps.shape[0]:
                continue
            cap_fn = mk.make_analytic_unboxed(prog.spec)[0]
            bv = table[:baked_layout(prog.spec).n_slots]
        map_fn = tp.make_map_program(prog, table.tolist())
        rays = [r[:2] for r in _rays(tc)]
        rays.append(_near_entry(prog, table, *rays[1]))
        for ro, rd in rays:
            checks, _ = tp.program_bounds(prog, table, ro, rd, True)
            if unboxed:
                t_cap = cap_fn(ro, rd, bv)[0]
            t, idx, tally = relax_kept_entry(prog, map_fn, ro, rd, checks,
                                             omega, t_cap)
            t_ref, i_ref = tp.cast_tcull(prog, map_fn, ro, rd, checks, t_cap,
                                         omega)
            assert torch.equal(t, t_ref) and torch.equal(idx, i_ref)
            for k in total:
                total[k] += tally[k]
    assert total["kept"] > 0
    if prog.box_cull.any():
        assert total["floored"] > 0
    if omega > 1.0:
        assert total["reverts"] > 0


class ListStats(mk.MarchStats):
    """``MarchStats`` whose march and normal-tap counts see only the
    shapes on each warp's list of the bounce (the boxes some lane alive at
    the bounce hits); fails if a marching lane or a lane taking the normal
    taps evaluates a shape off its warp's list."""

    def lists(self, check) -> None:
        super().lists(check)
        groups, inv = torch.unique(self.gid[self.lanes], return_inverse=True)
        hit = torch.zeros((groups.shape[0], check.shape[1]), dtype=torch.int32
                          ).index_add_(0, inv, check.int()) > 0
        self.listed = hit[inv]
        self.checked = getattr(self, "checked", 0) + int(check.sum())

    def march(self, live, active) -> None:
        assert not (active & ~self.listed[live]).any()
        super().march(live, active & self.listed[live])

    def taps(self, sel, guard) -> None:
        assert not (guard & ~self.listed[sel]).any()
        super().taps(sel, guard & self.listed[sel])


STATS_MODES = {
    "baked_tcull": dict(geometry="baked", t_cull=True),
    "unboxed": dict(geometry="baked", t_cull=True, analytic_unboxed=True),
    "faithful_tcull": dict(geometry="faithful", t_cull=True),
    "faithful_exact": dict(geometry="faithful", t_cull=False),
}


@pytest.mark.parametrize("name,mode", [(name, mode) for name in ("csg_demo", "clobber")
                                       for mode in STATS_MODES]
                         + [("benchmark_64", "baked_tcull"), ("benchmark_64", "unboxed")])
def test_stats_through_warp_lists(name, mode):
    """(c): debug 4's three channels over each warp's list equal those of
    the full walk, on a 36x10 frame (partial warps at its right edge)."""
    _, tc, params, _, _ = _setup(name, "baked")
    kw = dict(width=36, height=10, bounces=2, debug=4, **STATS_MODES[mode])
    full, listed = mk.MarchStats(), ListStats()
    img = mk.render_frame_megakernel_plain(tc.spec, params, None, 0, 0,
                                           stats=full, **kw)
    img_l = mk.render_frame_megakernel_plain(tc.spec, params, None, 0, 0,
                                             stats=listed, **kw)
    assert torch.equal(img_l, img)
    assert torch.equal(listed.lanes_xyz, full.lanes_xyz)
    assert int(img[..., 2].sum()) > 0 and listed.checked > 0
    if STATS_MODES[mode]["t_cull"]:
        assert int(img[..., 0].sum()) > 0 and int(img[..., 1].sum()) > 0


@pytest.mark.parametrize("kw", [dict(omega=OMEGA, debug=0),
                                dict(omega=OMEGA, debug=3), dict(debug=4)],
                         ids=["omega_debug0", "omega_debug3", "debug4"])
def test_oversize_program_raises(kw):
    """The over-relaxed march and debug 4 size the block's shared memory as
    the plain march does, and raise, naming the sizes, for a program a
    block cannot hold; walk_stats is for debug 0 and 3 only."""
    prog = tp.build_program(_pair("benchmark_64")[1].spec, "baked")
    big = dataclasses.replace(prog, ops=np.zeros((3000, tp.OP_WIDTH), np.int32))
    args = dict(frame=0, last_clear=0, bounces=1, fov=1.0, aspect=1.0,
                t_cull=True, **kw)
    accum = torch.zeros((4, 4, 3))
    with pytest.raises(ValueError, match="3000 op records"):
        mk.launch_march(big, torch.zeros(prog.f_len), accum, **args)
    walk = torch.zeros(4, dtype=torch.int64)
    if kw["debug"] == 4:
        with pytest.raises(ValueError, match="walk_stats needs debug 0 or 3"):
            mk.launch_march(prog, torch.zeros(prog.f_len), accum,
                            walk_stats=walk, **args)
