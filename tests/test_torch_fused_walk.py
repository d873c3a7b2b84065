"""Port parity: the per-warp walk of the CSG program that the fused step's
kernel K4 and the distance-grid march K6 take (kernels/csrc/train_fused.cu,
megakernel_march.cu:megakernel_grid; csg_program.cuh:build_warp_list,
map_walk, march_grid_walk).

A warp of K4 is 2x16 pixels of the band its launch renders (16x8 blocks
tiling the band's own rows, ``kernels/train.py:band_warps``), a warp of K6
2x16 pixels of the frame (``megakernel.warp_ids``).  After each set of
guards a warp walks the list of the records its live lanes can need
(``render/program.py:warp_records``); the exclusion march of K4's secondary
edge term walks the list of the full program's leaves that are guard-less or
whose box some live lane hits (``kernels/train.py:_leaves(...,
records=)``).  On benchmark_scene(64), csg_demo (subtraction: K4's map-vjp
mode) and benchmark_scene(8) with ``analytic_unboxed`` (the scene of
tests/test_torch_train_unboxed_secondary.py: the march program lacks the
ground plane and the lamps, the exclusion march keeps them), these tests
hold:

* the edge term's closest approach (``_edge_closest``: d_min, t_min, id;
  after the exact march and from t = 0 as under ``analytic_all``) of a band
  of primary rays at a row offset, the right column of warps partial, and
  the exclusion march (``_excl_closest``: d2, t2, i2) of seeded scattered
  rays with a fifth of the lanes not live, and ``cast_grid``'s t and id of
  a frame's primary rays: each over every warp's list, against the same
  over the whole program, bit for bit on the live lanes;
* the same values against the JAX package on the same numpy inputs: every
  map tap the walked marches took against JAX's baked map (with
  ``skip_unboxed`` where the march program skips) at the same point under
  the same guards, and every fold the walked exclusion march took against
  JAX's leaf distances (``render/baked.py:_leaf_distance``) folded in walk
  order under the same guards and exclusions: ids equal, distances to 1e-5
  (XLA contracts multiply-adds, tests/test_torch_sdf.py).  The march
  outputs are those taps' values and positions; whole marches drift apart
  by more than that over dozens of steps (tests/test_torch_excl_closest.py
  holds them to JAX ``_make_excl_closest`` at 2e-5);
* ``fused_smem_bytes``, the shared memory of a K4 block (the warps' sums,
  then the staged program and the exclusion lists), against hand
  arithmetic, and its ``ValueError`` for a step a block cannot hold.

The kernels walk the lists on the card; chip_smoke.py holds their images,
frames and sums to the plain versions there, and
``benchmarks/kernel_ab.py`` to the kernels before the walk."""

import dataclasses
from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compute_path_tracer_tpu.render import baked as jb
from compute_path_tracer_tpu.scene import compile_scene as j_compile
from compute_path_tracer_tpu.scene import library as j_lib
from compute_path_tracer_tpu.vecmath import Vec3 as JVec3
from compute_path_tracer_tpu_torch.constants import BIG, DEFAULT_FOV
from compute_path_tracer_tpu_torch.kernels import megakernel as mk
from compute_path_tracer_tpu_torch.kernels import train as tm
from compute_path_tracer_tpu_torch.render import program as tp
from compute_path_tracer_tpu_torch.render.baked import analytic_eligible_ids
from compute_path_tracer_tpu_torch.render.baked import bake
from compute_path_tracer_tpu_torch.render.distgrid import make_dist_grid
from compute_path_tracer_tpu_torch.render.distgrid import make_grid_tap
from compute_path_tracer_tpu_torch.render.reference import camera_rays
from compute_path_tracer_tpu_torch.render.reference import take_lanes
from compute_path_tracer_tpu_torch.scene import compile_scene, convert_scene
from compute_path_tracer_tpu_torch.scene import params_from_numpy
from compute_path_tracer_tpu_torch.vecmath import Vec3 as TVec3

SCENES = ["benchmark_64", "csg_demo", "benchmark_8_unboxed"]
W, H = 40, 20           # the frame; K4's band is its rows ROW0 .. ROW0 + CROP
ROW0, CROP = 5, 6
N_EXCL = 192            # scattered rays of the exclusion march
DEAD = 0.2              # share of its lanes that are not live
D_TOL = 1e-5


@lru_cache(maxsize=None)
def _scene(name):
    """(jax compiled, torch compiled, torch params, march program, its
    table, the skipped shape ids)."""
    scene = (j_lib.benchmark_scene(int(name.split("_")[1]))
             if name.startswith("benchmark") else getattr(j_lib, name)())
    jc, tc = j_compile(scene), compile_scene(convert_scene(scene))
    params = params_from_numpy(tc.params, tc.spec, "cpu")
    unboxed = name.endswith("unboxed")
    prog = tp.build_program(tc.spec, "baked", unboxed)
    table = tp.program_table(prog, params, True)
    skipped = analytic_eligible_ids(tc.spec) if unboxed else frozenset()
    if unboxed:
        assert prog.caps.shape[0] == len(skipped) > 0
    return jc, tc, params, prog, table, skipped


def _rows(t, rows):
    return TVec3(*(c[rows] for c in t)) if isinstance(t, TVec3) else t[rows]


def _logged(map_fn, log):
    """``map_fn`` that appends each call's points, guards and results to
    ``log``."""
    def fn(p, guard):
        d, i = map_fn(p, guard)
        log.append((p, guard, d, i))
        return d, i
    return fn


def _per_warp(lists, warp, live, run):
    """``run(rows, records)`` for each warp with a live lane, on its live
    lanes and its list; the results scattered back by lane."""
    out = None
    for w in torch.unique(warp[live]).tolist():
        rows = torch.nonzero((warp == w) & live).flatten()
        res = run(rows, torch.nonzero(lists[w]).flatten())
        if out is None:
            out = [torch.full((warp.shape[0],), -7, dtype=r.dtype) for r in res]
        for o, r in zip(out, res):
            o[rows] = r
    return out


def _jvec(p):
    return JVec3(*(jnp.asarray(c.numpy()) for c in p))


def _check_taps_jax(jc, prog, skipped, log):
    """Every logged map tap against JAX's baked map at the same points (the
    shapes the march program skips left out as JAX ``skip_unboxed`` leaves
    them), each guarded shape under its guard column."""
    p = TVec3(*(torch.cat([e[0][k] for e in log]) for k in range(3)))
    guard = torch.cat([e[1] for e in log]).numpy()
    d = torch.cat([e[2] for e in log]).numpy()
    i = torch.cat([e[3] for e in log]).numpy()
    n = guard.shape[0]
    cols = [np.ones(n, bool)] * prog.n_shapes
    for op in prog.ops:
        if op[0] == tp.OPC_SHAPE and op[3] >= 0:
            cols[op[4]] = guard[:, op[3]]
    bv = jb.bake(jc.spec, jnp.asarray(jc.params, jnp.float32))
    dj, ij = jb.make_map_baked(jc.spec, skip_unboxed=bool(skipped))(
        _jvec(p), bv, tuple(jnp.asarray(c) for c in cols))
    assert n > 100
    np.testing.assert_array_equal(i, np.asarray(ij))
    np.testing.assert_allclose(d, np.asarray(dj), rtol=0, atol=D_TOL)


def _band_rays(tc):
    ys, xs = torch.meshgrid(torch.arange(ROW0, ROW0 + CROP, dtype=torch.int32),
                            torch.arange(W, dtype=torch.int32), indexing="ij")
    _, ro, rd = camera_rays(xs, ys, 0, DEFAULT_FOV, W / H, width=W, height=H)
    return ro, rd


@pytest.mark.parametrize("from_zero", [False, True],
                         ids=["exact_march", "analytic_all"])
@pytest.mark.parametrize("name", SCENES)
def test_edge_march_through_warp_lists(name, from_zero):
    jc, tc, params, prog, table, skipped = _scene(name)
    vals = table.tolist()
    ro, rd = _band_rays(tc)
    chk = tp.program_bounds(prog, table, ro, rd, False)[0][0]
    warp = tm.band_warps(W, CROP)
    assert int(warp.max()) + 1 == 3 * 3  # the last column of warps partial
    t_cap = None
    if skipped:
        cap_fn, _, _ = mk.make_analytic_unboxed(tc.spec)
        t_cap, _ = cap_fn(ro, rd, bake(tc.spec, params))
    full = tm._edge_closest(tp.make_map_program(prog, vals), ro, rd, chk,
                            t_cap, from_zero)
    every = torch.ones_like(warp, dtype=torch.bool)
    lists = tp.warp_records(prog, chk, warp)
    assert bool((lists.sum(1) < prog.ops.shape[0]).any())
    log = []

    def run(rows, rec):
        fn = _logged(tp.make_map_program(prog, vals, records=rec), log)
        return tm._edge_closest(fn, _rows(ro, rows), _rows(rd, rows),
                                chk[rows], None if t_cap is None
                                else t_cap[rows], from_zero)

    walked = _per_warp(lists, warp, every, run)
    for a, b in zip(walked, full):
        assert torch.equal(a, b)
    assert bool((full[2] >= 0).any()) and bool((full[0] < 0.5 * BIG).any())
    _check_taps_jax(jc, prog, skipped, log)


def _scattered(n, n_shapes, seed):
    r = np.random.default_rng(seed)
    ro = r.uniform(-3, 3, (3, n)).astype(np.float32)
    d = r.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    e1 = r.integers(-1, n_shapes, n).astype(np.int32)
    e2 = r.integers(-1, n_shapes, n).astype(np.int32)
    ts = r.uniform(0.5, 30.0, n).astype(np.float32)
    live = r.random(n) >= DEAD
    return (TVec3(*map(torch.from_numpy, ro)), TVec3(*map(torch.from_numpy, d)),
            *map(torch.from_numpy, (e1, e2, ts, live)))


@pytest.mark.parametrize("name", SCENES)
def test_exclusion_march_through_warp_lists(name, monkeypatch):
    jc, tc, params, prog, table, skipped = _scene(name)
    vals = table.tolist()
    full = tm._excl_program(tc.spec)
    ro, rd, e1, e2, ts, live = _scattered(N_EXCL, tc.spec.n_shapes, 7)
    # The kernel's guard words are the march program's; the full program
    # numbers its boxes alike (_excl_program checks it).
    chk = tp.program_bounds(prog, table, ro, rd, False)[0][0]
    warp = torch.arange(N_EXCL) // 32
    lists = tp.warp_records(full, chk[live], warp[live], int(warp.max()) + 1)
    lv = torch.nonzero(live).flatten()
    want = tm._excl_closest(tm._leaves(full, vals), _rows(ro, lv),
                            _rows(rd, lv), chk[lv], e1[lv], e2[lv], ts[lv])
    # The skipped shapes are in the exclusion march.
    assert skipped <= {leaf[3] for leaf in tm._leaves(full, vals)}
    log, fold = [], tm._excl_fold

    def logged(leaves, p, c, x1, x2, count=None):
        d, i = fold(leaves, p, c, x1, x2, count)
        log.append((leaves, p, c, x1, x2, d, i))
        return d, i

    def run(rows, rec):
        leaves = tm._leaves(full, vals, records=rec)
        assert len(leaves) <= tc.spec.n_shapes
        with monkeypatch.context() as m:
            m.setattr(tm, "_excl_fold", logged)
            return tm._excl_closest(leaves, _rows(ro, rows), _rows(rd, rows),
                                    chk[rows], e1[rows], e2[rows], ts[rows])

    walked = [w[lv] for w in _per_warp(lists, warp, live, run)]
    for a, b in zip(walked, want):
        assert torch.equal(a, b)
    assert bool((want[2] >= 0).any())

    # Each fold against JAX's leaf distances at its points, folded in walk
    # order over the warp's list, with the lane's exclusions and guards.
    shapes = {bs.shape_id: bs for bs in jb.baked_shapes_in_order(jc.spec)}
    order = [leaf[3] for leaf in tm._leaves(full, vals)]
    box = {leaf[3]: leaf[2] for leaf in tm._leaves(full, vals)}
    p = TVec3(*(torch.cat([e[1][k] for e in log]) for k in range(3)))
    n = p.x.shape[0]
    member = np.zeros((n, tc.spec.n_shapes), bool)
    at = 0
    for e in log:
        member[at:at + e[1].x.shape[0], [leaf[3] for leaf in e[0]]] = True
        at += e[1].x.shape[0]
    guard = torch.cat([e[2] for e in log]).numpy()
    x1, x2 = (torch.cat([e[k] for e in log]).numpy() for k in (3, 4))
    bv = jb.bake(jc.spec, jnp.asarray(jc.params, jnp.float32))
    jp = _jvec(p)
    dj, ij = np.full(n, BIG, np.float32), np.full(n, -1, np.int32)
    for sid in order:
        ld = np.asarray(jb._leaf_distance(shapes[sid], jp, bv))
        ok = member[:, sid] & (x1 != sid) & (x2 != sid)
        if box[sid] >= 0:
            ok &= guard[:, box[sid]]
        better = ok & (ld < dj)
        dj, ij = np.where(better, ld, dj), np.where(better, sid, ij)
    assert n > 100
    np.testing.assert_array_equal(torch.cat([e[6] for e in log]).numpy(), ij)
    np.testing.assert_allclose(torch.cat([e[5] for e in log]).numpy(), dj,
                               rtol=0, atol=D_TOL)


@pytest.mark.parametrize("name", SCENES)
def test_grid_march_through_warp_lists(name):
    jc, tc, params, prog, table, skipped = _scene(name)
    vals = table.tolist()
    bv = bake(tc.spec, params)
    grid = make_dist_grid(tc.spec, bv, (8, 8, 8))
    tap = make_grid_tap(tc.spec, grid, vals)
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.int32),
                            torch.arange(W, dtype=torch.int32), indexing="ij")
    _, ro, rd = camera_rays(xs, ys, 0, DEFAULT_FOV, W / H, width=W, height=H)
    warp = mk.warp_ids(xs, ys, W)
    checks, _ = tp.program_bounds(prog, table, ro, rd, True)
    t_cap = None
    if skipped:
        cap_fn, _, _ = mk.make_analytic_unboxed(tc.spec)
        t_cap, _ = cap_fn(ro, rd, bv)
    full_count, walk_count = {}, {}
    want = tp.cast_grid(prog, tp.make_map_program(prog, vals, full_count), ro,
                        rd, checks, tap, grid.tau, t_cap)
    lists = tp.warp_records(prog, checks[0], warp)
    log = []

    def run(rows, rec):
        fn = _logged(tp.make_map_program(prog, vals, walk_count, records=rec),
                     log)
        return tp.cast_grid(prog, fn, _rows(ro, rows), _rows(rd, rows),
                            take_lanes(checks, rows), tap, grid.tau,
                            None if t_cap is None else t_cap[rows])

    walked = _per_warp(lists, warp, torch.ones_like(warp, dtype=torch.bool),
                       run)
    for a, b in zip(walked, want):
        assert torch.equal(a, b)
    assert bool((want[1] >= 0).any())
    # The same taps and the same leaf evaluations: a record a list leaves
    # out fails every live lane's guard.
    assert {k: int(v) for k, v in walk_count.items()} == {
        k: int(v) for k, v in full_count.items()}
    _check_taps_jax(jc, prog, skipped, log)


# (analytic_all, edge_grad, edge_secondary) of the plain list model's cases.
MODEL_MODES = {"march": (False, False, False),
               "march_edge_secondary": (False, True, True),
               "analytic_all_edge_secondary": (True, True, True)}


@pytest.mark.parametrize("name,config", [
    (name, config) for name in SCENES for config in MODEL_MODES
    # analytic_all takes a union-only tree.
    if not (name == "csg_demo" and MODEL_MODES[config][0])])
def test_plain_list_model(name, config, monkeypatch):
    """``fused_planes_plain(walk_stats=)``, the plain model chip_smoke.py
    holds K4's per-warp list lengths to, over a band at a row offset whose
    blocks are partial: each row it adds is a per-warp count of the records
    (of the leaves, ``_leaves(..., records=)``, for the exclusion lists)
    that are unguarded or whose box some lane of the warp hits; the edge
    term counts every warp of the launch, the others the warps with a live
    lane."""
    jc, tc, params, prog, table, skipped = _scene(name)
    analytic, edge, secondary = MODEL_MODES[config]
    unboxed = bool(skipped) and not analytic
    mode = tm.FusedMode(1, not name.startswith("csg"), edge, secondary,
                        analytic, analytic_unboxed=unboxed)
    tables = tm.fused_tables(tc.spec, params, analytic, unboxed)
    target = torch.from_numpy(np.random.default_rng(5).random(
        (3, CROP, W)).astype(np.float32))
    calls, count_lists = [], tm._count_lists

    def logged(walk_stats, i, prog, check, warp, n_warps=None, shapes=False):
        calls.append((i, prog, check, warp, n_warps, shapes))
        count_lists(walk_stats, i, prog, check, warp, n_warps, shapes)

    monkeypatch.setattr(tm, "_count_lists", logged)
    ws = torch.zeros(6 * mode.b1, dtype=torch.int64)
    tm.fused_planes_plain(tables, target, 0, DEFAULT_FOV, W / H, ROW0,
                          width=W, height=H, mode=mode, walk_stats=ws)
    want = torch.zeros_like(ws)
    vals = tables.table.tolist()
    for i, lprog, check, warp, n_warps, shapes in calls:
        groups = range(n_warps) if n_warps else torch.unique(warp).tolist()
        for w in groups:
            hit = check[warp == w].any(0).tolist()
            rec = [r for r, op in enumerate(lprog.ops.tolist())
                   if op[0] != tp.OPC_SHAPE or op[3] < 0 or hit[op[3]]]
            want[2 * i] += (len(tm._leaves(lprog, vals, records=rec))
                            if shapes else len(rec))
            want[2 * i + 1] += 1
    assert torch.equal(ws, want)
    rows = ws.view(3, mode.b1, 2)
    # 3 columns of blocks, 1 row of them (6 of its 8 rows in the band): 12
    # warps, 9 with a pixel.
    assert int(rows[1, 0, 1]) == (12 if edge else 0)
    assert int(rows[0, 0, 1]) == (0 if analytic else 9)
    assert int(rows[2, 0].sum()) == 0
    assert bool((rows[2, 1:, 1] > 0).any()) == secondary


def test_fused_smem_bytes():
    """A K4 block: 4 warps' (n_shapes, n_acc) float32 sums; with the walk,
    from the next 16 bytes, the decoded program and 4 lists (16 bytes a
    record), the leaf table F[0, f_box) with up to 3 floats of alignment,
    and with the exclusion march 4 lists of n_shapes records."""
    for n in (64, 256):
        prog = tp.build_program(compile_scene(
            convert_scene(j_lib.benchmark_scene(n))).spec, "baked")
        s, n_ops = prog.n_shapes, prog.ops.shape[0]
        table = 16 * -(-(prog.f_box + 3) // 4)
        for n_acc in (0, 15, 28):
            sums = 4 * 4 * s * n_acc
            assert tp.fused_smem_bytes(prog, 4, n_acc, False, False) == sums
            walk = 16 * -(-sums // 16) + 16 * n_ops * 5 + table
            assert tp.fused_smem_bytes(prog, 4, n_acc, True, False) == walk
            assert (tp.fused_smem_bytes(prog, 4, n_acc, True, True)
                    == walk + 16 * 4 * s)
    prog = tp.build_program(compile_scene(
        convert_scene(j_lib.benchmark_scene(64))).spec, "baked")
    # 28 channels (winner mode): 28,672 bytes of sums, 8,816 of walk
    # (tests/test_torch_warp_walk.py), 4,096 of exclusion lists.
    assert tp.fused_smem_bytes(prog, tm.WARPS, 28, True, False) == 37488
    assert tp.fused_smem_bytes(prog, tm.WARPS, 28, True, True) == 41584


def test_fused_smem_raises():
    """A step a block cannot hold raises in fused_smem_bytes and in the
    wrapper, naming the sizes, before anything reaches a device."""
    jc, tc, params, prog, table, _ = _scene("benchmark_64")
    big = dataclasses.replace(prog, ops=np.zeros((3000, tp.OP_WIDTH), np.int32))
    with pytest.raises(ValueError, match=r"28 channels.*3000 op records.*"
                                         r"more than 232448"):
        tp.fused_smem_bytes(big, 4, 28, True, False)
    # The sums alone fit, and the analytic step without the edge term
    # stages nothing.
    assert tp.fused_smem_bytes(big, 4, 28, False, False) == 28672
    tables = tm.fused_tables(tc.spec, params)._replace(prog=big)
    target = torch.zeros((3, 4, 4))
    mode = tm.FusedMode(1, True, edge_grad=True)
    with pytest.raises(ValueError, match="3000 op records"):
        tm.launch_train_fused(tables, target, 0, 1.0, 1.0, 0, width=4,
                              height=4, mode=mode)
    mid = dataclasses.replace(prog, ops=np.zeros((900, tp.OP_WIDTH), np.int32))
    assert tp.fused_smem_bytes(mid, 4, 28, True, True) <= tp.SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="more than 232448"):
        tp.fused_smem_bytes(dataclasses.replace(
            prog, ops=np.zeros((2600, tp.OP_WIDTH), np.int32)), 4, 28, True,
            True)


def test_kernel_ab_pairs_a_renamed_kernel(capsys):
    """benchmarks/kernel_ab.py's SASS table: a kernel in one build only is
    matched to the other build's kernel of the same SASS (a rename, as the
    over-relaxed march's to ``megakernel_relax``), and to none that both
    builds hold."""
    from compute_path_tracer_tpu_torch.benchmarks import kernel_ab

    same = kernel_ab.sass_same({
        "A": {"march<1>": (9, "h1"), "walk": (5, "h2"), "gone": (3, "h3")},
        "B": {"relax": (9, "h1"), "walk": (5, "h2"), "grid": (4, "h2")}})
    assert same == {"march<1>": "only A, the same SASS as B's relax",
                    "relax": "only B, the same SASS as A's march<1>",
                    "walk": "same", "gone": "only A", "grid": "only B"}
    assert "SASS relax: only B" in capsys.readouterr().out
