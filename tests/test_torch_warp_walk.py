"""Port parity: the per-warp walk of the CSG program that K2's plain march
and K3 take (kernels/csrc/csg_program.cuh:build_warp_list, map_walk).

Each warp of 32 lanes (K2: a 2x16 tile of pixels, ``megakernel.WARP``; K3:
32 consecutive rays) walks, at every map tap, a list of the program's
records built after the bounce's guards: every ENTER, LEAVE and guard-less
shape, and each guarded shape whose box some live lane of the warp hits.
``render/program.py:warp_records`` is the list's plain model and
``make_map_program(..., records=)`` the map over one list.  These tests
hold, on csg_demo (subtraction), blend_demo (smooth union), the
first-shape clobber scene and ``benchmark_scene(64)``, baked and faithful,
with the t-culled guards and without, at points along primary and
scattered rays:

* the map through each warp's list to the full walk of ``make_map_program``,
  bit for bit (distances and ids) on the live lanes;
* the same values to the JAX package's map at the same points under the
  same guards, built from numpy inputs: ids equal, distances to 1e-5 (the
  contract of tests/test_torch_sdf.py: XLA contracts multiply-adds);
* a warp whose lanes hit no box lists only the ENTER, LEAVE and guard-less
  records, and a warp with every bit set lists the whole program;
* ``walk_smem_bytes``, the shared memory the wrappers give a block, and its
  error for a program a block cannot hold.

The kernels walk the lists on the card; chip_smoke.py holds their frames
and rays to the plain versions there."""

import dataclasses
from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compute_path_tracer_tpu.render import baked as jb
from compute_path_tracer_tpu.render import scenegen as jsg
from compute_path_tracer_tpu.scene import compile_scene as j_compile
from compute_path_tracer_tpu.scene import library as j_lib
from compute_path_tracer_tpu.vecmath import Vec3 as JVec3
from compute_path_tracer_tpu_torch.kernels import march as km
from compute_path_tracer_tpu_torch.kernels import megakernel as mk
from compute_path_tracer_tpu_torch.render import program as tp
from compute_path_tracer_tpu_torch.render.reference import camera_rays
from compute_path_tracer_tpu_torch.scene import benchmark_scene, compile_scene
from compute_path_tracer_tpu_torch.scene import convert_scene
from compute_path_tracer_tpu_torch.scene import params_from_numpy
from compute_path_tracer_tpu_torch.vecmath import Vec3 as TVec3
from test_torch_sdf import pair

SCENES = ["csg_demo", "blend_demo", "clobber", "benchmark_64"]
W, H = 32, 8           # K2: 8 warps of 2x16 pixels
N_RAYS = 21 * 97       # K3: 64 warps, the last one partial
TS = (0.5, 2.0, 3.0, 4.5)
DEAD = 0.2             # share of lanes that are not live


@lru_cache(maxsize=None)
def _pair(name):
    if name == "benchmark_64":
        scene = j_lib.benchmark_scene(64)
        return j_compile(scene), compile_scene(convert_scene(scene))
    return pair(name)


def _primary(tc):
    """The 32x8 frame's primary rays and the K2 warp of each."""
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.int32),
                            torch.arange(W, dtype=torch.int32), indexing="ij")
    _, ro, rd = camera_rays(xs, ys, 0, 1.0, W / H, width=W, height=H)
    return ro, rd, mk.warp_ids(xs, ys, W)


def _scattered():
    """Rays with origins in [-4, 4]^3 and uniform directions, and the K3
    warp of each (32 consecutive rays)."""
    r = np.random.default_rng(11)
    ro = r.uniform(-4, 4, (3, N_RAYS)).astype(np.float32)
    d = r.normal(size=(3, N_RAYS)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return (TVec3(*map(torch.from_numpy, ro)), TVec3(*map(torch.from_numpy, d)),
            torch.arange(N_RAYS) // 32)


def _jax_map(jc, geometry):
    pv = jnp.asarray(jc.params)
    if geometry == "baked":
        gv, fn = jb.bake(jc.spec, pv), jb.make_map_baked(jc.spec)
    else:
        gv, fn = pv, jsg.make_map(jc.spec)
    return lambda p, checks: fn(p, gv, checks)


def _shape_checks(prog, guard):
    """Per-shape checks for the JAX map: the guard column of each guarded
    shape, all-true for the others."""
    n = guard.shape[0]
    cols = [np.ones(n, bool)] * prog.n_shapes
    for op in prog.ops:
        if op[0] == tp.OPC_SHAPE and op[3] >= 0:
            cols[op[4]] = guard[:, op[3]].numpy()
    return tuple(jnp.asarray(c) for c in cols)


@pytest.mark.parametrize("t_cull", [False, True], ids=["exact", "tcull"])
@pytest.mark.parametrize("geometry", ["baked", "faithful"])
@pytest.mark.parametrize("name", SCENES)
def test_walk_through_warp_lists(name, geometry, t_cull):
    jc, tc = _pair(name)
    params = params_from_numpy(tc.params, tc.spec, "cpu")
    prog = tp.build_program(tc.spec, geometry)
    table = tp.program_table(prog, params, t_cull)
    vals = table.tolist()
    full = tp.make_map_program(prog, vals)
    jmap = _jax_map(jc, geometry)
    cull = torch.from_numpy(prog.box_cull != 0)
    live_rng = np.random.default_rng(5)
    walked = 0
    for ro, rd, warp in (_primary(tc), _scattered()):
        checks, _ = tp.program_bounds(prog, table, ro, rd, t_cull)
        chk = checks[0]
        live = torch.from_numpy(live_rng.random(warp.shape[0]) >= DEAD)
        lists = tp.warp_records(prog, chk[live], warp[live],
                                int(warp.max()) + 1)
        for t in TS:
            tt = torch.full_like(ro.x, t)
            p = ro + rd * tt
            guard = chk
            if t_cull:
                lo, hi = checks[1], checks[2]
                guard = chk & (~cull | ((lo <= t) & (hi >= t)))
            d_full, i_full = full(p, guard)
            d_walk, i_walk = torch.empty_like(d_full), torch.empty_like(i_full)
            for w in torch.unique(warp[live]).tolist():
                rows = torch.nonzero((warp == w) & live).flatten()
                rec = torch.nonzero(lists[w]).flatten()
                walk = tp.make_map_program(prog, vals, records=rec)
                d_walk[rows], i_walk[rows] = walk(
                    TVec3(*(c[rows] for c in p)), guard[rows])
                walked += 1
            lv = torch.nonzero(live).flatten()
            assert torch.equal(d_walk[lv], d_full[lv])
            assert torch.equal(i_walk[lv], i_full[lv])
            pj = JVec3(*(jnp.asarray(c[lv].numpy()) for c in p))
            dj, ij = jmap(pj, _shape_checks(prog, guard[lv]))
            np.testing.assert_allclose(d_walk[lv].numpy(), np.asarray(dj),
                                       rtol=0, atol=1e-5)
            assert np.array_equal(i_walk[lv].numpy(), np.asarray(ij))
    assert walked > 0


@pytest.mark.parametrize("name", SCENES)
def test_warp_list_bounds(name):
    """No hit: the ENTER, LEAVE and guard-less records only; every bit set:
    the whole program.  Lists keep walk order, and a warp's list is the OR
    of its lanes'."""
    _, tc = _pair(name)
    for geometry in ("baked", "faithful"):
        prog = tp.build_program(tc.spec, geometry)
        n_ops = prog.ops.shape[0]
        free = (prog.ops[:, 0] != tp.OPC_SHAPE) | (prog.ops[:, 3] < 0)
        warp = torch.tensor([0, 0, 1, 1, 2])
        chk = torch.zeros((5, prog.n_boxed), dtype=torch.bool)
        chk[2:4] = True
        if prog.n_boxed:
            chk[4, -1] = True
        lists = tp.warp_records(prog, chk, warp)
        assert lists.shape == (3, n_ops)
        assert np.array_equal(lists[0].numpy(), free)
        assert bool(lists[1].all())
        last = free.copy()
        last[(prog.ops[:, 0] == tp.OPC_SHAPE)
             & (prog.ops[:, 3] == prog.n_boxed - 1)] = True
        assert np.array_equal(lists[2].numpy(), last)
        # One lane's bits, then the OR of two lanes'.
        r = torch.rand((2, prog.n_boxed), generator=torch.Generator().manual_seed(3)) < 0.3
        one = tp.warp_records(prog, r[:1], torch.tensor([0]))[0]
        both = tp.warp_records(prog, r, torch.tensor([0, 0]))[0]
        other = tp.warp_records(prog, r[1:], torch.tensor([0]))[0]
        assert torch.equal(both, one | other)


def test_walk_smem_bytes():
    """The wrappers' shared memory: 16 bytes a record for the decoded
    program and for each warp's list, then the leaf table F[0, f_box) with
    up to 3 floats of alignment, in 16-byte units; every program up to
    MAX_BOXED guarded shapes fits a K2 block of 8 warps."""
    for n in (64, 256, 259):
        prog = tp.build_program(compile_scene(benchmark_scene(n)).spec, "baked")
        n_ops = prog.ops.shape[0]
        for warps in (mk.WARPS, km.WARPS):
            got = tp.walk_smem_bytes(prog, warps)
            assert got == 16 * n_ops * (1 + warps) + 16 * -(-(prog.f_box + 3) // 4)
            assert got % 16 == 0 and got <= tp.SMEM_PER_BLOCK
        if n == 259:
            assert prog.n_boxed == tp.MAX_BOXED
    prog = tp.build_program(compile_scene(benchmark_scene(64)).spec, "baked")
    assert tp.walk_smem_bytes(prog, mk.WARPS) == 13040  # 9 x 66 x 16 + 221 x 16
    assert tp.walk_smem_bytes(prog, km.WARPS) == 8816


def test_oversize_program_raises():
    """A program a block cannot hold raises in both wrappers, naming the
    sizes, before anything reaches a device."""
    prog = tp.build_program(compile_scene(benchmark_scene(64)).spec, "baked")
    big = dataclasses.replace(prog, ops=np.zeros((3000, tp.OP_WIDTH), np.int32))
    with pytest.raises(ValueError, match="3000 op records.*more than 232448"):
        tp.walk_smem_bytes(big, mk.WARPS)
    accum = torch.zeros((4, 4, 3))
    with pytest.raises(ValueError, match="3000 op records"):
        mk.launch_march(big, torch.zeros(prog.f_len), accum, frame=0,
                        last_clear=0, bounces=1, fov=1.0, aspect=1.0, debug=0,
                        t_cull=True)
    rays = TVec3(*(torch.zeros(3, device="meta") for _ in range(3)))
    with pytest.raises(ValueError, match="3000 op records"):
        km.march_rays(big, torch.zeros(prog.f_len, device="meta"), rays, rays,
                      t_cull=True, with_normal=False)
    # 4 warps hold what 8 cannot.
    mid = dataclasses.replace(prog, ops=np.zeros((1700, tp.OP_WIDTH), np.int32))
    assert tp.walk_smem_bytes(mid, km.WARPS) <= tp.SMEM_PER_BLOCK
    with pytest.raises(ValueError):
        tp.walk_smem_bytes(mid, mk.WARPS)
