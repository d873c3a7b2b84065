"""Port parity: the baked lower-bound distance grid and the ``dist_grid``
march (K6's mode), against the JAX package.

* ``grid_eligible``: equal to JAX on the library scenes and on JAX's
  plane-only case (tests/test_distgrid.py:90).
* ``bake_dist_grid``: meta and cells within 1e-5 absolute of JAX's, whose
  (n_chunks, 128) chunks are flattened and cut to gx*gy*gz.
* ``cheap_bound`` at 128x128 seeded points within 1e-5 of
  ``cheap_bound_xla``; the safety property on the port's own map (its CSG
  program with every guard passing): wherever ``g >= tau``, ``g <= d +
  1e-5``; the outside fallback against ``hypot``.
* The grid march's frame (the plain version the kernel is held to on the
  card) against JAX's Pallas grid march in interpret mode, at 128x32 with
  2 bounces on benchmark_scene(16): at most 2 % of pixels off by more than
  1e-2.  That is tests/test_torch_unboxed.py's gate for a per-thread cull
  against JAX's per-tile cull: JAX decides per tile which shapes the exact
  tap evaluates and which intervals clamp the step, the port per ray, so
  sub-MHD landing positions and a few Monte-Carlo paths may move
  (measured: no pixel off by more than 1e-2).
* The plain grid frame against the plain t-culled frame: at most 5e-3 of
  pixels off (JAX's own contract, tests/test_distgrid.py:111-123), on
  benchmark_scene(16), csg_demo and blend_demo (measured 0, 4.9e-4 and
  0); ``omega`` ignored under
  ``dist_grid`` (bit-equal); JAX's ``ValueError``s; ``dist_grid`` with
  ``analytic_unboxed``, against the port's capped t-culled frame (5e-3) and
  against JAX's frame of the same two modes in interpret mode (the 2 % gate
  above); the id of a ray that runs out of iterations; and the id of a ray
  that stops on its last allowed iteration.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compute_path_tracer_tpu.kernels.megakernel import render_frame_pallas
from compute_path_tracer_tpu.render import distgrid as jdg
from compute_path_tracer_tpu.render.baked import bake as j_bake
from compute_path_tracer_tpu.scene import compile_scene as j_compile
from compute_path_tracer_tpu.scene import library as j_lib
from compute_path_tracer_tpu.scene.model import Scene as JScene
from compute_path_tracer_tpu.scene.model import Shape as JShape
from compute_path_tracer_tpu.scene.model import Union as JUnion
from compute_path_tracer_tpu.vecmath import Vec3 as JVec3
from compute_path_tracer_tpu_torch.constants import FP, MHD
from compute_path_tracer_tpu_torch.kernels import megakernel as mk
from compute_path_tracer_tpu_torch.render import distgrid as tdg
from compute_path_tracer_tpu_torch.render import program as tprog
from compute_path_tracer_tpu_torch.render.baked import bake
from compute_path_tracer_tpu_torch.render.program import (
    build_program,
    cast_grid,
    cast_tcull,
    make_map_program,
    program_bounds,
    program_table,
)
from compute_path_tracer_tpu_torch.render.reference import camera_rays
from compute_path_tracer_tpu_torch.scene import compile_scene as t_compile
from compute_path_tracer_tpu_torch.scene import convert_scene
from compute_path_tracer_tpu_torch.vecmath import Vec3

DIFF_TOL = 1e-2
GRID = dict(geometry="baked", t_cull=True, dist_grid=True)
SCENES = {"benchmark_scene(16)": lambda: j_lib.benchmark_scene(16),
          "csg_demo": j_lib.csg_demo, "blend_demo": j_lib.blend_demo,
          "edge_demo": j_lib.edge_demo}


def _plane_only():
    root = JUnion(name="R")
    p = root.add_shape(JShape(2, name="P"))
    p.transform.aabb = False
    return JScene([root])


def _pair(scene):
    return j_compile(scene), t_compile(convert_scene(scene))


def _bvs(jc, tc):
    return (j_bake(jc.spec, jnp.asarray(jc.params, jnp.float32)),
            bake(tc.spec, torch.from_numpy(np.asarray(tc.params, np.float32))))


def _params(tc):
    return torch.from_numpy(np.asarray(tc.params, np.float32))


def _share_off(a, b):
    d = np.abs(np.asarray(a) - np.asarray(b)).max(axis=-1)
    return float((d > DIFF_TOL).mean())


@pytest.mark.parametrize("scene_fn", list(SCENES.values())
                         + [j_lib.sphere_and_plane, j_lib.glass_demo,
                            _plane_only],
                         ids=list(SCENES) + ["sphere_and_plane", "glass_demo",
                                             "plane only"])
def test_grid_eligible_matches_jax(scene_fn):
    jc, tc = _pair(scene_fn())
    assert tdg.grid_eligible(tc.spec) == jdg.grid_eligible(jc.spec)
    if not jdg.grid_eligible(jc.spec):
        with pytest.raises(ValueError):
            tdg.bake_dist_grid(tc.spec, _bvs(jc, tc)[1])


@pytest.mark.parametrize("name", list(SCENES))
def test_bake_matches_jax(name):
    jc, tc = _pair(SCENES[name]())
    jbv, tbv = _bvs(jc, tc)
    jm, jch = jdg.bake_dist_grid(jc.spec, jbv)
    tm, tcells = tdg.bake_dist_grid(tc.spec, tbv)
    gx, gy, gz = tdg.DEFAULT_RES
    assert tm.shape == (tdg.META_SLOTS,) and tcells.shape == (gx * gy * gz,)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tcells.numpy(),
                               np.asarray(jch).reshape(-1)[:gx * gy * gz],
                               rtol=0, atol=1e-5)


def _points(seed=0):
    pts = np.random.default_rng(seed).uniform(-20.0, 20.0, (128, 128, 3))
    return pts.astype(np.float32)


@pytest.mark.parametrize("name", list(SCENES))
def test_cheap_bound_matches_jax_and_is_safe(name):
    jc, tc = _pair(SCENES[name]())
    jbv, tbv = _bvs(jc, tc)
    pts = _points()
    g_j = np.asarray(jdg.cheap_bound_xla(
        jc.spec, jbv, JVec3(*(jnp.asarray(pts[..., i]) for i in range(3)))))
    p = Vec3(*(torch.from_numpy(pts[..., i].reshape(-1).copy())
               for i in range(3)))
    g = tdg.cheap_bound(tc.spec, tbv, p)
    np.testing.assert_allclose(g.numpy(), g_j.reshape(-1), rtol=0, atol=1e-5)
    # Safety on the port's own map, every guard passing (culling only
    # raises min-like folds, so that is the hardest case).
    prog = build_program(tc.spec, "baked")
    table = program_table(prog, _params(tc), True)
    d, _ = make_map_program(prog, table.tolist())(
        p, torch.ones((p.x.shape[0], prog.n_boxed), dtype=torch.bool))
    unsafe = (g >= tdg.GRID_TAU) & (g > d + 1e-5)
    assert int(unsafe.sum()) == 0
    assert float((g >= tdg.GRID_TAU).float().mean()) > 0.25


def test_outside_fallback_is_box_distance():
    jc, tc = _pair(j_lib.edge_demo())  # one bounded sphere, no plane
    tbv = _bvs(jc, tc)[1]
    meta, _ = tdg.bake_dist_grid(tc.spec, tbv)
    lo, hi = meta[:3].numpy(), meta[6:9].numpy()
    p = Vec3(torch.tensor([hi[0] + 5.0]), torch.tensor([hi[1]]),
             torch.tensor([lo[2] - 2.0]))
    g = float(tdg.cheap_bound(tc.spec, tbv, p)[0])
    assert abs(g - float(np.hypot(5.0, 2.0))) < 1e-4


@pytest.fixture(scope="module")
def bench16_frames():
    """JAX's Pallas grid march (interpret mode), the port's plain grid march
    and the port's plain t-culled march, at 128x32 with 2 bounces."""
    jc, tc = _pair(j_lib.benchmark_scene(16))
    kw = dict(width=128, height=32, bounces=2)
    jax_img = np.asarray(render_frame_pallas(
        jc.spec, jnp.asarray(jc.params, jnp.float32), geometry="baked",
        t_cull=True, dist_grid=True, interpret=True, tile=(32, 128), **kw))
    params = _params(tc)
    grid = mk.render_frame_megakernel(tc.spec, params, **kw, **GRID)
    tcull = mk.render_frame_megakernel(tc.spec, params, geometry="baked",
                                       t_cull=True, **kw)
    return jax_img, grid.numpy(), tcull.numpy()


def test_grid_frame_matches_jax_interpret(bench16_frames):
    jax_img, grid, _ = bench16_frames
    assert np.isfinite(grid).all() and grid.mean() > 0.0
    assert _share_off(grid, jax_img) <= 0.02


def test_grid_frame_matches_tcull_frame(bench16_frames):
    _, grid, tcull = bench16_frames
    assert _share_off(grid, tcull) <= 5e-3


@pytest.mark.parametrize("scene_fn", [j_lib.csg_demo, j_lib.blend_demo],
                         ids=["csg_demo", "blend_demo"])
def test_grid_frame_matches_tcull_frame_csg(scene_fn):
    _, tc = _pair(scene_fn())
    params = _params(tc)
    kw = dict(width=64, height=32, bounces=2, geometry="baked", t_cull=True)
    grid = mk.render_frame_megakernel(tc.spec, params, dist_grid=True, **kw)
    tcull = mk.render_frame_megakernel(tc.spec, params, **kw)
    assert _share_off(grid, tcull) <= 5e-3


def test_omega_ignored_under_dist_grid():
    _, tc = _pair(j_lib.csg_demo())
    params = _params(tc)
    kw = dict(width=32, height=16, bounces=2, **GRID)
    assert torch.equal(mk.render_frame_megakernel(tc.spec, params, omega=1.6,
                                                  **kw),
                       mk.render_frame_megakernel(tc.spec, params, **kw))


@pytest.mark.parametrize("kw,scene_fn", [
    (dict(dist_grid=True), j_lib.edge_demo),
    (dict(dist_grid=True, geometry="baked"), j_lib.edge_demo),
    (dict(dist_grid=True, t_cull=True), j_lib.edge_demo),
    (dict(GRID, debug=1), j_lib.edge_demo),
    (dict(GRID, debug=2), j_lib.edge_demo),
    (GRID, _plane_only),
    (dict(GRID, analytic_all=True), j_lib.edge_demo),
    (dict(GRID, analytic_soa=True), j_lib.edge_demo),
], ids=["faithful", "no t_cull", "faithful t_cull", "debug 1", "debug 2",
        "plane only", "analytic_all", "analytic_soa"])
def test_dist_grid_raises_jax_errors(kw, scene_fn):
    jc, tc = _pair(scene_fn())
    args = dict(width=16, height=8, bounces=0, **kw)
    with pytest.raises(ValueError):
        render_frame_pallas(jc.spec, jnp.asarray(jc.params, jnp.float32),
                            interpret=True, **args)
    with pytest.raises(ValueError):
        mk.render_frame_megakernel(tc.spec, _params(tc), **args)


def test_dist_grid_composes_with_analytic_unboxed():
    """The grid march capped by the closed form of the guard-less shapes:
    csg_demo's plane and lamp leave the map, so the capped grid frame moves
    off the uncapped one only where the cap binds; it stays within 5e-3 of
    the capped t-culled frame."""
    _, tc = _pair(j_lib.csg_demo())
    params = _params(tc)
    kw = dict(width=64, height=32, bounces=2, geometry="baked", t_cull=True,
              analytic_unboxed=True)
    count = {}
    both = mk.render_frame_megakernel_plain(tc.spec, params, dist_grid=True,
                                            count=count, **kw)
    capped = mk.render_frame_megakernel(tc.spec, params, **kw)
    assert count["cap_segments"] > 0 and count["grid_taps"] > 0
    assert _share_off(both, capped) <= 5e-3


def test_grid_unboxed_frame_matches_jax_interpret():
    """``dist_grid`` with ``analytic_unboxed`` against JAX's Pallas frame of
    the same two modes (kernels/megakernel.py:1070-1074), in interpret
    mode, at test_grid_frame_matches_jax_interpret's gate: JAX culls per
    tile, the port per ray."""
    jc, tc = _pair(j_lib.benchmark_scene(16))
    kw = dict(width=128, height=32, bounces=2, analytic_unboxed=True)
    jax_img = np.asarray(render_frame_pallas(
        jc.spec, jnp.asarray(jc.params, jnp.float32), geometry="baked",
        t_cull=True, dist_grid=True, interpret=True, tile=(32, 128), **kw))
    port = mk.render_frame_megakernel(tc.spec, _params(tc), **kw,
                                      **GRID).numpy()
    assert np.isfinite(port).all() and port.mean() > 0.0
    assert _share_off(port, jax_img) <= 0.02


def _march_setup(scene, width=32, height=16):
    _, tc = _pair(scene)
    params = _params(tc)
    prog = build_program(tc.spec, "baked")
    bv = bake(tc.spec, params)
    table = program_table(prog, params, True, bv)
    ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.int32),
                            torch.arange(width, dtype=torch.int32),
                            indexing="ij")
    _, ro, rd = camera_rays(xs, ys, 0, 1.0, width / height, width=width,
                            height=height)
    checks, _ = program_bounds(prog, table, ro, rd, True)
    return tc, prog, bv, table.tolist(), ro, rd, checks


def test_ray_out_of_iterations_takes_the_full_map_id():
    """With tau 0 no ray takes an exact tap: a ray that reaches a cell
    whose bound is 0 stops there, runs out of iterations, and takes the id
    of one map tap under the bounce's full guards at its last position
    (JAX ``_final_idx``); a ray that never reaches one leaves as far.
    edge_demo's one sphere keeps the camera outside the grid's box."""
    tc, prog, bv, vals, ro, rd, checks = _march_setup(j_lib.edge_demo())
    grid = tdg.make_dist_grid(tc.spec, bv, tau=0.0)
    count = {}
    map_fn = make_map_program(prog, vals, count)
    t, idx = cast_grid(prog, map_fn, ro, rd, checks,
                       tdg.make_grid_tap(tc.spec, grid, vals), 0.0,
                       count=count)
    stuck = ~(t > FP)
    # The only map taps are the stuck rays' final ones.
    assert 0 < int(stuck.sum()) < t.shape[0]
    assert count["taps"] == int(stuck.sum())
    _, want = map_fn(ro + rd * t, checks[0])
    assert torch.equal(idx[stuck], want[stuck]) and bool((idx[stuck] >= 0).all())
    assert bool((idx[~stuck] == -1).all())
    # Stuck rays sit within one cell's diagonal of a surface, never inside.
    d, _ = map_fn(ro + rd * t, checks[0])
    assert bool((d[stuck] > -MHD).all())


def test_ray_stopping_on_its_last_iteration_keeps_its_tap_id(monkeypatch):
    """A ray that hits, goes far or spends its exact taps on its last
    allowed iteration ends with its last exact tap's id, as the kernel's
    march_grid returns inside its loop; only a ray still marching takes the
    full map's id.  With every tap exact (tau = inf) and the iteration cap
    patched down to the exact-tap budget, the grid march is the t-culled
    march step for step: the same t, the same ids and no extra map tap."""
    monkeypatch.setattr(tprog, "STEPS", 12)
    monkeypatch.setattr(tprog, "GRID_MAX_ITERS", 12)
    tc, prog, bv, vals, ro, rd, checks = _march_setup(
        j_lib.benchmark_scene(16))
    grid = tdg.make_dist_grid(tc.spec, bv)
    c_grid, c_tcull = {}, {}
    t, idx = cast_grid(prog, make_map_program(prog, vals, c_grid), ro, rd,
                       checks, tdg.make_grid_tap(tc.spec, grid, vals),
                       float("inf"), count=c_grid)
    t_ref, idx_ref = cast_tcull(prog, make_map_program(prog, vals, c_tcull),
                                ro, rd, checks)
    # Some rays stop on the last iteration without a hit.
    assert int(((t <= FP) & (idx >= 0)).sum()) > 0
    assert int(c_grid.get("grid_cheap", 0)) == 0
    assert int(c_grid["taps"]) == int(c_tcull["taps"])
    assert torch.equal(t, t_ref) and torch.equal(idx, idx_ref)
