"""Port parity: the marching path (the K2 megakernel's modes) against the JAX
package.

On the CPU ``render_frame_megakernel`` runs its plain torch version (the
CSG program of render/program.py, interpreted in torch).  These tests hold:

* the port's oracle march (render/reference.py:cast_ray) to JAX ``cast_ray``
  on scattered rays, as tests/test_kernel_interpret.py:94 holds the march
  kernel: ids equal, hit t to 1e-5 on 99 % of rays and within the 2*MHD
  hit shell on all (XLA contracts multiply-adds, the port rounds each
  operation);
* the plain kernel frame to the port's oracle frame, bit for bit, in every
  scene, geometry and debug mode of tests/test_torch_sdf.py;
* frames at 64x32, 2 bounces, of the port (oracle and kernel version) to JAX
  ``render_frame``: debug 2 and 3 bit-equal, debug 1 to 5e-4, debug 0 at most
  0.5 % of pixels off by more than 1e-2 (here and in
  tests/test_torch_march_frames.py);
* the per-thread t-culled march to the oracle in debug 1 under
  tests/test_baked.py:182's contract: under 1 % of pixels off by > 1e-2.

The CUDA kernel is held to the plain version on the card by chip_smoke.py.
"""

from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compute_path_tracer_tpu.render import render_frame as j_render_frame
from compute_path_tracer_tpu.render import baked as jb
from compute_path_tracer_tpu.render.reference import cast_ray as j_cast_ray
from compute_path_tracer_tpu.vecmath import Vec3 as JVec3
from compute_path_tracer_tpu_torch.app.config import Settings
from compute_path_tracer_tpu_torch.kernels import megakernel as mk
from compute_path_tracer_tpu_torch.render import baked as tb
from compute_path_tracer_tpu_torch.render import program as tp
from compute_path_tracer_tpu_torch.render.reference import cast_ray, render_frame
from compute_path_tracer_tpu_torch.render.session import RenderSession
from compute_path_tracer_tpu_torch.scene import csg_demo
from compute_path_tracer_tpu_torch.vecmath import Vec3 as TVec3
from test_torch_sdf import SCENES, pair

W, H, BOUNCES = 64, 32, 2
DIFF_TOL = 1e-2


@lru_cache(maxsize=None)
def jax_frame(name, geometry, debug):
    jc, _ = pair(name)
    return np.asarray(j_render_frame(jc.spec, jnp.asarray(jc.params), width=W,
                                     height=H, debug=debug, bounces=BOUNCES,
                                     geometry=geometry))


def port_frames(name, geometry, debug, width=W, height=H):
    """The port's oracle frame and its plain kernel frame (CPU tensors
    never reach a kernel)."""
    _, tc = pair(name)
    params = torch.from_numpy(tc.params)
    kw = dict(width=width, height=height, debug=debug, bounces=BOUNCES,
              geometry=geometry)
    before = dict(mk.LAUNCHES)
    plain = mk.render_frame_megakernel(tc.spec, params, **kw)
    assert mk.LAUNCHES == before
    oracle = render_frame(tc.spec, params, **kw)
    for img in (plain, oracle):
        assert img.shape == (height, width, 3) and img.dtype == torch.float32
        assert bool(torch.isfinite(img).all())
    return oracle.numpy(), plain.numpy()


def share_off(a, b):
    return float((np.abs(a - b).max(axis=-1) > DIFF_TOL).mean())


def check_against_jax(name, geometry, debug):
    """Both port frames against JAX under the mode's contract."""
    ref = jax_frame(name, geometry, debug)
    for img in port_frames(name, geometry, debug):
        if debug in (2, 3):
            # Discrete images; a flip would need an ulp to move a hit.
            np.testing.assert_array_equal(img, ref)
        elif debug == 1:
            # XLA contracts multiply-adds in the map and rounds its trig
            # otherwise; the central difference divides those last-bit
            # differences by its 2e-4 tap spacing.  Between the JAX
            # package's own backends the bound is 1e-4
            # (test_kernel_interpret.py:52); across the two frameworks the
            # rotated benchmark scene reaches 2.6e-4.
            np.testing.assert_allclose(img, ref, rtol=0, atol=5e-4)
        else:
            assert share_off(img, ref) <= 5e-3


@pytest.mark.parametrize("case", [("sphere_and_plane", "faithful", 0),
                                  ("sphere_and_plane", "faithful", 3),
                                  ("glass_demo", "baked", 0),
                                  ("clobber", "baked", 0),
                                  ("benchmark_16", "baked", 1)], ids=str)
def test_frame_matches_jax(case):
    check_against_jax(*case)


@pytest.mark.parametrize("geometry", ["faithful", "baked"])
@pytest.mark.parametrize("name", SCENES)
def test_kernel_plain_equals_oracle(name, geometry):
    """The packed program, its march and normals are the oracle's, to the
    bit, in the path-traced and the normals modes."""
    for debug in (0, 1):
        oracle, plain = port_frames(name, geometry, debug, 32, 16)
        np.testing.assert_array_equal(plain, oracle)


def _rays(seed):
    r = np.random.default_rng(seed)
    ro = r.uniform(-4, 4, (3, 21 * 97)).astype(np.float32)
    d = r.normal(size=(3, 21 * 97)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return ro, d


@pytest.mark.parametrize("geometry", ["faithful", "baked"])
def test_cast_ray_matches_jax_on_scattered_rays(geometry):
    """Secondary-style rays (scattered origins and directions) through the
    oracle march of both packages, and through the kernel's program."""
    from compute_path_tracer_tpu.render import scenegen as jsg
    from compute_path_tracer_tpu_torch.render import scenegen as tsg

    jc, tc = pair("benchmark_16")
    ro, rd = _rays(3)
    jro, jrd = JVec3(*map(jnp.asarray, ro)), JVec3(*map(jnp.asarray, rd))
    tro, trd = TVec3(*map(torch.from_numpy, ro)), TVec3(*map(torch.from_numpy, rd))
    pv_j, pv_t = jnp.asarray(jc.params), torch.from_numpy(tc.params)
    if geometry == "baked":
        g_j, g_t = jb.bake(jc.spec, pv_j), tb.bake(tc.spec, pv_t)
        jmap, jbounds = jb.make_map_baked(jc.spec), jb.make_bounds_baked(jc.spec)
        tmap, tbounds = tb.make_map_baked(tc.spec), tb.make_bounds_baked(tc.spec)
    else:
        g_j, g_t = pv_j, pv_t
        jmap, jbounds = jsg.make_map(jc.spec), jsg.make_bounds(jc.spec)
        tmap, tbounds = tsg.make_map(tc.spec), tsg.make_bounds(tc.spec)
    checks_j, _ = jbounds(jro, jrd, g_j)
    t_j, i_j = map(np.asarray, j_cast_ray(jmap, jro, jrd, g_j, checks_j))
    checks_t, _ = tbounds(tro, trd, g_t)
    t_t, i_t = cast_ray(lambda p, c: tmap(p, g_t, c), tro, trd, checks_t)
    hit = t_j <= 100.0
    assert 0.05 < hit.mean() < 0.95
    assert np.array_equal(i_t.numpy(), i_j)
    # A hit fires anywhere in the |d| < MHD shell: where a last-bit
    # difference moves a step, the march lands elsewhere in it (one ray of
    # 1132 here).  Misses overshoot the far plane by their last step, whose
    # t is never read.
    t_t = t_t.numpy()
    dt = np.abs(t_t[hit] - t_j[hit])
    assert (dt <= 1e-5 * np.maximum(1.0, t_j[hit])).mean() >= 0.99
    assert dt.max() <= 2e-3
    assert (t_t[~hit] > 100.0).all()

    prog = tp.build_program(tc.spec, geometry)
    table = tp.program_table(prog, pv_t)
    guards, _ = tp.program_bounds(prog, table, tro, trd, False)
    map_fn = tp.make_map_program(prog, table.tolist())
    t_p, i_p = cast_ray(lambda p, c: map_fn(p, c[0]), tro, trd, guards)
    assert np.array_equal(t_p.numpy(), t_t) and torch.equal(i_p, i_t)


@pytest.mark.parametrize("name", ["csg_demo", "benchmark_16"])
def test_tcull_matches_oracle_debug1(name):
    """The per-thread t-culled march against JAX's oracle frame, in the
    normals mode (tests/test_baked.py:168-182's contract)."""
    _, tc = pair(name)
    img = mk.render_frame_megakernel(
        tc.spec, torch.from_numpy(tc.params), width=W, height=H, debug=1,
        bounces=BOUNCES, geometry="baked", t_cull=True).numpy()
    assert share_off(img, jax_frame(name, "baked", 1)) < 0.01


def test_tcull_keeps_subtraction_and_clobber_exact():
    """Only min-folded leaves are t-culled: a subtraction's operands and a
    clobbering first shape keep the bounce-level guard."""
    _, tc = pair("clobber")
    prog = tp.build_program(tc.spec, "baked")
    assert prog.box_cull.tolist() == [0]  # 'first' clobbers its sibling union
    _, tc = pair("blend_demo")
    assert tp.build_program(tc.spec, "faithful").box_cull.tolist() == [0] * 4


def test_session_renders_csg_demo_on_cpu():
    """The session's default frame function marches the faithful geometry,
    as the JAX package's does, so a subtraction scene renders."""
    sess = RenderSession(csg_demo(), 32, 24, Settings(debug=0, bounces=2),
                         device="cpu")
    img = sess.render(2)
    assert img.shape == (24, 32, 3)
    assert bool(torch.isfinite(img).all()) and float(img.max()) > 0.0


@pytest.mark.parametrize("mode", ["faithful", "tcull", "analytic"])
def test_cli_modes(mode, tmp_path):
    from compute_path_tracer_tpu_torch.app.cli import main

    out = tmp_path / "m.png"
    scene = "benchmark_scene" if mode == "analytic" else "csg_demo"
    assert main(["render", "--scene", scene, "--width", "16", "--height", "12",
                 "--frames", "1", "--bounces", "1", "--device", "cpu",
                 "--mode", mode, "--out", str(out)]) == 0
    assert out.exists()


def test_frame_matches_pallas_interpret():
    """One marching frame against the Pallas kernel in interpret mode."""
    from compute_path_tracer_tpu.kernels.megakernel import render_frame_pallas

    jc, _ = pair("csg_demo")
    ref = np.asarray(render_frame_pallas(
        jc.spec, jc.params, width=W, height=H, bounces=BOUNCES, debug=2,
        geometry="baked", interpret=True, tile=(32, 128)))
    for img in port_frames("csg_demo", "baked", 2):
        np.testing.assert_array_equal(img, ref)
