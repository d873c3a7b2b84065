"""Port parity: the over-relaxed t-culled march (``omega`` > 1, K2b) of the
plain kernel version, render/program.py:cast_tcull, with the invariants of
tests/test_overrelax.py on the primary rays of csg_demo: the
sphere-overlap revert preserves hit and miss (under 2 % of rays flip, none
of them a tunneled hit at non-grazing incidence), hit distances agree to
10 MHD on 98 % of the real hits, and ``omega=1.0`` is the march without
over-relaxation.  The frame is then held to the JAX Pallas kernel with the
same ``omega`` in interpret mode, under tests/test_baked.py:186-205's
contract (under 2 % of pixels off by > 1e-2), and JAX's silent disregard of
``omega`` outside the t-culled march of debug 0 and 3 is mirrored.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compute_path_tracer_tpu.kernels.megakernel import render_frame_pallas
from compute_path_tracer_tpu.scene import compile_scene as j_compile
from compute_path_tracer_tpu.scene import library as j_lib
from compute_path_tracer_tpu_torch.constants import FP, MHD
from compute_path_tracer_tpu_torch.kernels import megakernel as mk
from compute_path_tracer_tpu_torch.ops.camera import calc_uv, primary_ray
from compute_path_tracer_tpu_torch.render import program as tp
from compute_path_tracer_tpu_torch.render.reference import calc_normal
from compute_path_tracer_tpu_torch.scene import compile_scene as t_compile
from compute_path_tracer_tpu_torch.scene import convert_scene
from compute_path_tracer_tpu_torch.vecmath import Vec3

W, H = 96, 64


def _setup():
    tc = t_compile(convert_scene(j_lib.csg_demo()))
    prog = tp.build_program(tc.spec, "baked")
    table = tp.program_table(prog, torch.from_numpy(tc.params), True)
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32),
                            indexing="ij")
    u, v = calc_uv(xs.reshape(-1), ys.reshape(-1), W, H, W / H)
    ro, rd = primary_ray(u, v, 1.0)
    ro = Vec3(*(torch.broadcast_to(c, u.shape).contiguous() for c in ro))
    return prog, table, ro, rd


def _march(omega, count=None):
    prog, table, ro, rd = _setup()
    checks, _ = tp.program_bounds(prog, table, ro, rd, True)
    map_fn = tp.make_map_program(prog, table.tolist(), count)
    return tp.cast_tcull(prog, map_fn, ro, rd, checks, omega=omega)


def test_overrelax_preserves_hits():
    c1, c2 = {}, {}
    t1, i1 = (x.numpy() for x in _march(1.0, c1))
    t2, i2 = (x.numpy() for x in _march(1.6, c2))
    # omega reaches the march: its stretched steps and reverts take another
    # number of map taps (measured 137,101 against 131,022: on csg_demo the
    # reverts cost more than the longer steps save).
    assert c2["taps"] != c1["taps"]
    hit1, hit2 = t1 <= FP, t2 <= FP
    # Flips are grazing rays that step over the MHD shell the creeping
    # exact march enters, or step-budget exits (tests/test_overrelax.py).
    flips = hit1 != hit2
    assert flips.mean() < 0.02, flips.mean()
    prog, table, ro, rd = _setup()
    guards, _ = tp.program_bounds(prog, table, ro, rd, False)
    map_fn = tp.make_map_program(prog, table.tolist())

    def real(t):
        p = ro + rd * torch.from_numpy(t)
        return np.abs(map_fn(p, guards[0])[0].numpy()) < MHD

    if flips.any():
        p1 = ro + rd * torch.from_numpy(t1)
        n = calc_normal(lambda q, c: map_fn(q, c[0]), p1, guards)
        cos_inc = np.abs(n.dot(rd).numpy())
        bad = flips & real(t1) & (cos_inc > 0.2)
        assert not bad.any(), int(bad.sum())
    both = hit1 & hit2 & real(t1) & real(t2)
    assert both.mean() > 0.3
    dt = np.abs(t1 - t2)[both]
    assert np.quantile(dt, 0.98) < 10 * MHD, np.quantile(dt, 0.98)
    assert (dt > 0).any()  # the relaxed march stops elsewhere in the shell
    assert (i1[both] == i2[both]).mean() > 0.98


def test_omega_one_is_the_march():
    """omega=1.0 takes the march without over-relaxation, to the bit."""
    prog, table, ro, rd = _setup()
    checks, _ = tp.program_bounds(prog, table, ro, rd, True)
    map_fn = tp.make_map_program(prog, table.tolist())
    a = tp.cast_tcull(prog, map_fn, ro, rd, checks)
    b = tp.cast_tcull(prog, map_fn, ro, rd, checks, omega=1.0)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    tc = t_compile(convert_scene(j_lib.csg_demo()))
    pv = torch.from_numpy(tc.params)
    kw = dict(width=32, height=16, bounces=2, geometry="baked", t_cull=True)
    assert torch.equal(mk.render_frame_megakernel(tc.spec, pv, **kw),
                       mk.render_frame_megakernel(tc.spec, pv, omega=1.0, **kw))


@pytest.mark.parametrize("geometry", ["baked", "faithful"])
def test_frame_matches_pallas_interpret(geometry):
    jc = j_compile(j_lib.csg_demo())
    tc = t_compile(convert_scene(j_lib.csg_demo()))
    kw = dict(width=64, height=32, bounces=2, frame=1, geometry=geometry,
              t_cull=True, omega=1.6)
    a = np.asarray(render_frame_pallas(jc.spec, jnp.asarray(jc.params),
                                       interpret=True, tile=(32, 128), **kw))
    b = mk.render_frame_megakernel(tc.spec, torch.from_numpy(tc.params),
                                   **kw).numpy()
    assert np.isfinite(b).all()
    kw.pop("omega")
    plain = mk.render_frame_megakernel(tc.spec, torch.from_numpy(tc.params),
                                       **kw).numpy()
    assert not np.array_equal(b, plain)  # omega reaches the frame
    assert float((np.abs(a - b).max(axis=-1) > 1e-2).mean()) < 0.02


@pytest.mark.parametrize("kw", [dict(geometry="baked"),
                                dict(geometry="faithful"),
                                dict(geometry="baked", t_cull=True, debug=1),
                                dict(geometry="baked", t_cull=True, debug=2)],
                         ids=str)
def test_omega_ignored_outside_the_tcull_march(kw):
    """As in JAX (megakernel.py:1069-1089, :1418-1435): without t_cull, and
    in debug 1 and 2, omega changes nothing."""
    tc = t_compile(convert_scene(j_lib.csg_demo()))
    pv = torch.from_numpy(tc.params)
    args = dict(width=16, height=8, bounces=1, **kw)
    assert torch.equal(mk.render_frame_megakernel(tc.spec, pv, omega=1.6, **args),
                       mk.render_frame_megakernel(tc.spec, pv, **args))
