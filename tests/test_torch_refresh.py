"""Port parity: ``refresh_every`` (the t-culled march's frozen activation
window, JAX kernels/megakernel.py:674-700) in K2's plain version.

* ``refresh_every=4`` against 1 within JAX's own bound
  (tests/test_baked.py:314-329: under 1 % of pixels off by more than 1e-3,
  csg_demo at 128x64, 2 bounces, baked, t_cull), and 8 as well;
* the window at the level of the march (``cast_tcull``): a ray's culled
  shapes and clamp are those of its t at the window's start, held to a
  plain model written from that contract;
* a small frame against JAX's ``render_frame_pallas(..., refresh_every=4,
  interpret=True)`` to the share bound of the port's t-culled frames
  (tests/test_torch_march.py: JAX's window is per tile, the port's per
  ray);
* JAX's ``ValueError``s (``omega`` != 1, a K that does not divide STEPS)
  raised where JAX raises them, and the frame bit for bit K = 1's where
  JAX ignores the option: without t_cull, with dist_grid, in debug 1, 2
  and 4.
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compute_path_tracer_tpu.kernels.megakernel import render_frame_pallas
from compute_path_tracer_tpu_torch.constants import BIG, FP, MHD, STEPS
from compute_path_tracer_tpu_torch.kernels import megakernel as mk
from compute_path_tracer_tpu_torch.render.program import (
    _on_device,
    build_program,
    cast_tcull,
    make_map_program,
    program_bounds,
    program_table,
)
from compute_path_tracer_tpu_torch.render.reference import camera_rays
from compute_path_tracer_tpu_torch.vecmath import Vec3
from test_torch_sdf import pair

TCULL = dict(geometry="baked", t_cull=True)


def share_off(a, b, tol):
    return float((np.abs(a - b).max(axis=-1) > tol).mean())


@lru_cache(maxsize=None)
def csg_frame(k):
    """csg_demo at 128x64, 2 bounces, baked, t-culled, refresh_every k."""
    _, tc = pair("csg_demo")
    return mk.render_frame_megakernel(
        tc.spec, torch.from_numpy(tc.params), width=128, height=64,
        bounces=2, debug=0, frame=1, last_clear=0, refresh_every=k,
        **TCULL).numpy()


@pytest.mark.parametrize("k", [4, 8])
def test_refresh_divergence_bounded(k):
    b = csg_frame(k)
    assert np.isfinite(b).all()
    assert share_off(csg_frame(1), b, 1e-3) < 0.01


def _window_model(prog, map_fn, ro, rd, checks, k):
    """The frozen window written per ray from JAX's contract: a Python loop
    over the rays, each marched alone."""
    cull = _on_device(prog, ro.x.device).cull
    chk, lo, hi = checks
    out_t = []
    for i in range(ro.x.shape[0]):
        o = Vec3(*(c[i:i + 1] for c in ro))
        d_ = Vec3(*(c[i:i + 1] for c in rd))
        c, l, h = chk[i:i + 1], lo[i:i + 1], hi[i:i + 1]
        t = 0.0
        for step in range(STEPS):
            if step % k == 0:
                tr = t
                active = c & (~cull | ((l <= tr) & (h >= tr)))
                ahead = (c & cull & (l > tr))[0]
                m = float(l[0][ahead].min()) if bool(ahead.any()) else BIG
            d, _ = map_fn(o + d_ * torch.tensor([t]), active)
            ad = float(d.abs()[0])
            step_len = np.float32(min(ad, max(np.float32(m) - np.float32(t),
                                              np.float32(MHD))))
            t = float(np.float32(t) + step_len)
            if ad < MHD or t > FP:
                break
        out_t.append(t)
    return torch.tensor(out_t)


def test_refresh_window_matches_its_model():
    _, tc = pair("csg_demo")
    prog = build_program(tc.spec, "baked")
    params = torch.from_numpy(tc.params)
    table = program_table(prog, params, True)
    map_fn = make_map_program(prog, table.tolist())
    ys, xs = torch.meshgrid(torch.arange(12, dtype=torch.int32),
                            torch.arange(16, dtype=torch.int32), indexing="ij")
    _, ro, rd = camera_rays(xs, ys, 0, 1.0, 16 / 12, width=16, height=12)
    checks, _ = program_bounds(prog, table, ro, rd, True)
    t1, _ = cast_tcull(prog, map_fn, ro, rd, checks)
    t8, _ = cast_tcull(prog, map_fn, ro, rd, checks, refresh_every=8)
    assert not torch.equal(t1, t8)  # the window moves some rays
    np.testing.assert_array_equal(
        t8.numpy(), _window_model(prog, map_fn, ro, rd, checks, 8).numpy())


def test_refresh_matches_pallas_interpret():
    jc, tc = pair("csg_demo")
    kw = dict(width=32, height=16, bounces=2, debug=0, frame=1,
              last_clear=0, **TCULL)
    with jax.disable_jit():  # op by op: faster than the one-off compile
        ref = np.asarray(render_frame_pallas(
            jc.spec, jnp.asarray(jc.params), refresh_every=4, interpret=True,
            tile=(16, 128), **kw))
    img = mk.render_frame_megakernel(tc.spec, torch.from_numpy(tc.params),
                                     refresh_every=4, **kw).numpy()
    assert np.isfinite(img).all()
    assert share_off(img, ref, 1e-2) <= 1e-2
    # JAX raises in the same place for omega != 1 and STEPS % K != 0.
    for bad in (dict(refresh_every=4, omega=1.5), dict(refresh_every=3)):
        with pytest.raises(ValueError):
            render_frame_pallas(jc.spec, jnp.asarray(jc.params),
                                interpret=True, tile=(16, 128),
                                **{**kw, **bad})
        with pytest.raises(ValueError):
            mk.render_frame_megakernel(tc.spec, torch.from_numpy(tc.params),
                                       **{**kw, **bad})


@pytest.mark.parametrize("mode", [
    dict(geometry="baked", debug=0),
    dict(geometry="faithful", debug=3),
    dict(TCULL, dist_grid=True, debug=0),
    dict(TCULL, debug=1),
    dict(TCULL, debug=2),
    dict(TCULL, debug=4),
    dict(TCULL, analytic_all=True, debug=0),
], ids=str)
def test_refresh_ignored_where_jax_ignores_it(mode):
    _, tc = pair("benchmark_16" if "analytic_all" in mode else "csg_demo")
    params = torch.from_numpy(tc.params)
    kw = dict(width=32, height=16, bounces=2, **mode)
    a = mk.render_frame_megakernel(tc.spec, params, **kw)
    for k in (3, 8):  # not even a divisor of STEPS is checked there
        b = mk.render_frame_megakernel(tc.spec, params, refresh_every=k, **kw)
        assert torch.equal(a, b)


def test_refresh_with_cap_and_rejections():
    _, tc = pair("csg_demo")
    params = torch.from_numpy(tc.params)
    kw = dict(width=32, height=16, bounces=2, analytic_unboxed=True, **TCULL)
    a = mk.render_frame_megakernel(tc.spec, params, **kw).numpy()
    b = mk.render_frame_megakernel(tc.spec, params, refresh_every=4,
                                   **kw).numpy()
    assert share_off(a, b, 1e-3) < 0.01
    with pytest.raises(ValueError, match="at least 1"):
        mk.render_frame_megakernel(tc.spec, params, refresh_every=0, **kw)
