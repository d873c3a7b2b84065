"""Port parity: K2's and K6's ``normals="autodiff"`` (the exact-gradient
walk's plain version, ``render_frame_megakernel_plain``) against the JAX
megakernel in interpret mode, and its contracts with the other modes.

* debug 0 and 1 of a 16x16 baked t-culled frame of csg_demo with 2
  bounces, and debug 0 with ``analytic_unboxed`` (csg_demo's two
  guard-less shapes are capped: JAX differentiates the map with them),
  against ``render_frame_pallas(..., normals="autodiff",
  interpret=True)``, held to the share bound of the port's t-culled frames
  against JAX (tests/test_torch_march.py: at most 1 % of pixels off by
  more than 1e-2; JAX's t-cull is per tile, the port's per ray);
* the exact normal within JAX's own 2e-3 of the 6-tap image
  (tests/test_baked.py:104-117, csg_demo at 64x64, both geometries);
* K1 and K5 (analytic_all, analytic_soa), which take closed-form normals,
  bit for bit the same frame under either ``normals``, as in JAX;
* debug 4's z (the normal taps' count) and K6 (``dist_grid``) under the
  exact normal.
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compute_path_tracer_tpu.kernels.megakernel import render_frame_pallas
from compute_path_tracer_tpu_torch.kernels import megakernel as mk
from test_torch_sdf import pair

SHARE_TOL, SHARE_LIMIT = 1e-2, 1e-2
KW = dict(width=16, height=16, bounces=2, frame=1, last_clear=0,
          geometry="baked", t_cull=True)


def share_off(a, b, tol=SHARE_TOL):
    return float((np.abs(a - b).max(axis=-1) > tol).mean())


@lru_cache(maxsize=None)
def jax_frame(name, debug, unboxed):
    jc, _ = pair(name)
    with jax.disable_jit():  # op by op: faster than the one-off compile
        return np.asarray(render_frame_pallas(
            jc.spec, jnp.asarray(jc.params), debug=debug, normals="autodiff",
            analytic_unboxed=unboxed, interpret=True, tile=(16, 128), **KW))


@pytest.mark.parametrize("name,debug,unboxed", [("csg_demo", 0, False),
                                                ("csg_demo", 1, False),
                                                ("csg_demo", 0, True)])
def test_exact_frame_matches_pallas_interpret(name, debug, unboxed):
    ref = jax_frame(name, debug, unboxed)
    _, tc = pair(name)
    params = torch.from_numpy(tc.params)
    before = dict(mk.LAUNCHES)
    img = mk.render_frame_megakernel(tc.spec, params, debug=debug,
                                     normals="autodiff",
                                     analytic_unboxed=unboxed, **KW).numpy()
    assert mk.LAUNCHES == before
    assert np.isfinite(img).all() and img.shape == ref.shape
    assert share_off(img, ref) <= SHARE_LIMIT
    if debug == 1:
        # The normals themselves: JAX's reverse-mode gradient and the
        # port's forward-mode walk agree to float rounding on every hit.
        np.testing.assert_allclose(img, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("geometry", ["faithful", "baked"])
def test_exact_normal_near_central(geometry):
    _, tc = pair("csg_demo")
    params = torch.from_numpy(tc.params)
    kw = dict(width=64, height=64, debug=1, geometry=geometry)
    base = mk.render_frame_megakernel(tc.spec, params, **kw)
    exact = mk.render_frame_megakernel(tc.spec, params, normals="autodiff",
                                       **kw)
    np.testing.assert_allclose(exact.numpy(), base.numpy(), rtol=0, atol=2e-3)
    assert not torch.equal(exact, base)


@pytest.mark.parametrize("mode", [dict(analytic_all=True),
                                  dict(analytic_soa=True)], ids=str)
def test_closed_form_kernels_ignore_normals(mode):
    _, tc = pair("benchmark_16")
    params = torch.from_numpy(tc.params)
    kw = dict(width=24, height=16, bounces=3, geometry="baked", **mode)
    for debug in (0, 3):
        a = mk.render_frame_megakernel(tc.spec, params, debug=debug, **kw)
        b = mk.render_frame_megakernel(tc.spec, params, debug=debug,
                                       normals="autodiff", **kw)
        assert torch.equal(a, b)


def test_debug4_and_grid_take_the_exact_normal():
    _, tc = pair("csg_demo")
    params = torch.from_numpy(tc.params)
    kw = dict(width=32, height=16, bounces=3, geometry="baked", t_cull=True)
    exact = mk.render_frame_megakernel(tc.spec, params, debug=4,
                                       normals="autodiff", **kw)
    assert exact[..., 2].sum() > 0
    # One bounce's march and normal taps do not depend on the normal: z
    # counts six taps' shapes whatever the normal, as JAX counts.
    one = dict(kw, bounces=0)
    assert torch.equal(
        mk.render_frame_megakernel(tc.spec, params, debug=4, **one),
        mk.render_frame_megakernel(tc.spec, params, debug=4,
                                   normals="autodiff", **one))
    stats = mk.MarchStats()
    img = mk.render_frame_megakernel_plain(tc.spec, params, debug=0,
                                           normals="autodiff", stats=stats,
                                           **kw)
    assert torch.equal(stats.image(), exact)
    grid = mk.render_frame_megakernel(tc.spec, params, dist_grid=True,
                                      normals="autodiff", **kw)
    assert share_off(grid.numpy(), img.numpy()) <= SHARE_LIMIT
    with pytest.raises(ValueError, match="normals"):
        mk.render_frame_megakernel(tc.spec, params, normals="forward", **kw)
