"""Port parity: the exact normal (``normals="autodiff"``) against the JAX
package.

* ``render/program.py:make_grad_program`` (the plain version of K2's and
  K6's exact-gradient walk, csg_program.cuh:grad_exact_walk) against JAX's
  reverse-mode gradient of its own distance map (``make_map_baked_d``,
  ``make_map_culled_d``: the map JAX's megakernel differentiates, under
  per-lane guards), on scattered points with random guard bits, with and
  without the analytic_unboxed caps folded in (JAX differentiates the map
  with those shapes in it);
* the port's oracle ``render_frame(..., normals="autodiff")`` (autograd of
  the oracle map) and the plain K2 frame in debug 1 against JAX's oracle
  ``render_frame(..., debug=1, normals="autodiff")`` on csg_demo
  (subtraction, guard skips) and blend_demo (smooth union), faithful and
  baked.

The tolerances: the gradients are float32 sums taken in other orders, so
they agree to a few ulps of 1 (measured at most 9e-7); on hit lanes the
normals must agree within 1e-4, and at most 0.2 % of the lanes may be off
by more than 1e-3 (a hit point on a tie kink of min, max or abs, where the
rules split or choose the gradient, may take another side).
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compute_path_tracer_tpu.render import baked as jb
from compute_path_tracer_tpu.render import render_frame as j_render_frame
from compute_path_tracer_tpu.render import scenegen as jsg
from compute_path_tracer_tpu.vecmath import Vec3 as JVec3
from compute_path_tracer_tpu_torch.kernels import megakernel as mk
from compute_path_tracer_tpu_torch.render.program import (
    OPC_SHAPE,
    build_program,
    make_grad_program,
    program_table,
)
from compute_path_tracer_tpu_torch.render.reference import render_frame
from compute_path_tracer_tpu_torch.vecmath import Vec3
from test_torch_sdf import pair

N_POINTS = 2000
GRAD_TOL = 4e-6
NORMAL_TOL, FAR_TOL, FAR_SHARE = 1e-4, 1e-3, 2e-3
W = H = 32


@pytest.mark.parametrize("geometry,caps", [("faithful", False),
                                           ("baked", False),
                                           ("baked", True)])
@pytest.mark.parametrize("name", ["csg_demo", "blend_demo", "benchmark_16",
                                  "clobber"])
def test_grad_program_matches_jax_map_gradient(name, geometry, caps):
    jc, tc = pair(name)
    rng = np.random.default_rng(7)
    pts = rng.uniform(-3.0, 3.0, (3, N_POINTS)).astype(np.float32)
    prog = build_program(tc.spec, geometry, caps)
    guard = rng.random((N_POINTS, prog.n_boxed)) < 0.7
    checks = [None] * jc.spec.n_shapes
    boxed = [int(op[4]) for op in prog.ops if op[0] == OPC_SHAPE and op[3] >= 0]
    for j, sid in enumerate(boxed):
        checks[sid] = jnp.asarray(guard[:, j])
    if geometry == "baked":
        bv = jb.bake(jc.spec, jnp.asarray(jc.params))
        jmap = jb.make_map_baked_d(jc.spec)

        def dist(x, y, z):
            return jmap(JVec3(x, y, z), bv, tuple(checks), None)
    else:
        jmap = jsg.make_map_culled_d(jc.spec)

        def dist(x, y, z):
            return jmap(JVec3(x, y, z), jnp.asarray(jc.params), tuple(checks),
                        None)
    d_ref, vjp = jax.vjp(dist, *map(jnp.asarray, pts))
    g_ref = np.stack([np.asarray(g) for g in vjp(jnp.ones_like(d_ref))])

    table = program_table(prog, torch.from_numpy(tc.params))
    count = {}
    d, g = make_grad_program(prog, table.tolist(), count)(
        Vec3(*map(torch.from_numpy, pts)), torch.from_numpy(guard))
    assert caps == bool(prog.caps.shape[0]) or name == "clobber"
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(torch.stack(list(g)).numpy(), g_ref, rtol=0,
                               atol=GRAD_TOL)
    assert int(count["grad_taps"]) == N_POINTS
    n_leaves = sum(int(v) for k, v in count.items() if isinstance(k, tuple))
    boxed_evals = int(guard.sum())
    free = int(((prog.ops[:, 0] == OPC_SHAPE) & (prog.ops[:, 3] < 0)).sum())
    assert n_leaves == boxed_evals + N_POINTS * (free + prog.caps.shape[0])


@lru_cache(maxsize=None)
def jax_normals(name, geometry):
    jc, _ = pair(name)
    with jax.disable_jit():  # op by op: about half the compile's time
        return np.asarray(j_render_frame(
            jc.spec, jnp.asarray(jc.params), width=W, height=H, debug=1,
            geometry=geometry, normals="autodiff"))


@pytest.mark.parametrize("geometry", ["faithful", "baked"])
@pytest.mark.parametrize("name", ["csg_demo", "blend_demo"])
def test_autodiff_normals_match_jax_oracle(name, geometry):
    ref = jax_normals(name, geometry)
    _, tc = pair(name)
    params = torch.from_numpy(tc.params)
    kw = dict(width=W, height=H, debug=1, geometry=geometry,
              normals="autodiff")
    before = dict(mk.LAUNCHES)
    frames = {"oracle": render_frame(tc.spec, params, **kw),
              "plain K2": mk.render_frame_megakernel(tc.spec, params, **kw)}
    assert mk.LAUNCHES == before
    central = render_frame(tc.spec, params, width=W, height=H, debug=1,
                           geometry=geometry).numpy()
    # A miss shows the grey tint alone; a hit (n * 0.5 + 0.5) * 0.2 + tint.
    hit = ~((ref[..., 0] == ref[..., 1]) & (ref[..., 1] == ref[..., 2]))
    assert hit.mean() > 0.3
    for label, img in frames.items():
        img = img.numpy()
        assert np.isfinite(img).all()
        err = np.abs(img - ref).max(axis=-1) / 0.1  # the normal's error
        far = float((err > FAR_TOL).mean())
        assert far <= FAR_SHARE, (label, far)
        near = err[hit & (err <= FAR_TOL)]
        assert near.max() <= NORMAL_TOL, (label, float(near.max()))
        # The exact normal is not the central difference.
        assert np.abs(img - central).max() > 1e-6, label
