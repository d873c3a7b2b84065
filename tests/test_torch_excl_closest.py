"""Port parity: the secondary edge estimator's exclusion march (the fused
step's ``edge_secondary``) on its own, against the JAX package.

The plain ``_excl_closest`` (compute_path_tracer_tpu_torch/kernels/train.py)
is held to JAX ``_make_excl_closest`` on the same inputs, taken from
SECONDARY rays of benchmark_scene(16): primary rays marched with the port's
plain exact march, reflected about their 6-tap normal and respawned OFFSET
along it, as a specular bounce is.  Each ray excludes the shape its own
march hits and the shape it respawned from, stops at its own hit distance,
and folds its guarded leaves under its bounce's AABB checks.  The fused
step's whole-step anchor (tests/test_torch_train_unboxed_secondary.py) is
32x16 with one bounce; this one covers the 1,081 reflected rays of the
2,048 primary rays at 64x32.

Tolerances: the winner ``i_min`` equal on every ray; ``d_min`` and
``t_min`` within 2e-5 absolute (XLA contracts the leaves' multiply-adds,
which the port does not; measured up to 7.6e-6 and 3.8e-6, on 191 and 52
of the rays).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compute_path_tracer_tpu.kernels.train import _make_excl_closest
from compute_path_tracer_tpu.render.baked import bake as j_bake
from compute_path_tracer_tpu.scene import compile_scene as j_compile
from compute_path_tracer_tpu.scene import library as j_lib
from compute_path_tracer_tpu.vecmath import Vec3 as JVec3
from compute_path_tracer_tpu_torch.constants import FP, OFFSET
from compute_path_tracer_tpu_torch.kernels.train import _excl_closest, _leaves
from compute_path_tracer_tpu_torch.render.program import (
    build_program,
    make_map_program,
    program_bounds,
    program_table,
)
from compute_path_tracer_tpu_torch.render.reference import (
    calc_normal,
    camera_rays,
    cast_ray,
)
from compute_path_tracer_tpu_torch.scene import compile_scene as t_compile
from compute_path_tracer_tpu_torch.scene import convert_scene
from compute_path_tracer_tpu_torch.vecmath import Vec3, reflect

W, H = 64, 32
D_TOL = 2e-5


@pytest.fixture(scope="module")
def secondary():
    """The reflected rays of the primary hits, their guards, the two ids
    each excludes and its stop distance, with the scene on both sides."""
    scene = j_lib.benchmark_scene(16)
    jc, tc = j_compile(scene), t_compile(convert_scene(scene))
    params = torch.from_numpy(np.asarray(tc.params, np.float32))
    prog = build_program(tc.spec, "baked")
    table = program_table(prog, params, True)
    map_fn = make_map_program(prog, table.tolist())

    def mapc(p, c):
        return map_fn(p, c[0])

    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.int32),
                            torch.arange(W, dtype=torch.int32), indexing="ij")
    _, ro, rd = camera_rays(xs, ys, 0, 1.0, W / H, width=W, height=H)
    chk0, _ = program_bounds(prog, table, ro, rd, False)
    t0, id0 = cast_ray(mapc, ro, rd, chk0)
    hit = ~(t0 > FP)
    ro, rd, t0, id0 = (Vec3(*(c[hit] for c in ro)), Vec3(*(c[hit] for c in rd)),
                       t0[hit], id0[hit])
    hp = ro + rd * t0
    n = calc_normal(mapc, hp, (chk0[0][hit],))
    ro2, rd2 = hp + n * OFFSET, reflect(rd, n).normalize_safe()
    chk2, _ = program_bounds(prog, table, ro2, rd2, False)
    t2, id2 = cast_ray(mapc, ro2, rd2, chk2)
    return jc, tc, prog, table, ro2, rd2, chk2[0], id2, id0, t2


def test_excl_closest_matches_jax_on_reflected_rays(secondary):
    jc, tc, prog, table, ro, rd, chk, e1, e2, t_stop = secondary
    assert ro.x.shape[0] > 1000 and bool((e1 >= 0).any())
    d_t, t_t, i_t = _excl_closest(_leaves(prog, table.tolist()), ro, rd, chk,
                                  e1, e2, t_stop)

    # JAX reads a shape's per-lane check by shape id and skips a guarded
    # shape's block when no lane's box test passes.
    box_of = {op[4]: op[3] for op in prog.ops.tolist() if op[0] == 1}
    checks, anyhit = [], []
    for sid in range(tc.spec.n_shapes):
        box = box_of.get(sid, -1)
        if box < 0:
            checks.append(None)
            anyhit.append(None)
        else:
            c = jnp.asarray(chk[:, box].numpy())
            checks.append(c)
            anyhit.append(jnp.any(c))
    bv = j_bake(jc.spec, jnp.asarray(jc.params, jnp.float32))

    def j(v):
        return jnp.asarray(v.numpy())

    d_j, t_j, i_j = _make_excl_closest(jc.spec)(
        JVec3(*(j(c) for c in ro)), JVec3(*(j(c) for c in rd)), bv,
        tuple(checks), tuple(anyhit), j(e1), j(e2),
        jnp.ones(ro.x.shape, bool), j(t_stop))
    d_j, t_j, i_j = (np.asarray(a) for a in (d_j, t_j, i_j))
    assert (i_t.numpy() >= 0).mean() > 0.5
    np.testing.assert_array_equal(i_t.numpy(), i_j)
    np.testing.assert_allclose(d_t.numpy(), d_j, rtol=0, atol=D_TOL)
    np.testing.assert_allclose(t_t.numpy(), t_j, rtol=0, atol=D_TOL)
