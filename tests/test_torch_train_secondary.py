"""Port parity: the fused step's secondary edge rows (``edge_secondary``)
on benchmarks/secondary_edge.py's occluder scene (32x32, fov 3, one
bounce), and the analytic phase 1 with the primary edge term on
sphere_and_plane, against the JAX fused kernel.

The secondary estimator's march excludes per lane and culls nothing, in
JAX as in the port, so it agrees closely: the occluder's slot within 2 %
of JAX's value (measured 0.16 %).  On sphere_and_plane the edge term's
tile cull barely matters: cosine above 0.99999 (measured 0.9999974).
"""

import numpy as np

from test_torch_train_winner import jax_step, port_step, scenes

OCC = dict(bounces=1, fov=3.0)


def _slot():
    _, tc = scenes("occluder")
    return tc.spec.roots[0].children_shapes[2].transform.pos[1]


def test_occluder_secondary_matches_jax():
    s = _slot()
    l0, g0, _ = port_step("occluder", 32, 32, "zero", **OCC)
    l2, g2, _ = port_step("occluder", 32, 32, "zero", edge_grad=True,
                          edge_secondary=True, **OCC)
    lj, gj, _ = jax_step("occluder", 32, 32, "zero", tuple(sorted(dict(
        OCC, edge_grad=True, edge_secondary=True).items())))
    assert l0 == l2  # the loss does not depend on the edge terms
    assert g0[s] == 0.0 and gj[s] != 0.0
    assert abs(g2[s] - gj[s]) < 0.02 * abs(gj[s])
    np.testing.assert_allclose(l2, lj, rtol=1e-5)


def test_analytic_edge_sphere_and_plane_matches_jax():
    kw = (("analytic_all", True), ("bounces", 1), ("edge_grad", True))
    lj, gj, _ = jax_step("sphere_and_plane", 32, 16, "noise", kw)
    lt, gt, _ = port_step("sphere_and_plane", 32, 16, "noise", **dict(kw))
    assert abs(lt - lj) < 1e-6
    cos = float(gt @ gj / (np.linalg.norm(gt) * np.linalg.norm(gj)))
    assert cos > 0.99999
