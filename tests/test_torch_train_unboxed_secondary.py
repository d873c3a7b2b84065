"""Port parity: the fused train step with ``analytic_unboxed`` and both edge
terms (``edge_grad``, ``edge_secondary``) against the JAX package's
``make_fused_value_and_grad(..., interpret=True)``.

The secondary exclusion march reads every leaf of the full baked program,
the shapes the cap skips included (JAX ``_make_excl_closest``): on
benchmark_scene(8) the two lamps and the ground plane are skipped, and the
march that leaves them out would miss the lamps' secondary edges.  Held to
tests/test_torch_train_winner.py's tolerances: loss within 1e-6, image
within 1e-5, gradient within rtol 1e-3 and atol 1e-4 of the largest JAX
entry (measured: 6.6e-5 of the largest entry, cosine 0.99999994).  In its
own file so that its JAX compile runs beside the other unboxed tests.
"""

import numpy as np

from test_torch_train_winner import check


def test_winner_unboxed_secondary_matches_jax():
    gt, _ = check("bench8", 32, 16, bounces=1, analytic_unboxed=True,
                  edge_grad=True, edge_secondary=True)
    assert np.abs(gt).max() > 0
