"""Port parity: the primary silhouette term of the autograd path
(``edge_grad=True``) against JAX ``make_loss`` with a bounce:
tests/test_diff.py's sphere over a plane at 16x16, 1 bounce, the target
0.9 times the image, through both marches.  The cases, the scenes and the
tolerances (the image bit for bit without the term and within 1e-6 of
JAX's; the gradient within 1e-4 of the largest JAX entry, a cosine above
1 - 1e-6) are tests/test_torch_edge_grad.py's; the file splits its JAX
reverse-mode compiles across test workers.
"""

import pytest

from test_torch_edge_grad import CASES, check_edge_gradient


@pytest.mark.parametrize("case", sorted(CASES))
def test_sphere_over_plane_edge_gradient_matches_jax(case):
    check_edge_gradient("sphere_plane", 1, case)
