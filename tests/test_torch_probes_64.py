"""Port parity: the exact march probes (dense, ILP seq and fused) against
the JAX package's probe kernels on benchmark_scene(64), under
tests/test_torch_probes.py's tolerances (a file of its own: each JAX
interpret-mode call at 64 primitives takes about 20 s here)."""

import pytest

from test_torch_probes import check_exact_probe


@pytest.mark.parametrize("kind", ["dense", "seq", "fused"])
def test_exact_probes_match_jax_64(kind):
    check_exact_probe(kind, 64)
