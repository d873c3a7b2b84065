"""Port parity: parallel/mesh.py's sample sharding.

``render_samples_sharded`` over 4 ranks (threads, tests/test_torch_parallel.py:
``run_ranks``) of 2 frames each, on sphere_and_plane at 32x32 with 1 bounce,
is the port's 8-frame accumulation and JAX's ``render_samples_sharded``
within 1e-6 for ``backend="oracle"`` (``render.reference.
render_accumulated``) and 1e-5 for ``"kernel"`` (K2's plain version over
baked geometry, ``render_accumulated_megakernel``; JAX's ``"pallas"`` in
interpret mode), the JAX package's tolerances
(tests/test_samples_sharded.py:30, :69), and every rank holds the same mean.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compute_path_tracer_tpu.parallel import make_mesh as j_make_mesh
from compute_path_tracer_tpu.parallel import render_samples_sharded as j_samples
from compute_path_tracer_tpu_torch.kernels import megakernel as mk
from compute_path_tracer_tpu_torch.parallel import render_samples_sharded
from compute_path_tracer_tpu_torch.render.reference import render_accumulated
from test_torch_parallel import H, ORACLE_TOL, W, run_ranks, scenes

KERNEL_SAMPLES_TOL = 1e-5


@pytest.mark.parametrize("backend", ["oracle", "kernel"])
def test_samples_sharded(backend):
    jc, tc, params = scenes()
    n, fpd = 4, 2
    kw = dict(width=W, height=H, bounces=1)
    mode = dict(geometry="baked", t_cull=False)
    extra = mode if backend == "kernel" else {}
    got = run_ranks(n, lambda mesh: render_samples_sharded(
        tc.spec, params, mesh, frames_per_device=fpd, backend=backend,
        **extra, **kw))
    for img in got[1:]:
        assert torch.equal(img, got[0])
    if backend == "kernel":
        want = mk.render_accumulated_megakernel(tc.spec, params, n * fpd,
                                                **mode, **kw)
        tol = KERNEL_SAMPLES_TOL
    else:
        want = render_accumulated(tc.spec, params, n * fpd, **kw)
        tol = ORACLE_TOL
    np.testing.assert_allclose(got[0].numpy(), want.numpy(), rtol=0,
                               atol=tol)
    j_extra = dict(mode, backend="pallas", interpret=True) if (
        backend == "kernel") else {}
    j_img = np.asarray(j_samples(
        jc.spec, jnp.asarray(jc.params, jnp.float32), j_make_mesh(n),
        frames_per_device=fpd, **j_extra, **kw))
    np.testing.assert_allclose(got[0].numpy(), j_img, rtol=0, atol=tol)
