"""Port parity: the gradient probes (kernels/grad_probes.py) against the JAX
package's probe kernels (benchmarks/probe_fused_bwd.py,
probe_inkernel_segsum.py), each run through ``pl.pallas_call(...,
interpret=True)`` with tests/test_torch_hw_probes.py's swap of the loaded
module's ``pl``; the fused-bwd probe on ``benchmark_scene(4)`` (its
``N_PRIMS``), the segment sum at the probe's shape and at a K4-like one
(its ``C``).  ``jax.jit`` of the loaded fused-bwd module hands over
its outputs.  No file under benchmarks/ changes.

On the CPU each entry point runs its plain version; chip_smoke.py holds the
CUDA kernels to them on the card.  Tolerances, with their reasons:

* fused-bwd loss: 1e-6 relative.  Each pixel's term (emit + thr_factor /
  ray_prob) is a function of the winner's material alone, so a term moves
  only if a hit or a winner flips, which the probe tile's rays do not; the
  two float32 sums over the 8,192 pixels differ in order only;
* fused-bwd gradient: exactly zero and finite in both, of the baked
  vector's shape: the loss does not depend on the baked vector;
* segment sum: the probe's own bound, max |port - JAX| / max |JAX| < 1e-5
  (the one-hot matmul and index_add_ sum in other orders).
"""

import types

import jax
import numpy as np
import pytest
import torch

from compute_path_tracer_tpu_torch.benchmarks import probe_inkernel_segsum
from compute_path_tracer_tpu_torch.kernels import grad_probes as gp
from compute_path_tracer_tpu_torch.kernels.train import MAT_CHANNELS
from compute_path_tracer_tpu_torch.render.baked import bake
from compute_path_tracer_tpu_torch.scene import (
    benchmark_scene, compile_scene, params_from_numpy)
from test_torch_hw_probes import _interpreting, _probe

N_PRIMS = 4
SEG_PROBE = probe_inkernel_segsum.PROBE


def _jitting_into(record):
    """A ``jax`` namespace whose ``jit`` appends each call's outputs to
    ``record``."""
    ns = types.SimpleNamespace(**{k: getattr(jax, k) for k in dir(jax)
                                  if not k.startswith("_")})

    def jit(fn):
        compiled = jax.jit(fn)

        def run(*args):
            out = compiled(*args)
            record.append([np.asarray(o) for o in out])
            return out
        return run

    ns.jit = jit
    return ns


@pytest.fixture(scope="module")
def fused_bwd_pair():
    """(JAX (loss, grad), the port's plain (loss, grad)) on
    benchmark_scene(N_PRIMS)."""
    mod = _interpreting(_probe("probe_fused_bwd", N_PRIMS=N_PRIMS))
    record = []
    mod.jax = _jitting_into(record)
    assert mod.main() == 0
    cs = compile_scene(benchmark_scene(N_PRIMS))
    params = params_from_numpy(cs.params, cs.spec, "cpu")
    before = dict(gp.LAUNCHES)
    loss, grad = gp.fused_bwd(cs.spec, params, bake(cs.spec, params))
    assert gp.LAUNCHES == before
    return record[0], (loss.numpy(), grad.numpy())


def test_fused_bwd_loss_matches_jax(fused_bwd_pair):
    (j_loss, _), (loss, _) = fused_bwd_pair
    assert loss.shape == j_loss.shape == (1,)
    np.testing.assert_allclose(loss, j_loss, rtol=1e-6, atol=0)


def test_fused_bwd_gradient_is_zero_as_jax(fused_bwd_pair):
    (_, j_grad), (_, grad) = fused_bwd_pair
    assert grad.shape == j_grad.shape
    assert np.isfinite(grad).all() and np.isfinite(j_grad).all()
    assert not grad.any() and not j_grad.any()


def test_fused_bwd_tiles_sum_to_their_rectangle():
    """The loss over a rectangle is the sum of its tiles' losses."""
    cs = compile_scene(benchmark_scene(N_PRIMS))
    params = params_from_numpy(cs.params, cs.spec, "cpu")
    bv = bake(cs.spec, params)
    whole, _ = gp.fused_bwd(cs.spec, params, bv, (896, 480, 128, 96))
    parts = [gp.fused_bwd(cs.spec, params, bv, (896, 480 + y, 128, 32))[0]
             for y in (0, 32, 64)]
    np.testing.assert_allclose(whole.numpy(), sum(p.numpy() for p in parts),
                               rtol=1e-6)
    with pytest.raises(ValueError):
        gp.fused_bwd(cs.spec, params, bv, (1900, 0, 128, 64))
    with pytest.raises(ValueError):
        gp.fused_bwd(cs.spec, params.to("meta"), bv.to("meta"))


def _segsum_pair(**consts):
    """(JAX probe output, the port's plain sum) on the probe's data for
    its shape with ``consts`` set."""
    mod = _probe("probe_inkernel_segsum", **consts)
    record = []
    _interpreting(mod, record)
    assert mod.main() is None
    shape = dict(SEG_PROBE, n_seg=mod.S, n_ch=mod.C, h=mod.H, w=mod.W)
    idx, cot = probe_inkernel_segsum.inputs(shape, "cpu")
    return record[-1], gp.segsum(idx, cot, mod.S).numpy()


# K4's main configuration sums its MAT_CHANNELS over benchmark_scene(64)'s
# 64 shapes, the probe's S.
@pytest.mark.parametrize("consts", [{}, {"C": len(MAT_CHANNELS)}],
                         ids=["probe", "k4_like"])
def test_segsum_matches_jax(consts):
    want, got = _segsum_pair(**consts)
    assert got.shape == want.shape
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5


def test_segsum_sums_over_bounces():
    """Several planes (bounces) add up, and dropped ids add nothing."""
    shape = dict(n_seg=9, n_ch=5, n_b=3, h=16, w=32)
    idx, cot = probe_inkernel_segsum.inputs(shape, "cpu", seed=4)
    got = gp.segsum(idx, cot, 9).numpy()
    i, c = idx.numpy().reshape(-1), cot.numpy().astype(np.float64)
    c = c.transpose(0, 2, 1).reshape(-1, 5)
    want = np.stack([c[i == s].sum(0) for s in range(9)])
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-6
    with pytest.raises(ValueError):
        gp.segsum(idx.to(torch.int64), cot, 9)
