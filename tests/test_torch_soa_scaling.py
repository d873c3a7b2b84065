"""Port parity: the packed-table full-analytic mode ``analytic_soa`` (K5).

The JAX package's ``analytic_soa`` walks the packed tables of render/soa.py
at run time and is bit-exact with its ``analytic_all``
(tests/test_soa.py:164).  The port's K1 already walks those tables at run
time at any primitive count, so ``analytic_soa`` routes to K1 and its plain
version.  These tests hold that frame to the port's ``analytic_all`` frame
and to JAX's ``render_frame_pallas(analytic_soa=True, interpret=True)`` at
benchmark_scene(16), bit for bit, and to JAX ``render_frame_soa`` at
benchmark_scene(256), where the trace-unrolled modes do not reach
(tests/test_soa.py:146), under the contract of
tests/test_torch_megakernel.py (at most 0.5 % of pixels off by > 1e-2; it
measured bit-equal).  The rejections are JAX's ``ValueError``s.  The CUDA
kernel is held to the plain version on the card by chip_smoke.py, at 256
and 512 primitives.
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compute_path_tracer_tpu.kernels.megakernel import render_frame_pallas
from compute_path_tracer_tpu.render.soa import render_frame_soa
from compute_path_tracer_tpu.scene import compile_scene as j_compile
from compute_path_tracer_tpu.scene import library as j_lib
from compute_path_tracer_tpu_torch.kernels import megakernel as mk
from compute_path_tracer_tpu_torch.scene import compile_scene as t_compile
from compute_path_tracer_tpu_torch.scene import convert_scene

SOA = dict(geometry="baked", analytic_soa=True)


@lru_cache(maxsize=None)
def pair(name, n=16):
    scene = j_lib.benchmark_scene(n) if name == "bench" else getattr(j_lib, name)()
    return j_compile(scene), t_compile(convert_scene(scene))


def _port(tc, **kw):
    before = dict(mk.LAUNCHES)
    out = mk.render_frame_megakernel(tc.spec, torch.from_numpy(tc.params),
                                     **kw)
    assert mk.LAUNCHES == before  # CPU tensors never reach the kernels
    return out.numpy()


def test_soa_is_the_analytic_all_frame():
    _, tc = pair("bench")
    kw = dict(width=64, height=32, bounces=3, frame=2)
    np.testing.assert_array_equal(
        _port(tc, **SOA, **kw),
        _port(tc, geometry="baked", analytic_all=True, **kw))
    # debug 3 and a running mean take the same route.
    np.testing.assert_array_equal(
        _port(tc, debug=3, **SOA, **kw),
        _port(tc, debug=3, geometry="baked", analytic_all=True, **kw))


def test_soa_matches_pallas_interpret():
    jc, tc = pair("bench")
    kw = dict(width=64, height=32, bounces=2)
    a = np.asarray(render_frame_pallas(jc.spec, jc.params, interpret=True,
                                       **SOA, **kw))
    np.testing.assert_array_equal(_port(tc, **SOA, **kw), a)


def test_soa_256_prims_matches_jax():
    jc, tc = pair("bench", 256)
    assert tc.spec.n_shapes == 256
    kw = dict(width=32, height=16, bounces=2)
    # JAX's frame op by op: its XLA compile of the 256 unrolled shapes takes
    # about 100 s on this CPU, the same function run eagerly about 30 s.
    with jax.disable_jit():
        a = np.asarray(render_frame_soa(jc.spec, jc.params, fov=1.0, **kw))
    b = _port(tc, **SOA, **kw)
    assert np.isfinite(b).all() and b.max() > 0
    assert float((np.abs(a - b).max(axis=-1) > 1e-2).mean()) <= 5e-3


@pytest.mark.parametrize("kw", [
    dict(geometry="faithful", analytic_soa=True),
    dict(geometry="baked", analytic_soa=True, analytic_all=True),
    dict(geometry="baked", analytic_soa=True, analytic_unboxed=True,
         t_cull=True),
    dict(geometry="baked", analytic_soa=True, dist_grid=True, t_cull=True),
    dict(geometry="baked", analytic_soa=True, debug=1),
    dict(geometry="baked", analytic_soa=True, debug=2),
    dict(geometry="baked", analytic_soa=True, scene="csg_demo"),
], ids=str)
def test_rejections_match_jax(kw):
    kw = dict(kw)
    jc, tc = pair(kw.pop("scene", "bench"))
    args = dict(width=16, height=8, bounces=0, **kw)
    with pytest.raises(ValueError):
        render_frame_pallas(jc.spec, jnp.asarray(jc.params), interpret=True,
                            **args)
    with pytest.raises(ValueError):
        mk.render_frame_megakernel(tc.spec, torch.from_numpy(tc.params),
                                   **args)
