"""Port parity: RNG, camera and AABB ops against the JAX package.

The RNG must be bit-exact (it is part of the semantics: the Monte-Carlo
images of the two packages are comparable only because they draw the same
numbers); camera and slab math agree to 1e-7.  Inputs come from numpy with
fixed seeds and go through both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compute_path_tracer_tpu.ops import aabb as jaabb
from compute_path_tracer_tpu.ops import camera as jcam
from compute_path_tracer_tpu.ops import rng as jrng
from compute_path_tracer_tpu.vecmath import Vec3 as JVec3
from compute_path_tracer_tpu_torch.ops import aabb as taabb
from compute_path_tracer_tpu_torch.ops import camera as tcam
from compute_path_tracer_tpu_torch.ops import rng as trng
from compute_path_tracer_tpu_torch.vecmath import Vec3 as TVec3


def _states(n=100_000, seed=0):
    s = np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint64)
    s = s.astype(np.uint32)
    s[:2] = (0, 2**32 - 1)
    return s


def _u32(j):
    return np.asarray(j).astype(np.int64)


def test_wang_hash_bit_exact():
    s = _states()
    j = _u32(jrng.wang_hash(jnp.asarray(s)))
    t = trng.wang_hash(torch.from_numpy(s.astype(np.int64))).numpy()
    assert np.array_equal(j, t)


def test_random_float01_bit_exact():
    js = jnp.asarray(_states(seed=1))
    ts = torch.from_numpy(np.asarray(js).astype(np.int64))
    for _ in range(3):
        js, jv = jrng.random_float01(js)
        ts, tv = trng.random_float01(ts)
        assert np.array_equal(_u32(js), ts.numpy())
        assert tv.dtype == torch.float32
        assert np.array_equal(np.asarray(jv).view(np.uint32),
                              tv.numpy().view(np.uint32))


@pytest.mark.parametrize("width,height,frame",
                         [(128, 64, 0), (1920, 1080, 7), (33, 17, 2**31 - 1)])
def test_gen_rng_bit_exact(width, height, frame):
    ys, xs = np.meshgrid(np.arange(height, dtype=np.int32),
                         np.arange(width, dtype=np.int32), indexing="ij")
    j = _u32(jrng.gen_rng(jnp.asarray(xs), jnp.asarray(ys), frame, width,
                          height))
    t = trng.gen_rng(torch.from_numpy(xs), torch.from_numpy(ys), frame, width,
                     height).numpy()
    assert np.array_equal(j, t)


def test_random_unit_vector():
    s = _states(20_000, seed=2)
    js, jv = jrng.random_unit_vector(jnp.asarray(s))
    ts, tv = trng.random_unit_vector(torch.from_numpy(s.astype(np.int64)))
    assert np.array_equal(_u32(js), ts.numpy())
    for a, b in zip(jv, tv):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6)


def test_camera():
    r = np.random.default_rng(3)
    px = (r.uniform(0, 1920, 4096)).astype(np.float32)
    py = (r.uniform(0, 1080, 4096)).astype(np.float32)
    ju, jv = jcam.calc_uv(jnp.asarray(px), jnp.asarray(py), 1920, 1080,
                          1920 / 1080)
    tu, tv = tcam.calc_uv(torch.from_numpy(px), torch.from_numpy(py), 1920,
                          1080, 1920 / 1080)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0, atol=1e-7)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-7)
    jro, jrd = jcam.primary_ray(ju, jv, 1.3)
    tro, trd = tcam.primary_ray(tu, tv, 1.3)
    for a, b in zip(tuple(jro) + tuple(jrd), tuple(tro) + tuple(trd)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-7)


def test_aabb_slab():
    r = np.random.default_rng(4)
    n = 8192
    ro = r.uniform(-3, 3, (n, 3)).astype(np.float32)
    rd = r.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    lo = r.uniform(-2, 0, (n, 3)).astype(np.float32)
    hi = lo + r.uniform(0.1, 2, (n, 3)).astype(np.float32)
    # Axis-parallel rays, some starting exactly on a box face: 0/0 = NaN in
    # the slab, which the reference semantics turn into a miss.
    rd[:64] = (0.0, 0.0, 1.0)
    ro[:32, 0] = lo[:32, 0]
    ro[32:48, 1] = hi[32:48, 1]

    def j3(a):
        return JVec3(*(jnp.asarray(a[:, i]) for i in range(3)))

    def t3(a):
        return TVec3(*(torch.from_numpy(a[:, i].copy()) for i in range(3)))

    jn, jf = jaabb.intersect_aabb(j3(ro), j3(rd), j3(lo), j3(hi))
    tn, tf = taabb.intersect_aabb(t3(ro), t3(rd), t3(lo), t3(hi))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=0, atol=1e-7)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=1e-7)
    jh = np.asarray(jaabb.aabb_hit(jn, jf))
    th = taabb.aabb_hit(tn, tf).numpy()
    assert np.array_equal(jh, th)
    assert np.isnan(tn.numpy()[:48]).any() and not th[:32].any()


# -- no division by a host scalar in the plain frames --------------------------
#
# torch on CUDA computes ``tensor / python_number`` as a multiply by the
# number's float32 reciprocal, an ulp off the true quotient that the CPU, XLA
# and the CUDA kernels compute.  In calc_uv that moved a few primary rays and
# flipped a lamp's edge pixel between K2 and its plain version on the card
# (profile_main.py --mode parity), so the plain versions divide through
# vecmath.div_exact.  These tests pin that form on the CPU: no plain frame
# path divides by a Python number.

_DIVISIONS = {torch.Tensor.__truediv__, torch.Tensor.__itruediv__,
              torch.Tensor.div, torch.Tensor.div_, torch.div, torch.true_divide}


class _ScalarDivisions(torch.overrides.TorchFunctionMode):
    """Records every division whose divisor is not a tensor."""

    def __init__(self):
        super().__init__()
        self.seen = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in _DIVISIONS and not isinstance(args[1], torch.Tensor):
            self.seen += 1
        return func(*args, **(kwargs or {}))


def test_calc_uv_divides_exactly():
    px = torch.from_numpy(np.random.default_rng(0).uniform(
        -0.5, 320.5, 4096).astype(np.float32))
    with _ScalarDivisions() as scan:
        u, v = tcam.calc_uv(px, px, 320, 180, 320 / 180)
        torch.ones(2) / 3.0  # the scan sees a host-scalar division
    assert scan.seen == 1
    want = (px.numpy() / np.float32(320)) * np.float32(2) - np.float32(1)
    np.testing.assert_array_equal(u.numpy(), want * np.float32(320 / 180))


@pytest.mark.parametrize("scene,mode,debug", [
    ("blend_demo", dict(geometry="faithful"), 0),
    ("blend_demo", dict(geometry="faithful"), 1),
    ("blend_demo", dict(geometry="baked", t_cull=True, dist_grid=True), 3),
    ("bench8", dict(geometry="baked", analytic_all=True), 0),
    ("bench8", dict(geometry="baked", t_cull=True, analytic_unboxed=True), 0),
    ("bench8", dict(geometry="baked", t_cull=True, omega=1.5), 3),
    ("bench8", "fused", 0),
], ids=str)
def test_plain_frames_divide_by_no_host_scalar(scene, mode, debug):
    from compute_path_tracer_tpu_torch.kernels import megakernel as mk
    from compute_path_tracer_tpu_torch.kernels import train as tm
    from compute_path_tracer_tpu_torch.scene import (
        benchmark_scene, blend_demo, compile_scene, params_from_numpy)

    cs = compile_scene(blend_demo() if scene == "blend_demo"
                       else benchmark_scene(8))
    params = params_from_numpy(cs.params, cs.spec, "cpu")
    with _ScalarDivisions() as scan:
        if mode == "fused":
            tm.make_fused_value_and_grad(
                cs.spec, torch.zeros(8, 16, 3), width=16, height=8,
                bounces=2, edge_grad=True, edge_secondary=True)(params)
        else:
            mk.render_frame_megakernel_plain(cs.spec, params, width=16,
                                             height=8, bounces=3, debug=debug,
                                             **mode)
    assert scan.seen == 0
