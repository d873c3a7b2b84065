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
