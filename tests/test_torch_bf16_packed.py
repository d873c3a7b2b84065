"""Port parity: the packed bf16 march (kernels/csrc/hw_probes.cu,
``bf16_march<1>`` and ``<2>``) against its plain version
(kernels/hw_probes.py:bf16_march_plain) and the JAX package's probe
kernels (benchmarks/bf16_probe.py).

The bf16 kernels march two reps of a ray in the two halves of
``__nv_bfloat162`` pairs: rep r in the low half and r + 1 in the high half,
an odd last rep in both halves (the low one kept), each t added to the
float32 sum in rep order.  Each half's root is ``sqrt.approx.f32`` of its
float32 value, rounded to bf16.  These tests hold, bit for bit:

* a plain model of that schedule, written here, to ``bf16_march_plain`` for
  the bf16 map (V = 1) and bf16 end to end (V = 2), at odd and even reps,
  at one and two tiles, and its sum over an odd rep count to JAX's kernels
  in interpret mode;
* the approximate root to the correctly rounded one over every finite
  non-negative bf16 value: the root the kernel takes lies within the PTX
  ISA's bound for ``sqrt.approx.f32`` of the exact root (maximum relative
  error 2^-23 over the entire range), and no float32 value that close
  rounds to another bf16 value than the exact root does;
* ``bf16_roots``' plain version, which chip_smoke.py holds the card's roots
  to, to the correctly rounded roots of numpy.

chip_smoke.py checks on the card that the kernel's roots of every bf16 bit
pattern below 0x8000 are the IEEE path's, and holds the kernels to
``bf16_march_plain``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from compute_path_tracer_tpu_torch.kernels import hw_probes as hp
from compute_path_tracer_tpu_torch.vecmath import div_exact
from test_torch_hw_probes import H, _bf16_inputs, _probe

STEPS = 16
# The PTX ISA's maximum relative error of sqrt.approx.f32 over its whole
# range.
SQRT_APPROX_REL_ERR = 2.0 ** -23


def _root(sq):
    """The kernel's root of each bf16 half: the correctly rounded bf16 root
    (the float64 root rounded: float64 holds more than 2 x 8 + 2 bits)."""
    return torch.sqrt(sq.double()).to(torch.bfloat16)


def _map_halves(px, py, pz, sph):
    """The 12-sphere map on (2, tiles, H, 128) bf16 points, the halves in
    the leading dimension, each sphere value in both halves."""
    bf = torch.bfloat16
    d = torch.full_like(px, 100.0)
    for s in range(hp.N_SPHERES):
        sx, sy, sz, sr = (sph[:, s, k].to(bf)[None, :, None, None]
                          for k in range(4))
        ex, ey, ez = px - sx, py - sy, pz - sz
        sq = (ex * ex + ey * ey) + ez * ez
        d = torch.minimum(d, _root(sq) - sr)
    return d


def _march_pair(ro, rd, sph, variant, reps, steps):
    """Reps ``reps`` = (ra, rb) of every ray in the low and high halves:
    (2, tiles, H, 128) float32 landing t."""
    bf = torch.bfloat16
    t0 = torch.tensor([0.01 * r for r in reps], dtype=torch.float32)
    t0 = t0[:, None, None, None].expand(2, *ro[:, 0].shape)
    o, d = ro.unbind(1), rd.unbind(1)
    if variant == "map":
        t = 0.0 + t0
        for _ in range(steps):
            p = [(oc + dc * t).to(bf) for oc, dc in zip(o, d)]
            step = _map_halves(*p, sph).abs().float()
            t = t + torch.where(step < np.float32(1e-3), 0.0, step)
        return t
    o, d = ([c.to(bf) for c in v] for v in (o, d))
    eps = torch.tensor(1e-3).to(bf)
    t = torch.zeros_like(t0, dtype=bf) + t0.to(bf)
    for _ in range(steps):
        p = [oc + dc * t for oc, dc in zip(o, d)]
        step = _map_halves(*p, sph).abs()
        # The kernel's hit test: a mask of the halves below eps clears the
        # step's bits to +0.
        bits = torch.where(step < eps, 0, step.view(torch.int16).int())
        t = t + bits.to(torch.int16).view(bf)
    return t.float()


def packed_sum(ro, rd, sph, variant, reps, steps):
    """The kernel's schedule: reps (r, r + 1) a pair, an odd last rep in
    both halves, t_r then t_{r+1} added to the float32 sum."""
    acc = torch.zeros_like(ro[:, 0])
    for r in range(0, reps, 2):
        pair = r + 1 < reps
        t = _march_pair(ro, rd, sph, variant, (r, r + 1 if pair else r),
                        steps)
        acc = acc + t[0]
        if pair:
            acc = acc + t[1]
    return acc


def packed_march(ro, rd, sph, variant, reps, steps):
    """The kernel's output: the sum over the reps divided by their count."""
    return div_exact(packed_sum(ro, rd, sph, variant, reps, steps),
                     float(reps))


@pytest.mark.parametrize("tiles", [1, 2])
@pytest.mark.parametrize("reps", [1, 3, 4])
@pytest.mark.parametrize("variant", ["map", "all"])
def test_packed_schedule_matches_plain(variant, reps, tiles):
    ro, rd, sph = (torch.from_numpy(a) for a in _bf16_inputs(tiles))
    got = packed_march(ro, rd, sph, variant, reps, STEPS)
    want = hp.bf16_march_plain(ro, rd, sph, variant, reps, STEPS)
    assert torch.isfinite(want).all()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.fixture(scope="module")
def bf16_jax_odd():
    """JAX's bf16 kernels at 3 reps (the packed schedule's odd tail)."""
    mod = _probe("bf16_probe", H=H, REPS=3)
    ro, rd, sph = _bf16_inputs()
    out = {}
    for variant, kernel in (("map", mod.make_kernel(jnp.bfloat16)),
                            ("all", mod.make_kernel_bf16_t())):
        out[variant] = np.asarray(pl.pallas_call(
            kernel, out_shape=jax.ShapeDtypeStruct((H, 128), jnp.float32),
            interpret=True)(*(jnp.asarray(a[0]) for a in (ro, rd, sph))))
    return out


@pytest.mark.parametrize("variant", ["map", "all"])
def test_packed_schedule_matches_jax_at_odd_reps(bf16_jax_odd, variant):
    """The sums agree bit for bit.  XLA's CPU divides by the constant REPS
    as a multiply by its float32 reciprocal (exact at the other tests'
    REPS = 2), so the model's sum is scaled so here."""
    ro, rd, sph = (torch.from_numpy(a) for a in _bf16_inputs())
    acc = packed_sum(ro, rd, sph, variant, 3, hp.BF16_STEPS)[0].numpy()
    np.testing.assert_array_equal(acc * np.float32(1 / 3),
                                  bf16_jax_odd[variant])


def _finite_nonnegative_bf16():
    """Every finite non-negative bf16 value (bit patterns 0x0000-0x7F7F,
    subnormals included) as float64, with its bits."""
    bits = np.arange(0x7F80, dtype=np.uint32)
    return bits, (bits << 16).view(np.float32).astype(np.float64)


def _to_bf16_bits(x32):
    """Round-to-nearest-even float32 -> bf16 bits (no NaN here)."""
    b = x32.view(np.uint32).astype(np.uint64)
    return ((b + 0x7FFF + ((b >> 16) & 1)) >> 16).astype(np.uint32)


def test_approximate_root_rounds_to_the_correctly_rounded_root():
    """Every float32 within SQRT_APPROX_REL_ERR of the exact root rounds to
    the correctly rounded bf16 root, for every finite non-negative bf16
    value: bf16 rounding is monotonic, so the float32 values nearest the
    interval's ends inside it decide."""
    bits, v = _finite_nonnegative_bf16()
    r = np.sqrt(v)
    want = _to_bf16_bits(r.astype(np.float32))
    lo, hi = r * (1 - SQRT_APPROX_REL_ERR), r * (1 + SQRT_APPROX_REL_ERR)
    lo32, hi32 = lo.astype(np.float32), hi.astype(np.float32)
    lo32 = np.where(lo32 < lo, np.nextafter(lo32, np.float32(np.inf)), lo32)
    hi32 = np.where(hi32 > hi, np.nextafter(hi32, np.float32(0)), hi32)
    assert (lo32 <= hi32).all()
    np.testing.assert_array_equal(_to_bf16_bits(lo32), want)
    np.testing.assert_array_equal(_to_bf16_bits(hi32), want)


def test_exact_roots_keep_clear_of_bf16_midpoints():
    """The margin behind the approximate root: the exact root of a positive
    bf16 value lies at least 2^-19 of itself from every bf16 rounding
    midpoint (a midpoint squared has 17-18 significant bits, never a bf16
    value's 8), 16 times the approximation's bound."""
    bits, v = _finite_nonnegative_bf16()
    r = np.sqrt(v[1:])
    want = _to_bf16_bits(r.astype(np.float32))
    below = ((want - 1) << 16).view(np.float32).astype(np.float64)
    at = (want << 16).view(np.float32).astype(np.float64)
    above = ((want + 1) << 16).view(np.float32).astype(np.float64)
    margin = np.minimum(r - (below + at) / 2, (at + above) / 2 - r) / r
    assert margin.min() >= 2.0 ** -19
    assert margin.min() >= 16 * SQRT_APPROX_REL_ERR


def test_bf16_roots_plain_are_correctly_rounded():
    before = dict(hp.LAUNCHES)
    got = hp.bf16_roots("cpu").numpy().view(np.uint16).astype(np.uint32)
    assert got.shape == (2, hp.BF16_PATTERNS)
    assert hp.LAUNCHES == before
    bits, v = _finite_nonnegative_bf16()
    want = _to_bf16_bits(np.sqrt(v).astype(np.float32))
    for row in got:
        np.testing.assert_array_equal(row[:0x7F80], want)
        assert row[0x7F80] == 0x7F80  # the root of infinity
        nan = row[0x7F81:]
        assert ((nan & 0x7F80) == 0x7F80).all() and (nan & 0x7F).all()
    with pytest.raises(ValueError, match="no kernel"):
        hp.bf16_roots("meta")
