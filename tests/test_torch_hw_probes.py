"""Port parity: the hardware-primitive probes (kernels/hw_probes.py) against
the JAX package's probe kernels (benchmarks/vpu_peak.py, gather_probe.py,
bf16_probe.py, mxu_transform_probe.py), each run through
``pl.pallas_call(..., interpret=True)`` on one tile at a reduced size: the
loaded probe module's constants are set (H, K, ITERS, REPS); the kernels
nested in ``make_fn`` and ``probe_throughput`` run through a ``pl`` whose
``pallas_call`` interprets, and ``_time`` hands over their outputs.  No
file under benchmarks/ changes.  Inputs come from numpy seeds, as the
probes make them.

On the CPU each entry point runs its plain version; chip_smoke.py holds the
CUDA kernels to them on the card.  Tolerances, with their reasons:

* bit-equal: gather (all four kernels), bf16 B (bf16 map) and C (bf16 end
  to end): every operation rounds once, in the probe's order, and XLA's
  CPU rounds each bf16 operation through float32 as torch does;
* float32 contraction: vpu within 2 K 2**-24 relative (XLA's CPU may fuse
  or not fuse the probe's ``c * m + a``; the port fuses each, rounding once,
  which is what the kernel's ``__fmaf_rn`` does: 2 K steps, each at most an
  ulp apart), and bf16 A within 2e-4 relative (XLA contracts the march's
  multiply-adds; the port rounds each operation: 8 % of rays move, by up to
  7.7e-5 relative at 2 reps);
* mxu scalar and tensor: no ray's hit flips, and on the hits t (summed over
  the reps) within 1e-4 relative or 1e-5 per rep: XLA contracts the
  scalar transforms and sums the dot in its own order, which moves oq and
  dq by ulps, and the slab's division magnifies them where |dq| is small
  (seen: up to 3.4e-6 per rep, 1.1e-3 relative on small t).
"""

import functools
import importlib.util
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from compute_path_tracer_tpu_torch.app import profiling as pf
from compute_path_tracer_tpu_torch.benchmarks import (
    bf16_probe, gather_probe, mxu_transform_probe, vpu_peak)
from compute_path_tracer_tpu_torch.kernels import hw_probes as hp

BENCH = Path(__file__).resolve().parents[1] / "benchmarks"
H = 8            # rows of the reduced vpu, gather and bf16 tiles
VPU_K = 50
GATHER_ITERS = 16
REPS = 2         # bf16 and mxu
MXU_H = 64       # mxu at its own tile


def _probe(name, **consts):
    """The probe file loaded as its own module, ``consts`` set on it."""
    spec = importlib.util.spec_from_file_location(name, BENCH / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for k, v in consts.items():
        setattr(mod, k, v)
    return mod


def _interpreting(mod, record=None):
    """Give ``mod`` a ``pl`` whose ``pallas_call`` interprets; ``record``
    (a list) collects the calls' outputs."""
    ns = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl)
                                  if not k.startswith("_")})
    call = functools.partial(pl.pallas_call, interpret=True)
    if record is None:
        ns.pallas_call = call
    else:
        def recording(*a, **kw):
            fn = call(*a, **kw)

            def run(*args):
                out = fn(*args)
                record.append(np.asarray(out))
                return out
            return run
        ns.pallas_call = recording
    mod.pl = ns
    return mod


def _t(a):
    """A numpy tile as a one-tile torch batch."""
    return torch.from_numpy(np.array(a, order="C"))[None]


# -- vpu_peak -----------------------------------------------------------------


def _vpu_x():
    return vpu_peak.inputs(1, "cpu", h=H)[0].numpy()


@pytest.mark.parametrize("width", [1, 4])
def test_vpu_matches_jax(width):
    mod = _interpreting(_probe("vpu_peak", H=H, K=VPU_K))
    x = _vpu_x()
    want = np.asarray(mod.make_fn(width)(jnp.asarray(x)))
    got = hp.vpu_chains(_t(x), width, VPU_K)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=2 * VPU_K * 2.0 ** -24, atol=0)


def _vpu_separate(x, width, iters):
    """The chains with the multiply and the add rounded separately."""
    c = np.stack([x + np.float32(w) for w in range(width)])
    for _ in range(iters):
        c = c * np.float32(1.000001) + np.float32(0.5)
        c = c * np.float32(0.999999) + np.float32(0.25)
    acc = c[0]
    for w in range(1, width):
        acc = acc + c[w]
    return acc


def _vpu_fused(x, width, iters):
    """The chains with each multiply-add rounded once: numpy float64, where
    the sum of the exact product and 0.5 or 0.25 is exact for |c| >= 1."""
    c = np.stack([x + np.float32(w) for w in range(width)])
    for _ in range(iters):
        for m, a in ((1.000001, 0.5), (0.999999, 0.25)):
            p = c.astype(np.float64) * np.float64(np.float32(m))
            assert np.abs(p).min() >= 2.0 ** -6
            c = (p + a).astype(np.float32)
    acc = c[0]
    for w in range(1, width):
        acc = acc + c[w]
    return acc


def test_vpu_plain_fuses_each_multiply_add():
    """The plain version rounds each step once, as ``__fmaf_rn`` does: it
    equals the fused chains and not the chains rounded twice a step (which
    differ on a third of the elements here)."""
    x = _vpu_x()
    got = hp.vpu_chains(_t(x), 4, VPU_K)[0].numpy()
    np.testing.assert_array_equal(got, _vpu_fused(x, 4, VPU_K))
    assert (got != _vpu_separate(x, 4, VPU_K)).mean() > 0.1


def test_vpu_plain_refuses_inexact_products():
    with pytest.raises(ValueError):
        hp.vpu_chains(torch.full((1, 1, 128), -0.5), 1, 4)
    with pytest.raises(ValueError):
        hp.vpu_chains(torch.ones((1, 1, 128)), 3, 4)


# -- gather_probe -------------------------------------------------------------


def _gather_jax():
    """probe_correct's output and probe_throughput's three kernels' outputs,
    with their inputs."""
    outs, timed = [], []
    mod = _interpreting(_probe("gather_probe", H=H, ITERS=GATHER_ITERS), outs)
    assert mod.probe_correct()
    _interpreting(mod)

    def capture(fn, *args):
        timed.append((tuple(np.asarray(a) for a in args),
                      np.asarray(fn(*args)[0])))
        return 1.0

    mod._time = capture
    mod.probe_throughput()
    return outs[0], timed


@pytest.fixture(scope="module")
def gather_jax():
    return _gather_jax()


def test_gather_correct_matches_jax(gather_jax):
    """On the measurement script's inputs, which are probe_correct's."""
    out, _ = gather_jax
    inp = gather_probe.inputs(1, "cpu", h=H)
    for load in ("smem", "ldg"):
        np.testing.assert_array_equal(
            hp.gather_once(inp["correct_tab"], inp["correct_idx"],
                           load)[0].numpy(), out)


def test_gather_inputs_are_the_probes(gather_jax):
    _, timed = gather_jax
    inp = gather_probe.inputs(1, "cpu", h=H)
    (tab, idx), _ = timed[0]
    np.testing.assert_array_equal(inp["tab"][0].numpy(), tab)
    np.testing.assert_array_equal(inp["idx"][0].numpy(), idx)
    (*tabs, idx512), _ = timed[2]
    np.testing.assert_array_equal(inp["tab512"][0].numpy(),
                                  np.concatenate(tabs, axis=-1))
    np.testing.assert_array_equal(inp["idx512"][0].numpy(), idx512)


def test_gather_chains_match_jax(gather_jax):
    """gather_kernel, arith_kernel, grid512_kernel, in probe_throughput's
    order, bit for bit; grid512's four chunk tables are one 512-entry row."""
    _, timed = gather_jax
    (tab, idx), want = timed[0]
    for load in ("smem", "ldg"):
        np.testing.assert_array_equal(
            hp.gather_chain(_t(tab), _t(idx), GATHER_ITERS, load)[0].numpy(),
            want)
    (_, idx), want = timed[1]
    np.testing.assert_array_equal(
        hp.gather_arith(_t(idx), GATHER_ITERS)[0].numpy(), want)
    (*tabs, idx512), want = timed[2]
    tab512 = np.concatenate(tabs, axis=-1)
    assert tab512.shape == (H, hp.GRID_ENTRIES)
    for load in ("smem", "ldg"):
        np.testing.assert_array_equal(
            hp.gather_chain(_t(tab512), _t(idx512), GATHER_ITERS,
                            load)[0].numpy(), want)


# -- bf16_probe ---------------------------------------------------------------


def _bf16_inputs(tiles=1):
    """bf16_probe.main's rays and spheres at H rows (its rng order), per
    tile, as numpy."""
    return tuple(a.numpy() for a in bf16_probe.inputs(tiles, "cpu", h=H))


@pytest.fixture(scope="module")
def bf16_jax():
    mod = _probe("bf16_probe", H=H, REPS=REPS)
    ro, rd, sph = _bf16_inputs()
    out = {}
    for variant, kernel in (("f32", mod.make_kernel(jnp.float32)),
                            ("map", mod.make_kernel(jnp.bfloat16)),
                            ("all", mod.make_kernel_bf16_t())):
        out[variant] = np.asarray(pl.pallas_call(
            kernel, out_shape=jax.ShapeDtypeStruct((H, 128), jnp.float32),
            interpret=True)(*(jnp.asarray(a[0]) for a in (ro, rd, sph))))
    return out


@pytest.mark.parametrize("variant", hp.BF16_VARIANTS)
def test_bf16_matches_jax(bf16_jax, variant):
    ro, rd, sph = (torch.from_numpy(a) for a in _bf16_inputs())
    got = hp.bf16_march(ro, rd, sph, variant, REPS, hp.BF16_STEPS)[0].numpy()
    want = bf16_jax[variant]
    if variant == "f32":
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


def test_bf16_tiles_are_independent():
    """Two tiles at once give each tile's march, and the bf16 map's landing
    t stays within bf16's precision of float32's (median under 1 %)."""
    ro, rd, sph = (torch.from_numpy(a) for a in _bf16_inputs(tiles=2))
    both = hp.bf16_march(ro, rd, sph, "map", REPS, 16)
    for k in range(2):
        one = hp.bf16_march(ro[k:k + 1], rd[k:k + 1], sph[k:k + 1], "map",
                            REPS, 16)
        assert torch.equal(both[k:k + 1], one)
    f32 = hp.bf16_march(ro, rd, sph, "f32", REPS, 16)
    assert float(((both - f32).abs() / f32).median()) < 1e-2


# -- mxu_transform_probe ------------------------------------------------------


def _mxu_inputs(tiles=1, h=MXU_H, n_shapes=hp.MXU_SHAPES):
    """mxu_transform_probe.main's ro, rd and m (its rng order), per tile, as
    numpy."""
    return tuple(a.numpy() for a in mxu_transform_probe.inputs(
        tiles, "cpu", h=h, n_shapes=n_shapes)[:3])


@pytest.fixture(scope="module")
def mxu_jax():
    mod = _probe("mxu_transform_probe", REPS=REPS)
    ro, rd, m = (a[0] for a in _mxu_inputs())
    mat, off = (a[0].numpy() for a in hp.mxu_matrices(torch.from_numpy(m)[None]))
    vm = pl.BlockSpec(memory_space=pltpu.VMEM)
    smem = pl.BlockSpec(memory_space=pltpu.SMEM)
    shape = jax.ShapeDtypeStruct((MXU_H, 128), jnp.float32)
    scalar = pl.pallas_call(mod.scalar_kernel, out_shape=shape,
                            in_specs=[vm, vm, smem], out_specs=vm,
                            interpret=True)(ro, rd, m)
    mxu = pl.pallas_call(mod.mxu_kernel, out_shape=shape, in_specs=[vm] * 4,
                         out_specs=vm, interpret=True)(ro, rd, mat, off)
    return np.asarray(scalar), np.asarray(mxu), (mat, off)


def _mxu_close(got, want, reps=REPS):
    hit = want < hp.MXU_MISS_SUM_MIN * reps
    np.testing.assert_array_equal(got < hp.MXU_MISS_SUM_MIN * reps, hit)
    assert hit.mean() > 0.5
    np.testing.assert_allclose(got[hit], want[hit], rtol=1e-4,
                               atol=1e-5 * reps)


def test_mxu_matrices_are_the_probes(mxu_jax):
    """The probe's (128, 3) row matrix and offsets (its lines 127-132)."""
    *_, (mat, off) = mxu_jax
    m = _mxu_inputs()[2][0]
    for s in range(hp.MXU_SHAPES):
        for r in range(3):
            np.testing.assert_array_equal(mat[3 * s + r],
                                          m[10 * s + 3 * r:10 * s + 3 * r + 3])
            assert off[3 * s + r] == m[10 * s + 9]
    assert not mat[3 * hp.MXU_SHAPES:].any() and not off[3 * hp.MXU_SHAPES:].any()


def test_mxu_scalar_matches_jax(mxu_jax):
    ro, rd, m = (torch.from_numpy(a) for a in _mxu_inputs())
    _mxu_close(hp.mxu_scalar(ro, rd, m, REPS)[0].numpy(), mxu_jax[0])


def test_mxu_tensor_matches_jax(mxu_jax):
    ro, rd, m = (torch.from_numpy(a) for a in _mxu_inputs())
    mat, off = hp.mxu_matrices(m)
    got = hp.mxu_tensor(ro, rd, mat, off, hp.MXU_SHAPES, REPS)[0].numpy()
    _mxu_close(got, mxu_jax[1])
    _mxu_close(got, mxu_jax[0])


def _tf32(x):
    """float32 to TF32, rounded to nearest with ties away from zero (the
    card's cvt.rna.tf32.f32, wmma::__float_to_tf32)."""
    b = x.view(np.uint32).astype(np.uint64)
    return ((b + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def _split_product(a, x):
    """The 3xTF32 product the tensor-core kernel computes, as float32 sums
    of exact partial products: a_lo x_hi, then + a_hi x_lo, then + a_hi
    x_hi."""
    a_hi, x_hi = _tf32(a), _tf32(x)
    a_lo, x_lo = _tf32(a - a_hi), _tf32(x - x_hi)

    def dot(p, q):
        return np.einsum("trk,tkn->trn", p.astype(np.float64),
                         q.astype(np.float64))

    c = dot(a_lo, x_hi).astype(np.float32)
    c = (c + dot(a_hi, x_lo)).astype(np.float32)
    return (c + dot(a_hi, x_hi)).astype(np.float32)


def test_mxu_tensor_tolerance_covers_the_3xtf32_split():
    """chip_smoke.py holds the tensor-core kernel to its plain version by
    ``mxu_tensor_diff``'s tolerance; a model of its 3xTF32 product (the
    split rounded as the card rounds it, each partial sum in float32) stays
    inside it on two tiles of the probe's inputs, while TF32 alone (one
    rounding of each operand) does not."""
    ro, rd, m = (torch.from_numpy(a) for a in _mxu_inputs(tiles=2))
    mat, off = hp.mxu_matrices(m)
    plain = hp.mxu_tensor_plain(ro, rd, mat, off, hp.MXU_SHAPES, 1)
    a = mat[:, :3 * hp.MXU_SHAPES].numpy()
    shape = ro[:, 0].shape

    def modelled(product):
        oq = product(a, ro.reshape(2, 3, -1).numpy()) \
            + off[:, :3 * hp.MXU_SHAPES, None].numpy()
        dq = product(a, rd.reshape(2, 3, -1).numpy())

        def rows(s, r):
            return (torch.from_numpy(oq[:, 3 * s + r].reshape(shape).copy()),
                    torch.from_numpy(dq[:, 3 * s + r].reshape(shape).copy()))

        return hp._fold(rows, ro[:, 0], hp.MXU_SHAPES)

    def tf32_only(p, q):
        return np.einsum("trk,tkn->trn", _tf32(p).astype(np.float64),
                         _tf32(q).astype(np.float64)).astype(np.float32)

    err, off_share, flips = hp.mxu_tensor_diff(modelled(_split_product),
                                               plain, 1)
    assert off_share == 0.0 and flips == 0.0 and err <= hp.MXU_ATOL_PER_REP
    assert hp.mxu_tensor_diff(modelled(tf32_only), plain, 1)[1] \
        > hp.MXU_SHARE_OFF


def test_mxu_reps_add_and_forms_agree():
    """The reps add the same t_min, and five shapes on a short tile give
    the scalar form's hits in the tensor form."""
    ro, rd, m = (torch.from_numpy(a) for a in _mxu_inputs(n_shapes=5,
                                                           h=8))
    one = hp.mxu_scalar(ro, rd, m, 1)
    three = hp.mxu_scalar(ro, rd, m, 3)
    assert torch.equal(three, one + one + one)
    mat, off = hp.mxu_matrices(m)
    tensor = hp.mxu_tensor(ro, rd, mat, off, 5, 1)
    hit = one < hp.MXU_MISS_SUM_MIN
    assert torch.equal(tensor < hp.MXU_MISS_SUM_MIN, hit)
    assert float((tensor - one).abs()[hit].max()) < 1e-3


# -- the entry points on the CPU ----------------------------------------------


def test_entry_points_run_plain_on_cpu_and_launch_nothing():
    before = dict(hp.LAUNCHES)
    x = torch.from_numpy(_vpu_x())[None]
    assert torch.equal(hp.vpu_chains(x, 2, 3), hp.vpu_chains_plain(x, 2, 3))
    rng = np.random.default_rng(3)
    tab = torch.from_numpy(rng.integers(1, 14, (2, 4, 128)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 128, (2, 4, 128)).astype(np.int32))
    assert torch.equal(hp.gather_chain(tab, idx, 5, "ldg"),
                       hp.gather_chain_plain(tab, idx, 5))
    assert torch.equal(hp.gather_once(tab, idx),
                       torch.gather(tab, -1, idx.long()))
    # Indices are taken modulo the row's size, by kernels and plain alike.
    assert torch.equal(hp.gather_once(tab, idx - 128), hp.gather_once(tab, idx))
    assert torch.equal(hp.gather_chain(tab, idx + 256, 5),
                       hp.gather_chain(tab, idx, 5))
    assert torch.equal(hp.gather_arith(idx, 3), hp.gather_arith_plain(idx, 3))
    assert hp.LAUNCHES == before


def test_entry_points_check_their_inputs():
    idx = torch.zeros((1, 4, 128), dtype=torch.int32)
    with pytest.raises(ValueError):
        hp.gather_chain(torch.zeros((1, 4, 256)), idx)
    with pytest.raises(ValueError):
        hp.gather_once(torch.zeros((1, 4, 128)), idx, "tex")
    with pytest.raises(ValueError):
        hp.gather_arith(idx.long())
    ro = torch.zeros((1, 3, 1, 128))
    with pytest.raises(ValueError):
        hp.bf16_march(ro, ro, torch.zeros((1, 12, 4)), "f16")
    with pytest.raises(ValueError):
        hp.bf16_march(ro, ro, torch.zeros((1, 12, 4)), "f32", reps=0)
    with pytest.raises(ValueError):
        hp.mxu_scalar(ro, ro, torch.zeros((1, 330)))
    with pytest.raises(ValueError):
        hp.mxu_tensor(ro, ro, torch.zeros((1, 12, 3)), torch.zeros((1, 12)),
                      5)
    with pytest.raises(ValueError):
        hp.vpu_chains(ro, 0, 1)


# -- the bounds' operation counts (app/profiling.py) --------------------------


def test_probe_operation_counts():
    """Per item as the sources read: a chain's start and two fused
    multiply-adds of two operations each per iteration, the chains' sum;
    a tap's add and shared-memory word; bf16 operations at half cost; a
    box shape's 70 operations once (every rep computes the same t_min) and
    each rep's sum."""
    assert pf.vpu_ops(1, 1, 1) == 5 and pf.vpu_ops(3, 2, 10) == 3 * 83
    assert pf.gather_work("once", 7, 9) == (0.0, 7.0)
    assert pf.gather_work("chain", 7, 9) == (63.0, 63.0)
    assert pf.gather_work("arith", 1, 2) == (172.0, 0.0)
    with pytest.raises(ValueError):
        pf.gather_work("grid", 1, 1)
    assert pf.bf16_ops("f32", 1, 1, 1) == 141 + 1 + 1
    assert pf.bf16_ops("map", 2, 1, 2) == 2 * (2 * (20 + 121 / 2) + 2)
    assert pf.mxu_ops(1, 1, 1) == 71 and pf.mxu_ops(2, 32, 3) == 2 * 2243
    assert pf.mxu_ops(1, 32, 64) - pf.mxu_ops(1, 32, 1) == 63
    # MUFU: the arithmetic tap's 12 roots an iteration, bf16's root a
    # sphere and ray-step (24 a pair-step), mxu's reciprocal a row.
    assert pf.gather_mufu("arith", 1, 2) == 24.0
    assert pf.gather_mufu("chain", 7, 9) == pf.gather_mufu("once", 7, 9) == 0
    with pytest.raises(ValueError):
        pf.gather_mufu("grid", 1, 1)
    assert pf.bf16_mufu(1, 2, 1) == 24.0 and pf.bf16_mufu(3, 1, 2) == 72.0
    assert pf.mxu_mufu(1, 32) == 96.0 and pf.mxu_mufu(2, 1) == 6.0


def test_bound_takes_the_largest_term(monkeypatch):
    """Bytes over 3.35 TB/s, operations over the peak, shared-memory words
    over their rate: a tap chain is bound by its words, not its adds, and
    the bound says so."""
    monkeypatch.setattr(pf, "smem_rate", lambda device=0: 2e12)
    monkeypatch.setattr(pf, "mufu_rate", lambda device=0: 0.5e12)
    assert pf.bound_ms(3.35e9, 1e9, 1e12) == (1.0, "bytes")
    ms, by = pf.bound_ms(0, 1e9, 1e12, smem_words=4e9)
    assert (ms, by) == (2.0, "shared memory")
    assert pf.bound_ms(0, 3e9, 1e12, smem_words=4e9) == (3.0, "operations")
    assert pf.bound_ms(3.35e9, 1e9, 1e12, 1e9)[1] == "bytes"
    # The MUFU term: 12 roots at 16 a clock an SM outweigh 86 FP32
    # operations at 256, as gather_arith's do.
    assert pf.bound_ms(0, 1e9, 1e12, mufu=2e9) == (4.0, "MUFU")
    assert pf.bound_ms(0, 5e9, 1e12, mufu=2e9) == (5.0, "operations")
    assert pf.bound_ms(0, 1e9, 1e12, 1e10, 2e9) == (5.0, "shared memory")
    assert pf.bound_ms(0, 1e9, 1e12, mufu=0) == (1.0, "operations")
    monkeypatch.undo()
    monkeypatch.setattr(pf, "_sms_and_clock", lambda device: (132, 1.98e9))
    assert pf.mufu_rate() == pytest.approx(4.18176e12)
    assert pf.smem_rate() == pytest.approx(8.36352e12)
