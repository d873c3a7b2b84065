"""Port parity: the box-transform probe's layouts on the card
(kernels/csrc/hw_probes.cu: mxu_tensor on wgmma, mxu_scalar two rays a
thread over staged records), through their plain models in
kernels/hw_probes.py.

* The tensor kernel's column permutation (``mxu_wgmma_rows``) is a
  bijection of each half's 48 matrix rows that gives every quad lane, in
  wgmma's float32 accumulator layout (lane q holds columns 8 j + 2 q and
  8 j + 2 q + 1), the 3 rows of 4 whole shapes, in order.
* ``mxu_tensor_model``, the kernel's arithmetic in torch (the 3xTF32
  split rounded by mantissa mask, the offset added after the product, the
  fold per quad lane and the minimum over the quad), stays within
  ``mxu_tensor_diff``'s tolerance of ``mxu_tensor_plain`` and of the JAX
  probe's ``mxu_kernel`` (in interpret mode, as
  tests/test_torch_hw_probes.py runs it) on the probe's inputs, with no ray
  off; that tolerance is what chip_smoke.py holds the kernel to.
* The scalar kernel's 12-float records (``mxu_scalar_records``) hold m's
  entries in the probe's order, and its plain version, which reads them, is
  the flat form bit for bit.

The kernels run on the card only; chip_smoke.py holds them to their plain
versions there."""

import numpy as np
import pytest
import torch

from compute_path_tracer_tpu_torch.benchmarks import mxu_transform_probe
from compute_path_tracer_tpu_torch.kernels import hw_probes as hp
from test_torch_hw_probes import REPS, _mxu_close, _tf32, mxu_jax  # noqa: F401


def _inputs(tiles=1, h=hp.MXU_H, n_shapes=hp.MXU_SHAPES):
    ro, rd, m, mat, off = mxu_transform_probe.inputs(tiles, "cpu", h=h,
                                                     n_shapes=n_shapes)
    return ro, rd, m, mat, off


@pytest.mark.parametrize("half", [0, 1])
def test_columns_give_each_quad_lane_whole_shapes(half):
    rows = hp.mxu_wgmma_rows(half)
    assert sorted(rows.tolist()) == list(range(48 * half, 48 * half + 48))
    for q in range(4):
        mine = [int(rows[8 * j + 2 * q + e]) for j in range(6)
                for e in range(2)]
        shapes = [r // 3 for r in mine]
        first = hp.MXU_HALF_SHAPES * half + 4 * q
        assert shapes == [first + i // 3 for i in range(12)]
        assert [r % 3 for r in mine] == [i % 3 for i in range(12)]


def test_tf32_rounding_by_mask():
    """To nearest, ties away from zero (cvt.rna.tf32.f32): the test module's
    numpy rounding; the low 13 bits are zero, and hi + lo is x to 2**-21
    relative."""
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=4096).astype(np.float32) * 1e3)
    hi = hp.tf32_rna(x)
    assert np.array_equal(hi.numpy(), _tf32(x.numpy()))
    lo = hp.tf32_rna(x - hi)
    for v in (hi, lo):
        assert not bool((v.view(torch.int32) & 0x1FFF).any())
    assert float(((hi.double() + lo.double() - x.double()).abs()
                  / x.double().abs()).max()) < 2.0 ** -21
    ties = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12])
    assert hp.tf32_rna(ties).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10),
                                          1.0]


@pytest.mark.parametrize("tiles, h, n_shapes, reps", [
    (2, hp.MXU_H, hp.MXU_SHAPES, 1), (1, 8, 5, 3), (1, 2, 17, 2)])
def test_model_within_tolerance_of_plain(tiles, h, n_shapes, reps):
    ro, rd, _, mat, off = _inputs(tiles, h, n_shapes)
    model = hp.mxu_tensor_model(ro, rd, mat, off, n_shapes, reps)
    plain = hp.mxu_tensor_plain(ro, rd, mat, off, n_shapes, reps)
    err, share, flips = hp.mxu_tensor_diff(model, plain, reps)
    assert share == 0.0 and flips == 0.0
    assert err <= hp.MXU_ATOL_PER_REP * reps
    # Not vacuous: a share of the rays hits (half of them with 5 shapes).
    assert float((plain < hp.MXU_MISS_SUM_MIN * reps).double().mean()) > 0.2


def test_model_within_tolerance_of_jax(mxu_jax):  # noqa: F811
    ro, rd, m, mat, off = _inputs()
    model = hp.mxu_tensor_model(ro, rd, mat, off, hp.MXU_SHAPES, REPS)
    _mxu_close(model[0].numpy(), mxu_jax[1])
    err, share, flips = hp.mxu_tensor_diff(
        model, torch.from_numpy(mxu_jax[1].copy())[None], REPS)
    assert share == 0.0 and flips == 0.0


def test_scalar_records_hold_m_in_probe_order():
    _, _, m, _, _ = _inputs(tiles=3, h=2, n_shapes=7)
    rec = hp.mxu_scalar_records(m)
    assert rec.shape == (3, 7, hp.MXU_RECORD) and hp.MXU_RECORD == 12
    for s in range(7):
        for r in range(3):
            # Row r: three entries, then (record 9) the offset.
            assert torch.equal(rec[:, s, 3 * r:3 * r + 3],
                               m[:, 10 * s + 3 * r:10 * s + 3 * r + 3])
        assert torch.equal(rec[:, s, 9], m[:, 10 * s + 9])
    assert not bool(rec[:, :, 10:].any())
    # Three 16-byte loads a shape: records start 48 bytes apart.
    assert rec.stride(1) * rec.element_size() == 48


def test_scalar_plain_is_the_flat_form():
    """The plain version over the records is the probe's flat form, each
    operation in its order, bit for bit; the wrapper takes two rays a
    thread, so H must be even."""
    ro, rd, m, _, _ = _inputs(tiles=2, h=4, n_shapes=9)
    o, d = ro.unbind(1), rd.unbind(1)

    def rows(s, r):
        m0, m1, m2, c = (m[:, 10 * s + k][:, None, None]
                         for k in (3 * r, 3 * r + 1, 3 * r + 2, 9))
        return (m0 * o[0] + m1 * o[1] + m2 * o[2] + c,
                m0 * d[0] + m1 * d[1] + m2 * d[2])

    flat = hp._rep_sum(hp._fold(rows, o[0], 9), 2)
    assert torch.equal(hp.mxu_scalar(ro, rd, m, 2), flat)
    assert hp.LANES * hp.MXU_SCALAR_RAYS == 256
    odd = _inputs(tiles=1, h=3, n_shapes=9)
    with pytest.raises(ValueError, match="multiple of 256"):
        hp.mxu_scalar(odd[0], odd[1], odd[2])
    # The tensor kernel takes any H: 64 rays a warpgroup.
    assert hp.mxu_tensor(odd[0], odd[1], odd[3], odd[4], 9, 1).shape == (1, 3, 128)
