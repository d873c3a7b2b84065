"""The segment sum's tensor-core design (kernels/grad_probes.py beside
``csrc/grad_probes.cu:segsum``) on the CPU: the TF32 split, the partition of
the elements into passes, tiles, blocks and warp fragments that the wrapper
launches, and ``segsum_model``, a plain model of the kernel's sum in its
fixed order, against the JAX probe (benchmarks/probe_inkernel_segsum.py, in
interpret mode through test_torch_grad_probes.py's ``_segsum_pair``) and
against ``segsum_plain`` (``index_add_``).  chip_smoke.py holds the kernel
itself to a float64 sum on the card.  Tolerances, with their reasons:

* the split: |x - hi - lo| <= 2^-23 |x| (hi keeps 11 significant bits, lo
  the next 11 of a remainder below 2^-11 |x|), or half TF32's subnormal
  spacing, 2^-137, where that is larger (TF32 keeps float32's exponent
  range and drops 13 of its bits, subnormal ones too);
* the model against the JAX probe and a float64 sum: 1e-5 of max |ref|,
  the probe's own bound (the model rounds each warp's tile products once
  and adds in float32);
* non-finite entries: exactly ``segsum_plain``'s, NaN for NaN and each
  infinity with its sign.
"""

import numpy as np
import pytest
import torch

from compute_path_tracer_tpu_torch.benchmarks import probe_inkernel_segsum
from compute_path_tracer_tpu_torch.kernels import grad_probes as gp
from compute_path_tracer_tpu_torch.kernels.train import MAT_CHANNELS
from test_torch_grad_probes import _segsum_pair

SEG_TOL = 1e-5
FLT_MAX = float(np.finfo(np.float32).max)
# (B, n, S, C, SMs): ragged planes and tiles, S > 64, C > 16 and > 32, both
# tile sizes, several tiles a block.
RAGGED = [(3, 1003, 130, 28, 3), (2, 777, 70, 45, 2), (5, 333, 9, 5, 132),
          (9, 4096, 64, 13, 4), (2, 1030, 64, 17, 132)]


def _floats(rng, n):
    """float32 samples of every binade (both signs), subnormals and values
    near the largest float below gp.TF32_OVER."""
    exp = rng.integers(1, 255, n, dtype=np.uint32)
    bits = (exp << 23) | rng.integers(0, 1 << 23, n, dtype=np.uint32)
    sub = rng.integers(1, 1 << 23, n // 4, dtype=np.uint32)
    over = np.array(gp.TF32_OVER, np.float32).view(np.uint32)
    top = rng.integers(0x7F7F0000, over, n // 4, dtype=np.uint32)
    edge = np.array([1, 0x7FFFFF, 0x800000, 0x7F7FEFFF, 0x3F801000,
                     0x3F803000, 0x3FFFF000], np.uint32)
    bits = np.concatenate([bits, sub, top, edge])
    bits = bits[bits < over]
    sign = rng.integers(0, 2, bits.size, dtype=np.uint32) << 31
    return torch.from_numpy((bits | sign).view(np.float32))


def test_tf32_split_leaves_at_most_2_pow_minus_23():
    x = _floats(np.random.default_rng(0), 400_000)
    hi, lo = gp.tf32_split(x)
    for t in (hi, lo):
        assert not (t.view(torch.int32) & 0x1FFF).any()
        assert torch.isfinite(t).all()
    err = (x.double() - hi.double() - lo.double()).abs()
    bound = torch.clamp(x.double().abs() * 2.0 ** -23, min=2.0 ** -137)
    assert (err <= bound).all()
    normal = x.abs() >= 2.0 ** -114
    assert (err[normal] <= x.double().abs()[normal] * 2.0 ** -23).all()
    # hi is x to nearest TF32 (half its spacing), ties away from zero.
    assert (x.double() - hi.double()).abs().le(torch.clamp(
        x.double().abs() * 2.0 ** -11, min=2.0 ** -137)).all()
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 3 * 2.0 ** -11)])
    assert gp.tf32_split(tie)[0].tolist() == [1.0 + 2.0 ** -10,
                                              -(1.0 + 2.0 ** -9)]


def test_tf32_rounding_overflows_only_at_the_scalar_paths_bound():
    """At and above TF32_OVER the rounding reaches 2^128, which is why the
    kernel adds such values on its scalar path; just below it does not."""
    over = np.array(gp.TF32_OVER, np.float32)
    below = (over.view(np.uint32) - 1).view(np.float32)
    x = torch.tensor([float(over), -float(over), float(below), FLT_MAX],
                     dtype=torch.float32)
    hi, _ = gp.tf32_split(x)
    assert torch.isinf(hi).tolist() == [True, True, False, True]


@pytest.mark.parametrize("n_b, n, n_seg, n_ch, n_sm", RAGGED)
def test_partition_covers_every_element_once(n_b, n, n_seg, n_ch, n_sm):
    plan = gp.segsum_plan(n_b, n, n_seg, n_ch, n_sm)
    assert plan.tile in gp.SEG_TILES
    assert plan.tiles_per_plane * plan.tile >= n > (plan.tiles_per_plane - 1) * plan.tile
    block, step = gp.segsum_tiles(plan)
    # Each block takes its tiles one a step, as many as the kernel counts.
    pairs = set(zip(block.tolist(), step.tolist()))
    assert len(pairs) == plan.tiles
    for bx in range(plan.blocks):
        mine = (plan.tiles - 1 - bx) // plan.blocks + 1
        assert sorted(s for b, s in pairs if b == bx) == list(range(mine))
    # Every (b, i) once over the tiles' lanes, the rest past a plane's end.
    q = torch.arange(plan.tiles)[:, None]
    lane = torch.arange(plan.tile)[None]
    b = (q // plan.tiles_per_plane).expand(-1, plan.tile)
    i = (q % plan.tiles_per_plane) * plan.tile + lane
    valid = i < n
    flat = (b * n + i)[valid]
    assert torch.equal(torch.sort(flat).values, torch.arange(n_b * n))
    # Within a warp's share, every lane a distinct (pair step, chunk, column)
    # of the m16n8k8 products' depth, and every such slot used.
    w_lanes = plan.tile // gp.SEG_WARPS
    p, c, k = gp.segsum_lane_slots(w_lanes)
    slots = (p * 2 + c) * 8 + k
    assert torch.equal(torch.sort(slots).values, torch.arange(w_lanes))
    assert set(c.tolist()) == {0, 1} and set(k.tolist()) == set(range(8))
    # The passes cover every (segment, channel) once.
    cover = torch.zeros((n_seg, n_ch), dtype=torch.int64)
    for pas in range(plan.passes):
        s0 = (pas // plan.ch_groups) * gp.SEG_GROUP
        c0 = (pas % plan.ch_groups) * plan.cp
        cover[s0:s0 + gp.SEG_GROUP, c0:c0 + plan.cp] += 1
    assert (cover == 1).all()
    # Blocks that fit the card, and their shared memory.
    per_sm = 3 - plan.m_tiles
    assert plan.blocks <= max(1, -(-per_sm * n_sm // plan.passes))
    assert gp.segsum_smem_bytes(plan, n_ch) * per_sm <= 232_448


def test_plan_at_the_probe_and_k4_shapes():
    """The probe's plane takes tiles of 256 lanes, one a block; K4's 9
    planes tiles of 512, two blocks an SM; C = 32 still fits a block."""
    probe = gp.segsum_plan(1, 64 * 256, 64, 28)
    assert (probe.tile, probe.tiles, probe.blocks, probe.m_tiles) == (256, 64, 64, 2)
    k4 = gp.segsum_plan(9, 1920 * 1080, 64, len(MAT_CHANNELS))
    assert (k4.tile, k4.tiles, k4.blocks, k4.m_tiles, k4.passes) == (
        512, 36_450, 264, 1, 1)
    wide = gp.segsum_plan(9, 1920 * 1080, 64, 32)
    assert gp.segsum_smem_bytes(wide, 32) <= 232_448


@pytest.fixture(scope="module", params=[28, len(MAT_CHANNELS)],
                ids=["probe", "k4_channels"])
def jax_segsum(request):
    """(idx, cot, the JAX probe's (S, C) output) at the probe's shape with
    C channels; one interpret-mode run of the probe."""
    consts = {} if request.param == 28 else {"C": request.param}
    want, _ = _segsum_pair(**consts)
    shape = dict(probe_inkernel_segsum.PROBE, n_ch=request.param)
    idx, cot = probe_inkernel_segsum.inputs(shape, "cpu")
    return idx, cot, want


def test_model_matches_jax(jax_segsum):
    idx, cot, want = jax_segsum
    got = gp.segsum_model(idx, cot, want.shape[0]).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() / np.abs(want).max() < SEG_TOL


def test_model_tiles_agree_on_any_card(jax_segsum):
    """The grid follows the SM count; the sum stays within the bound."""
    idx, cot, want = jax_segsum
    ref = gp.segsum_plain(idx, cot.double(), want.shape[0])
    for n_sm in (1, 7):
        got = gp.segsum_model(idx, cot, want.shape[0], n_sm)
        assert float((got.double() - ref).abs().max() / ref.abs().max()) < SEG_TOL


@pytest.mark.parametrize("n_b, n, n_seg, n_ch, n_sm", RAGGED[:3])
def test_model_matches_a_float64_sum(n_b, n, n_seg, n_ch, n_sm):
    shape = dict(n_b=n_b, h=1, w=n, n_seg=n_seg, n_ch=n_ch)
    idx, cot = probe_inkernel_segsum.inputs(shape, "cpu", seed=n)
    got = gp.segsum_model(idx, cot, n_seg, n_sm)
    ref = gp.segsum_plain(idx, cot.double(), n_seg)
    assert got.shape == (n_seg, n_ch)
    assert float((got.double() - ref).abs().max() / ref.abs().max()) < SEG_TOL


def _nonfinite_inputs(big=False):
    """idx (2, 3000) with dropped lanes, cot (2, 13, 3000), NaN and +-inf on
    six dropped and six kept lanes (with ``big``, also two cotangents at or
    above TF32_OVER on kept lanes); the kept lanes' (b, c, i)."""
    shape = dict(n_b=2, h=1, w=3000, n_seg=64, n_ch=13)
    idx, cot = probe_inkernel_segsum.inputs(shape, "cpu", seed=5)
    bad = [float("nan"), float("inf"), -float("inf")]
    drop = (idx < 0).nonzero().tolist()[:6]
    keep = (idx >= 0).nonzero().tolist()[:8]
    for k, (b, i) in enumerate(drop):
        cot[b, k % 13, i] = bad[k % 3]
    kept = [(b, (3 * k) % 13, i) for k, (b, i) in enumerate(keep[:6])]
    for k, (b, c, i) in enumerate(kept):
        cot[b, c, i] = bad[k % 3]
    if big:
        for (b, i), v in zip(keep[6:], (FLT_MAX, -3.39e38)):
            cot[b, 2, i] = v
    return idx, cot, drop, kept


def _same_nonfinite(a, b):
    return all(torch.equal(f(a), f(b)) for f in
               (torch.isnan, torch.isposinf, torch.isneginf))


def test_model_nonfinite_entries_are_plains():
    idx, cot, drop, kept = _nonfinite_inputs()
    got = gp.segsum_model(idx, cot, 64)
    plain = gp.segsum_plain(idx, cot, 64)
    assert _same_nonfinite(got, plain)
    # A kept lane's non-finite value touches only its own entry.
    touched = {(int(idx[b, i]), c) for b, c, i in kept}
    assert set(map(tuple, (~torch.isfinite(got)).nonzero().tolist())) == touched
    # Dropped lanes' NaN and inf add nothing: zeroing them changes no bit.
    clean = cot.clone()
    for b, i in drop:
        clean[b, :, i] = 0.0
    assert torch.equal(gp.segsum_model(idx, clean, 64).isnan(), got.isnan())
    fin = torch.isfinite(got)
    assert torch.equal(gp.segsum_model(idx, clean, 64)[fin], got[fin])
    ref = gp.segsum_plain(idx, cot.double(), 64)
    assert float((got.double() - ref)[fin].abs().max()
                 / ref[fin].abs().max()) < SEG_TOL


def test_model_adds_cotangents_past_the_tf32_overflow_alone():
    """Values at or above TF32_OVER go the scalar way: their entries are the
    plain sum's, not the 2^128 that hi + lo could reach."""
    idx, cot, _, _ = _nonfinite_inputs(big=True)
    got = gp.segsum_model(idx, cot, 64)
    plain = gp.segsum_plain(idx, cot, 64)
    assert _same_nonfinite(got, plain)
    fin = torch.isfinite(plain)
    rel = (got.double() - plain.double())[fin].abs() / torch.clamp(
        plain.double()[fin].abs(), min=1.0)
    assert float(rel.max()) < SEG_TOL
    assert float(plain.abs()[fin].max()) > 3e38


def test_variants_script_edits_apply_and_it_needs_a_card():
    """benchmarks/segsum_variants.py: each variant's edits still find their
    place in csrc/grad_probes.cu, and without a card it exits 1."""
    from compute_path_tracer_tpu_torch.benchmarks import segsum_variants as sv

    base = sv.SRC.read_text()
    for name, edits, _ in sv.VARIANTS:
        assert (sv._edit(base, edits) != base) == bool(edits), name
    if torch.cuda.is_available():
        pytest.skip("the machine has a card")
    import subprocess
    import sys
    from pathlib import Path

    res = subprocess.run(
        [sys.executable, "-m",
         "compute_path_tracer_tpu_torch.benchmarks.segsum_variants"],
        cwd=Path(__file__).resolve().parents[1], capture_output=True,
        text=True, timeout=120)
    assert res.returncode == 1 and res.stdout.strip() == "", res.stderr
