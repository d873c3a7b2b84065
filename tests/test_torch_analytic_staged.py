"""K1's staged tables and hoisted quotient, on the CPU.

The CUDA kernel (kernels/csrc/megakernel_analytic.cu) stages the scene in
shared memory as per-shape records (render/soa.py:build_staged_layout) and
divides by the ray's direction through its hoisted reciprocal
(analytic_staged.cuh:recip_quotient).  These tests hold:

* the plain cast over the staged records to the packed tables' cast
  (``make_cast_soa``), bit for bit, and to the JAX package's
  ``make_cast_soa`` under tests/test_torch_megakernel.py's contract;
* the plain model of the hoisted quotient (float32 reciprocal, exact FMAs)
  to ``x / d`` bit for bit in the kernel's range, with its edge values,
  and the box decisions through it to ``_slab_hit``'s;
* the staged table's shared-memory size and its cap;
* the lane-fill helper (app/profiling.py:lane_fill).

The kernel itself is held to the plain frame on the card by chip_smoke.py.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compute_path_tracer_tpu.render import baked as jb
from compute_path_tracer_tpu.render import soa as js
from compute_path_tracer_tpu.scene import compile_scene as j_compile
from compute_path_tracer_tpu.scene import library as j_lib
from compute_path_tracer_tpu.scene.model import KIND_SPHERE as J_SPHERE
from compute_path_tracer_tpu.scene.model import Scene as JScene
from compute_path_tracer_tpu.scene.model import Shape as JShape
from compute_path_tracer_tpu.scene.model import Union as JUnion
from compute_path_tracer_tpu.vecmath import Vec3 as JVec3
from compute_path_tracer_tpu_torch.app.profiling import lane_fill
from compute_path_tracer_tpu_torch.kernels import megakernel as mk
from compute_path_tracer_tpu_torch.render import soa as ts
from compute_path_tracer_tpu_torch.render.program import SMEM_PER_BLOCK
from compute_path_tracer_tpu_torch.scene import compile_scene as t_compile
from compute_path_tracer_tpu_torch.scene import (
    benchmark_scene, convert_scene, params_from_numpy)
from compute_path_tracer_tpu_torch.vecmath import Vec3 as TVec3

# The largest benchmark_scene(n) whose staged table a block holds.
N_MAX_STAGED = 1623


def _clobber_scene():
    """A guarded first shape beside a child union: its box is an ancestor
    guard (a > 0) of the child's shapes."""
    root = JUnion(name="R")
    child = JUnion(name="C")
    inner = child.add_shape(JShape(J_SPHERE, name="inner"))
    inner.transform.aabb = False
    inner.size.set(0.8)
    root.add_union(child)
    first = root.add_shape(JShape(J_SPHERE, name="first"))
    first.transform.position.set(0.5, 0.0, 0.0)
    return JScene([root])


SCENES = {
    "benchmark_scene(64)": lambda: j_lib.benchmark_scene(64),
    "benchmark_scene(256)": lambda: j_lib.benchmark_scene(256),
    "clobber": _clobber_scene,
    "glass_demo": j_lib.glass_demo,
}


def _rays(n, seed):
    r = np.random.default_rng(seed)
    ro = r.uniform(-6, 6, (n, 3)).astype(np.float32)
    rd = r.uniform(-2, 2, (n, 3)).astype(np.float32) - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, rd


def _j3(a):
    return JVec3(*(jnp.asarray(a[:, i]) for i in range(3)))


def _t3(a):
    return TVec3(*(torch.from_numpy(np.ascontiguousarray(a[:, i]))
                   for i in range(3)))


def _tables(scene):
    """(JAX compiled scene, baked vector, torch layout, soa_f, soa_i) with
    both casts reading the same baked vector."""
    jc = j_compile(scene)
    tc = t_compile(convert_scene(scene))
    bv = jb.bake(jc.spec, jnp.asarray(jc.params))
    layout = ts.build_soa_smem_layout(tc.spec)
    f, i = ts.pack_soa_smem(layout, torch.from_numpy(np.array(bv)),
                            torch.from_numpy(tc.params))
    return jc, bv, layout, f, i


@pytest.mark.parametrize("name", list(SCENES))
def test_staged_cast_matches_packed_and_jax(name):
    jc, bv, layout, f, i = _tables(SCENES[name]())
    words = ts.stage_tables(layout, f, i)
    ro, rd = _rays(2048, 5)
    t_s, i_s = ts.make_cast_staged(layout)(_t3(ro), _t3(rd), words)
    t_p, i_p = ts.make_cast_soa(layout)(_t3(ro), _t3(rd), f, i)
    assert torch.equal(t_s, t_p) and torch.equal(i_s, i_p)
    t_j, i_j = map(np.asarray, js.make_cast_soa(js.build_soa_plan(jc.spec))(
        _j3(ro), _j3(rd), bv))
    t_s, i_s = t_s.numpy(), i_s.numpy()
    hit = t_j < 100.0
    assert hit.any() and (~hit).any()
    assert (t_s[~hit] > 100.0).all()
    if name == "clobber":
        assert max(layout.kinds, key=lambda k: k.a).a > 0
        assert (i_s == i_j).all()
        return
    assert (i_s == i_j).mean() >= 0.999  # fp-tie lanes only
    # XLA fuses multiply-adds that the port (and the kernel, under
    # -fmad=false) rounds apart, which moves near-grazing hits by up to a
    # few 1e-4 (3 of 1,808 hits at 256 primitives): all but 0.5 % of the
    # hits within 1e-5.
    close = np.isclose(t_s[hit], t_j[hit], rtol=1e-5, atol=1e-5)
    assert close.mean() >= 0.995
    np.testing.assert_allclose(t_s[hit], t_j[hit], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("name", list(SCENES))
def test_staged_records_hold_the_packed_rows(name):
    """Each record's box, flags, shape id and geometry are the packed
    tables' row of that shape, at 16-byte aligned offsets, and the material
    rows are the packed ones."""
    _jc, _bv, layout, f, i = _tables(SCENES[name]())
    st = ts.build_staged_layout(layout)
    words = ts.stage_tables(layout, f, i)
    assert st.n_words % 4 == 0 and st.mat % 4 == 0
    assert 4 * st.n_words == ts.analytic_smem_bytes(layout)
    for kd in layout.kinds:
        k = kd.kind
        assert st.rec[k] % 4 == 0 and st.stride[k] % 4 == 0
        geom, box, anc, sid, guard, anc_valid = ts._staged_kind(st, k, words)
        p_geom, p_box, p_anc, p_sid, p_guard, p_valid = ts._kind_tables(
            kd, f, i)
        n = kd.n
        assert torch.equal(geom, p_geom[:n]) and torch.equal(box, p_box[:n])
        assert torch.equal(anc, p_anc[:n]) and torch.equal(sid, p_sid[:n])
        assert torch.equal(guard, p_guard[:n])
        assert torch.equal(anc_valid, p_valid[:n])
    mats = ts.material_table(layout, f)[:layout.n_shapes]
    assert torch.equal(ts.staged_materials(layout, words), mats)


# -- the hoisted quotient ------------------------------------------------------


def _round_f32(v: Fraction) -> np.float32:
    """An exact rational rounded to float32, ties to even."""
    if v == 0:
        return np.float32(0.0)
    sign, v = (-1 if v < 0 else 1), abs(v)
    e = v.numerator.bit_length() - v.denominator.bit_length()
    if Fraction(2) ** e > v:
        e -= 1
    scale = Fraction(2) ** (23 - max(e, -126))
    m = v * scale
    q, rem = divmod(m.numerator, m.denominator)
    if 2 * rem > m.denominator or (2 * rem == m.denominator and q % 2):
        q += 1
    return np.float32(sign * float(Fraction(q) / scale))


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def test_fma_model_is_exact():
    """ts.fma32 rounds a * b + c once: the remainder and correction steps
    of the model, on scene-range triples, against exact rationals."""
    b, o, d = ts.quotient_triples(3000, 17)
    x = b - o
    keep = ts.recip_in_range(b, o, d) & (x != 0)
    x, d = x[keep], d[keep]
    y = np.float32(1.0) / d
    q0 = x * y
    r = ts.fma32(-d, q0, x)
    q1 = ts.fma32(r, y, q0)
    for args, out in (((-d, q0, x), r), ((r, y, q0), q1)):
        exact = [_round_f32(Fraction(float(a)) * Fraction(float(bb))
                            + Fraction(float(c))) for a, bb, c in zip(*args)]
        nz = out != 0
        assert (_bits(out)[nz] == _bits(exact)[nz]).all()
        assert (np.asarray(exact)[~nz] == 0).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_hoisted_quotient_is_the_division(seed):
    b, o, d = ts.quotient_triples(100_000, seed)
    ok = ts.recip_in_range(b, o, d)
    assert ok.mean() > 0.9 and (~ok).any()
    x = b - o
    q = ts.recip_quotient_plain(x[ok], d[ok])
    assert (_bits(q) == _bits(x[ok] / d[ok])).all()


def test_hoisted_quotient_edges():
    b, o, d, must_divide = ts.quotient_edges()
    ok = ts.recip_in_range(b, o, d)
    assert not (ok & must_divide).any()
    assert ok[~must_divide].all()
    x = b - o
    assert (x[ok] == 0).any() and (x[ok] == d[ok]).any()
    q = ts.recip_quotient_plain(x[ok], d[ok])
    assert (_bits(q) == _bits(x[ok] / d[ok])).all()
    # The wrapper's plain path is the same model.
    q_fast, q_div, in_range = mk.quotient_check(
        *(torch.from_numpy(a) for a in (b, o, d)))
    assert (in_range.numpy() == ok).all()
    assert (_bits(q_fast.numpy()[ok]) == _bits(q_div.numpy()[ok])).all()


def _slab_decisions(box, ro, rd, quotient):
    """common.cuh:slab_box over (rows, 6) boxes and (lanes,) rays with the
    given quotient, NaN-propagating as the kernel's nan_min / nan_max."""
    tn = torch.full((box.shape[0], ro.shape[0]), -np.inf)
    tf = torch.full_like(tn, np.inf)
    for k in range(3):
        ta = torch.from_numpy(quotient(box[:, k:k + 1] - ro[None, :, k],
                                       rd[None, :, k]))
        tb = torch.from_numpy(quotient(box[:, 3 + k:4 + k] - ro[None, :, k],
                                       rd[None, :, k]))
        tn = torch.maximum(tn, torch.minimum(ta, tb))
        tf = torch.minimum(tf, torch.maximum(ta, tb))
    return (tn < tf) & (tf > 0.0)


def test_slab_decisions_through_the_model():
    _jc, _bv, layout, f, i = _tables(j_lib.benchmark_scene(64))
    words = ts.stage_tables(layout, f, i)
    st = ts.build_staged_layout(layout)
    box = torch.cat([ts._staged_kind(st, k, words)[1] for k in range(ts.KINDS)
                     if st.n[k]]).numpy()
    assert ts.recip_in_range(box, 0.0, 1.0).all()
    ro, rd = _rays(512, 9)
    rd[:8, 0] = 0.0        # axis-parallel rays take the plain division
    fast = ts.recip_in_range(1.0, ro, rd).all(axis=1)
    assert fast.mean() > 0.9 and (~fast).any()
    model = _slab_decisions(box, ro[fast], rd[fast], ts.recip_quotient_plain)
    ref = ts._slab_hit(torch.from_numpy(box), _t3(ro[fast]), _t3(rd[fast]))
    assert model.any() and torch.equal(model, ref)


# -- the staged table's size ---------------------------------------------------


@pytest.mark.parametrize("n, f_bytes, i_bytes, staged", [
    (64, 9_088, 640, 8_928),
    (256, 34_112, 2_112, 36_816),
    (512, 68_128, 4_288, 72_864),
])
def test_analytic_smem_bytes(n, f_bytes, i_bytes, staged):
    layout = ts.build_soa_smem_layout(
        t_compile(benchmark_scene(n)).spec)
    assert (4 * layout.f_len, 4 * layout.i_len) == (f_bytes, i_bytes)
    assert ts.analytic_smem_bytes(layout) == staged


def test_analytic_smem_cap():
    fits = ts.build_soa_smem_layout(
        t_compile(benchmark_scene(N_MAX_STAGED)).spec)
    assert ts.analytic_smem_bytes(fits) <= SMEM_PER_BLOCK
    over = ts.build_soa_smem_layout(
        t_compile(benchmark_scene(N_MAX_STAGED + 1)).spec)
    with pytest.raises(ValueError, match=r"232512 bytes, more than 232448"):
        ts.analytic_smem_bytes(over)


# -- lane fill -----------------------------------------------------------------


def test_lane_fill_synthetic():
    bounces = 8
    img = torch.zeros((4, 32, 3))
    # Warp (0, 0): one lane casts 9 times (never exits), 31 once.
    img[0, 0] = (bounces + 1) / bounces
    # Warp (0, 1): every lane casts 3 times (exit at bounce 2).
    img[0:2, 16:32] = 2 / bounces
    # Warps (1, 0) and (1, 1): a row of lanes casting 5 times and 1.
    img[2, 0:16] = 4 / bounces
    out = lane_fill(img, bounces)
    lanes = 9 + 31 + 3 * 32 + 5 * 16 + 16 + 32
    assert out["fill"] == pytest.approx(lanes / (32 * (9 + 3 + 5 + 1)))
    assert out["mean_longest"] == pytest.approx((9 + 3 + 5 + 1) / 4)
    assert out["mean_casts"] == pytest.approx(lanes / 128)
    # A ragged frame: the missing lanes of an edge warp cast nothing.
    out = lane_fill(img[:3, :20], bounces)
    lanes = 9 + 31 + 3 * 8 + 5 * 16 + 4
    assert out["fill"] == pytest.approx(lanes / (32 * (9 + 3 + 5 + 1)))


def test_lane_fill_benchmark_frame():
    cs = t_compile(benchmark_scene(64))
    params = params_from_numpy(cs.params, cs.spec, torch.device("cpu"))
    img = mk.render_frame_megakernel(cs.spec, params, width=320, height=180,
                                     bounces=8, debug=3, geometry="baked",
                                     analytic_all=True)
    assert lane_fill(img, 8)["fill"] == pytest.approx(0.5913, abs=5e-5)
