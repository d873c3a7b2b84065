"""Port parity: the profiling module (app/profiling.py) against the JAX
package's (``app/profiling.py``).

* ``measured_frame_cost`` reads debug 4 per group of pixels: on the CPU its
  sums are the plain reducer's (kernels/megakernel.py:MarchStats), per
  warp of K2 by default;
* under JAX's tile cull and tile grouping (tests/test_torch_stats.py's
  anchor) its ``march_steps_total`` is the JAX module's, aggregated by the
  JAX module itself (its ``render_frame_pallas`` run in interpret mode);
* ``FrameCost`` is the JAX package's model;
* the bound's arithmetic, and no timing without a card.
"""

from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import compute_path_tracer_tpu.kernels.megakernel as jmk
from compute_path_tracer_tpu.app import profiling as jpf
from compute_path_tracer_tpu_torch.app import profiling as pf
from compute_path_tracer_tpu_torch.kernels import megakernel as mk
from compute_path_tracer_tpu_torch.render.program import (
    build_program, program_table)
from test_torch_stats import JTILE, MARCH, pair, tile_cull_march

W, H, BOUNCES = 64, 32, 2


def test_measured_frame_cost_sums_the_warps():
    _, tc = pair("bench16")
    pv = torch.from_numpy(tc.params)
    cost = pf.measured_frame_cost(tc.spec, pv, width=W, height=H,
                                  bounces=BOUNCES)
    img = mk.render_frame_megakernel_plain(tc.spec, pv, width=W, height=H,
                                           bounces=BOUNCES, debug=4, frame=1,
                                           last_clear=1, **MARCH).numpy()
    warps = img[::2, ::16].reshape(-1, 3).astype(np.float64)
    assert warps.shape == (H // 2 * W // 16, 3)
    assert cost["march_steps_total"] == warps[:, 0].sum() > 0
    assert cost["march_evals"] == 32 * warps[:, 1].sum() > 0
    assert cost["aux_evals"] == 32 * warps[:, 2].sum() > 0
    total = cost["march_evals"] + cost["aux_evals"]
    assert cost["shape_evals_executed"] == total
    assert cost["shape_evals_per_ray"] == total / (W * H * (BOUNCES + 1))
    assert cost["device"] == "cpu"
    # The lane slots a warp executes cover the lanes' own work.
    lanes = pf.measured_frame_cost(tc.spec, pv, width=W, height=H,
                                   bounces=BOUNCES, group=(1, 1))
    assert lanes["march_evals"] <= cost["march_evals"]
    assert lanes["aux_evals"] <= cost["aux_evals"]


def test_march_steps_total_matches_jax_under_its_tile_cull(monkeypatch):
    jc, tc = pair("bench16")
    monkeypatch.setattr(jmk, "render_frame_pallas",
                        partial(jmk.render_frame_pallas, interpret=True))
    j = jpf.measured_frame_cost(jc.spec, jnp.asarray(jc.params), width=128,
                                height=32, bounces=BOUNCES, tile=JTILE)
    pv = torch.from_numpy(tc.params)
    stats = mk.MarchStats(JTILE)
    table = program_table(build_program(tc.spec, "baked"), pv, True)
    monkeypatch.setattr(mk, "cast_tcull", tile_cull_march(stats, table))
    monkeypatch.setattr(pf, "MarchStats", lambda group: stats)
    t = pf.measured_frame_cost(tc.spec, pv, width=128, height=32,
                               bounces=BOUNCES, group=JTILE)
    assert t["march_steps_total"] == j["march_steps_total"] > 0


def test_frame_cost_is_the_jax_model():
    for args in ((1920, 1080, 64, 8), (64, 32, 16, 0)):
        j, t = jpf.FrameCost(*args), pf.FrameCost(*args)
        assert t.flops == j.flops
        assert t.map_evals_per_bounce == j.map_evals_per_bounce
        assert t.achieved_tflops(0.02) == j.achieved_tflops(0.02)
        assert t.utilization(0.02, 50.0) == t.achieved_tflops(0.02) / 50.0


def test_bound_and_operation_counts():
    _, tc = pair("bench16")
    prog = build_program(tc.spec, "baked")
    count = {"segments": 100, "taps": 1000, 0: 500, 1: 200, 2: 1000, 3: 100}
    march = pf.march_ops(count, prog)
    assert march == (100 * prog.n_boxed * pf.SLAB_OPS + 1000 * pf.TAP_OPS
                     + 500 * 12 + 200 * 39 + 1000 * 7 + 100 * 32)
    # The dense probe pays every leaf of the program on every tap.
    assert pf.dense_ops(count, prog) > march
    assert pf.bound_ms(3.35e9, 1.0, 1e12) == (pytest.approx(1.0), "bytes")
    assert pf.bound_ms(1.0, 2e9, 1e12) == (pytest.approx(2.0), "operations")


def test_no_frame_time_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("the machine has a card")
    with pytest.raises((AssertionError, RuntimeError)):
        pf.measure_frame_time(lambda: None)


def test_wavefront_work_is_k2s_march_and_the_compactions_bytes():
    """The wavefront frame marches K2's faithful exact frame's rays: the
    same segments, taps and leaves; its bytes are the bounces' and the
    compactions'."""
    from compute_path_tracer_tpu_torch.benchmarks import frozen_wavefront as fw

    _, tc = pair("bench16")
    pv = torch.from_numpy(tc.params)
    kw = dict(width=W, height=H, bounces=BOUNCES)
    count, k2 = {}, {}
    fw.render_frame_wavefront(tc.spec, pv, count=count, **kw)
    mk.render_frame_megakernel_plain(tc.spec, pv, count=k2, **kw)
    prog = build_program(tc.spec, "faithful")
    ops, n_bytes = pf.wavefront_work(count, prog)
    assert ops == pf.march_ops(k2, prog)
    assert 0 < int(count["survivors"]) < count["segments"] <= W * H * 3
    assert n_bytes == (count["segments"] * 96
                       + int(count["survivors"]) * 96)


def test_fused_bwd_ops_are_the_march_and_the_hits_normal_taps():
    from compute_path_tracer_tpu_torch.kernels import grad_probes as gp
    from compute_path_tracer_tpu_torch.kernels.march import march_rays_plain

    _, tc = pair("bench16")
    pv = torch.from_numpy(tc.params)
    prog = build_program(tc.spec, "baked")
    table = program_table(prog, pv)
    _, ro, rd = gp.fused_bwd_rays((896, 520, 32, 16), "cpu")
    count = {"segments": 512}
    t, _ = march_rays_plain(prog, table, ro, rd, t_cull=False,
                            with_normal=False, count=count)
    hits = int((t <= 100.0).sum())
    assert 0 < hits < 512
    ops = pf.fused_bwd_ops(prog, table, ro, rd)
    assert ops > pf.march_ops(count, prog)
    count["taps"] += 6 * hits
    assert ops < pf.march_ops(count, prog) + 6 * hits * prog.n_boxed * 39


def test_segsum_bytes_at_k4s_shape():
    """(4 + 4 C) bytes an element and the sums: about 1.05 GB, 0.31 ms at
    K4's main shape (9 bounces of 1080p, 13 channels, 64 shapes)."""
    n_bytes = pf.segsum_bytes(9, 1920 * 1080, 13, 64)
    assert n_bytes == 9 * 1920 * 1080 * 56 + 4 * 64 * 13
    assert pf.bound_ms(n_bytes, 0.0, 1e12) == (pytest.approx(0.3120, abs=1e-4),
                                                "bytes")


@pytest.mark.parametrize("name", ["diagnose", "dense_probe", "analytic_probe",
                                  "ilp_probe", "kernel_ab", "frozen_wavefront",
                                  "probe_fused_bwd", "probe_inkernel_segsum"])
def test_card_measurements_exit_without_a_card(name):
    """The port's measurements run on the card only: without one each
    exits 1 and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("the machine has a card")
    import subprocess
    import sys
    from pathlib import Path

    res = subprocess.run(
        [sys.executable, "-m", f"compute_path_tracer_tpu_torch.benchmarks.{name}"],
        cwd=Path(__file__).resolve().parents[1], capture_output=True,
        text=True, timeout=120)
    assert res.returncode == 1, res.stderr
    assert res.stdout.strip() == ""
