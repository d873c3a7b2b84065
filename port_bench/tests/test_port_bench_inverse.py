"""The inverse cell driven on the CPU at a toy size (32x18, 2 bounces)
through the harness with its look for a card skipped: the program's plain
fused step against the reference, the control, and the step broken
underneath, which the check has to catch."""

import io
import json
import time
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from port_bench import run
from port_bench.drivers import optimize

ROOT = Path(__file__).resolve().parents[2]
CELLS = ("inverse64.fused_edge",)
SEED = 2147495993


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    root = tmp_path_factory.mktemp("toy")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg.update(width=32, height=18, bounces=2)
        c["file"] = f"{c['name']}.json"
        (root / c["file"]).write_text(json.dumps(cfg))
    return root, bench


# A toy window: one call of a few steps.
TOY_STEPS = 3


def _toy_resolve(*args):
    cell, entry, config, mix = RESOLVE(*args)
    return cell, entry, config, dict(mix, steps_per_call=TOY_STEPS)


RESOLVE = run.resolve


def _run(toy, cell):
    root, bench = toy
    out, err = io.StringIO(), io.StringIO()
    with mock.patch.object(run, "resolve", _toy_resolve):
        rc = run.run_cell(bench, root, cell, SEED, 0.0, False, device="cpu",
                          check_card=False, process_start=time.perf_counter(),
                          out=out, err=err)
    assert rc == 0, err.getvalue()
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(toy, cell):
    line = _run(toy, cell)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] == TOY_STEPS
    assert set(line["metrics"]) == {"step_ms", "peak_mem_gib", "setup_s"}
    assert line["checks"]["loss_gap"]["value"] == 0.0
    assert all(v["value"] <= 1e-6 for v in line["checks"].values())


def _broken_fused(kind):
    from compute_path_tracer_tpu_torch.kernels import train

    make = train.make_fused_value_and_grad

    def make_broken(spec, target, *, width, height, bounces=2, **kw):
        vag = make(spec, target, width=width, height=height, bounces=bounces,
                   **kw)
        if kind == "unchanged":
            return lambda p, frame=0: (vag(p)[0], torch.zeros_like(p))
        if kind == "altered":
            return lambda p, frame=0: (lambda l, g: (l * 1.01, g))(*vag(p))
        # Half the frame's rows, the mean taken over them.
        mode = train.fused_mode(spec, bounces, edge_grad=kw["edge_grad"])
        half = height // 2
        planes = torch.as_tensor(target)[:half].permute(2, 0, 1).contiguous()

        def step(p, frame=0):
            sse, grad, _ = train._fused_sse_and_grad_impl(
                spec, p.detach(), planes, frame, 1.0, width / height, 0,
                width=width, height=height, mode=mode)
            return sse / float(width * half * 3), grad * (height / half)

        return step

    return "make_fused_value_and_grad", make_broken


@pytest.mark.parametrize("kind", ("unchanged", "half", "altered"))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_step_is_not_correct(toy, cell, kind, monkeypatch):
    from compute_path_tracer_tpu_torch.diff import inverse

    name, make_broken = _broken_fused(kind)
    monkeypatch.setattr(inverse, name, make_broken)
    line = _run(toy, cell)
    assert line["correct"] is False
    assert line["failed"] == line["attempted"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_a_limit(toy, cell):
    """The reference in bfloat16 in the program's place fails at least one
    number's limit, on three seeds."""
    root, bench = toy
    _, _, config, mix = _toy_resolve(bench, root, cell)
    for seed in (SEED, SEED + 1, SEED + 2):
        c = optimize.Cell(config, mix, seed, "cpu")
        c.window(0.0, traced=False)
        limits = mix["limits"]
        checks = c.check()
        assert all(checks[k] <= limits[k] for k in limits), checks
        ctl = c.control()
        assert any(ctl[k] > limits[k] for k in limits), ctl


def test_leaves_cover_the_parameters_once():
    from port_bench.reference import render_check

    spec, params = render_check.scene_state({"n_prims": 64, "seed": 7})
    groups = optimize.leaves(spec)
    slots = np.concatenate(groups)
    assert len(slots) == len(set(slots.tolist()))
    assert set(slots.tolist()) <= set(range(len(params)))
    assert len(groups) >= 2 * 64


def test_the_seed_draws_the_perturbation_of_the_geometry(toy):
    root, bench = toy
    _, _, config, mix = _toy_resolve(bench, root, CELLS[0])
    a, b = (optimize.Cell(config, mix, s, "cpu") for s in (SEED, SEED + 1))
    moved = optimize.perturbed_slots(a.ref_spec)
    rest = np.setdiff1d(np.arange(a.init.size), moved)
    assert np.array_equal(a.init[rest], b.init[rest])
    assert np.all(a.init[moved] != b.init[moved])
    assert a.reference_s > 0.0
