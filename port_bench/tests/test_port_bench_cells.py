"""The render cells driven on the CPU at a toy size (32x18, 2 bounces)
through the harness with its look for a card skipped: the program's plain
path against the reference, the control, and a timed path broken
underneath, which the check has to catch."""

import io
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from port_bench import run
from port_bench.drivers import edit, progressive, render

ROOT = Path(__file__).resolve().parents[2]
CELLS = ("preview64.converge", "preview64.edit")
SEED = 2147495993


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """A checkout whose BENCHMARK.json points the render configuration at a
    32x18, 2-bounce copy of it."""
    root = tmp_path_factory.mktemp("toy")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg.update(width=32, height=18, bounces=2)
        c["file"] = f"{c['name']}.json"
        (root / c["file"]).write_text(json.dumps(cfg))
    return root, bench


def _run(toy, cell, seed=SEED):
    root, bench = toy
    out, err = io.StringIO(), io.StringIO()
    rc = run.run_cell(bench, root, cell, seed, 0.0, False, device="cpu",
                      check_card=False, process_start=time.perf_counter(),
                      out=out, err=err)
    assert rc == 0, err.getvalue()
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert err.getvalue().strip().splitlines()[-1].startswith("check ")
    return line


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(toy, cell):
    line = _run(toy, cell)
    assert line["correct"] is True
    assert line["attempted"] == 1 and line["failed"] == 0
    assert set(line["metrics"]) == {
        m["name"] for m in run.metrics_of(toy[1], "end_to_end", cell)}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert line["checks"]["pixel_rel_l1"]["value"] == 0.0


def _broken(kind):
    """A frame function that breaks the frame where it is produced."""
    def wrap(frame_fn):
        def frame(spec, params, accum=None, **kw):
            before = None if accum is None else accum.clone()
            if kind == "unchanged":
                h, w = kw["height"], kw["width"]
                return before if before is not None else torch.zeros(h, w, 3)
            out = frame_fn(spec, params, accum, **kw)
            if kind == "half":
                h = out.shape[0]
                out[h // 2:] = 0.0 if before is None else before[h // 2:]
            elif kind == "altered":
                out[..., 0] = out[..., 1]
            return out
        return frame
    return wrap


@pytest.mark.parametrize("kind", ("unchanged", "half", "altered"))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_frame_is_not_correct(toy, cell, kind, monkeypatch):
    make = render.make_session

    def make_broken(config, device):
        scene, session = make(config, device)
        session.frame_fn = _broken(kind)(session.frame_fn)
        return scene, session

    monkeypatch.setattr(progressive, "make_session", make_broken)
    monkeypatch.setattr(edit, "make_session", make_broken)
    line = _run(toy, cell)
    assert line["correct"] is False
    assert line["failed"] == line["attempted"]


@pytest.mark.parametrize("module,cell", ((progressive, CELLS[0]),
                                         (edit, CELLS[1])))
def test_the_control_fails_the_limit(toy, module, cell):
    """The reference in bfloat16 in the program's place reads over the
    limit, on three seeds."""
    root, bench = toy
    _, entry, config, mix = run.resolve(bench, root, cell)
    limit = mix["limits"]["pixel_rel_l1"]
    for seed in (SEED, SEED + 1, SEED + 2):
        c = module.Cell(config, mix, seed, "cpu")
        c.window(0.0, traced=False)
        assert c.check()["pixel_rel_l1"] <= limit
        assert c.control()["pixel_rel_l1"] > limit


def test_edits_move_back_and_stay_small(toy):
    root, bench = toy
    _, _, config, mix = run.resolve(bench, root, CELLS[1])
    c = edit.Cell(config, dict(mix, warmup_edits=0), SEED, "cpu")
    for _ in range(200):
        c.edit()
        for i, pos in c.moved.items():
            assert np.linalg.norm(np.subtract(pos, c.origin[i])) <= 0.05
    for i, s in enumerate(c.shapes):
        want = c.moved.get(i, c.origin[i])
        assert tuple(s.transform.position.value) == pytest.approx(want)
