"""BENCHMARK.json against the benchmark's contract, every file it names
found by name, dummy cells run in a copy, and the imports."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from port_bench import run
from port_bench.reference import load

ROOT = Path(__file__).resolve().parents[2]
PACKAGE = ROOT / "port_bench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.fixture(scope="module")
def bench():
    return run.load_benchmark(ROOT)


def test_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["port_bench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("port_bench/")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        for cell in m.get("workloads", cells):
            reported = run.metrics_of(bench, "end_to_end", cell)
            assert m["moves"] in [r["name"] for r in reported]
    for cell in cells:
        e = [m["name"] for m in run.metrics_of(bench, "end_to_end", cell)]
        assert "setup_s" in e and len(e) >= 2
        assert run.metrics_of(bench, "per_layer", cell)


def test_every_named_file_is_found(bench):
    for w in bench["workloads"]:
        cell, entry, config, mix = run.resolve(bench, ROOT, w["name"])
        assert (ROOT / entry["file"]).is_file()
        assert hasattr(run.driver(mix["kind"]), "Cell")
        assert set(mix["limits"])
        assert hasattr(load(config["renderer"]["reference"]), "trace_samples")
        if "reference" in mix:
            assert hasattr(load(mix["reference"]), "job_step")
    for m in bench["per_layer"]:
        assert callable(run.reader(m["name"]))


# Reference modules a later cell would bring: each stands in for the one it
# wraps and notes that it ran.
DUMMY_RENDER = """from port_bench.reference import render_check
USED = []
work_ops = render_check.work_ops


def trace_samples(*args, **kwargs):
    USED.append(kwargs["options"])
    return render_check.trace_samples(*args, **kwargs)
"""
DUMMY_STEP = """from port_bench.reference import fused_step
USED = []
pinned_slots = fused_step.pinned_slots
work_ops = fused_step.work_ops


def job_step(*args, **kwargs):
    USED.append(kwargs["options"])
    return fused_step.job_step(*args, **kwargs)
"""
PROBE = """import io, json, time
from pathlib import Path
from port_bench import run
from port_bench.reference import load
from port_bench.reference import dummy_render, dummy_step
b = run.load_benchmark(Path.cwd())
assert run.PACKAGE == Path.cwd() / 'port_bench'
ms = [m['name'] for m in run.metrics_of(b, 'per_layer', 'dummy.cell')]
assert ms == ['dummy_ms.dummy'], ms
assert run.reader('dummy_ms.dummy')(None, None) == 42.0
for cell in ('dummy.cell', 'dummy.inverse'):
    out, err = io.StringIO(), io.StringIO()
    rc = run.run_cell(b, Path.cwd(), cell, 2147483659, 0.0, False,
                      device='cpu', check_card=False,
                      process_start=time.perf_counter(), out=out, err=err)
    assert rc == 0, err.getvalue()
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line['correct'] is True, line
    print(cell, sorted(line['metrics']))
assert dummy_render.USED and dummy_step.USED
assert all(o['edge_beta'] == 0.25 for o in dummy_step.USED)
print('found')
"""


def test_a_dummy_cell_config_mix_reference_and_metric_run_in_a_copy(tmp_path):
    """New files and new BENCHMARK.json entries alone make two cells: a
    render cell and an inverse cell, each with a configuration, a traffic
    mix and a reference module of its own, and a per-layer metric read by
    its stem's reader; both run through the harness on the CPU."""
    shutil.copytree(PACKAGE, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    new = tmp_path / "port_bench"
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, src in (("dummy_cfg", "scene64_1080p_preview"),
                      ("dummy_inv_cfg", "scene64_1080p_inverse")):
        cfg = json.loads((PACKAGE / "configs" / f"{src}.json").read_text())
        cfg.update(width=32, height=18, bounces=2)
        cfg["renderer"]["reference"] = "dummy_render"
        (new / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "x",
                                 "file": f"port_bench/configs/{name}.json",
                                 "reduced": ["width", "height", "bounces"],
                                 "why": "a dummy"})
    (new / "reference/dummy_render.py").write_text(DUMMY_RENDER)
    (new / "reference/dummy_step.py").write_text(DUMMY_STEP)
    mix = json.loads((PACKAGE / "traffic" / "converge.json").read_text())
    (new / "traffic/dummy_mix.json").write_text(json.dumps(mix))
    mix = json.loads((PACKAGE / "traffic" / "fused_edge.json").read_text())
    mix["reference"] = "dummy_step"
    mix["steps_per_call"] = 3
    mix["options"]["edge_beta"] = 0.25
    (new / "traffic/dummy_inverse.json").write_text(json.dumps(mix))
    (new / "metrics/dummy_ms.py").write_text(
        "def read(view, run):\n    return 42.0\n")
    bench["workloads"] += [
        {"name": "dummy.cell", "config": "dummy_cfg", "traffic": "dummy_mix",
         "chips": 1, "why": "a dummy"},
        {"name": "dummy.inverse", "config": "dummy_inv_cfg",
         "traffic": "dummy_inverse", "chips": 1, "why": "a dummy"}]
    bench["per_layer"].append({"name": "dummy_ms.dummy", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "device", "moves": "frame_ms",
                               "workloads": ["dummy.cell"]})
    for m in bench["end_to_end"]:
        if m["name"] == "frame_ms":
            m["workloads"].append("dummy.cell")
        if m["name"] in ("step_ms", "peak_mem_gib"):
            m["workloads"].append("dummy.inverse")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    # The copy's port_bench comes first; the program from the repository.
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().splitlines() == [
        "dummy.cell ['frame_ms', 'setup_s']",
        "dummy.inverse ['peak_mem_gib', 'setup_s', 'step_ms']", "found"]


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(PACKAGE.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        found = set(_imports(f)) & {"jax", "jaxlib", "flax",
                                    "compute_path_tracer_tpu"}
        assert not found, (f, found)


def test_the_reference_imports_nothing_of_the_program():
    files = sorted((PACKAGE / "reference").rglob("*.py"))
    assert files
    for f in files:
        assert "compute_path_tracer_tpu_torch" not in set(_imports(f)), f


def _run_command(cwd: Path):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return subprocess.run(
        bench["command"] + ["--workload", bench["workloads"][0]["name"],
                            "--seed", "2147483659", "--seconds", "1",
                            "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_the_command_without_a_card_exits_non_zero_and_prints_nothing():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = _run_command(ROOT)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA device" in out.stderr


def test_the_command_with_only_the_benchmark_exits_non_zero(tmp_path):
    shutil.copytree(PACKAGE, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = _run_command(tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""
