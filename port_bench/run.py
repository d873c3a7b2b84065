"""Run one cell of ``BENCHMARK.json`` once and print the result's line.

    python -m port_bench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Everything the cell needs is found by name:
the cell's configuration file (``configs/``), its traffic mix
(``traffic/<mix>.json``, whose ``kind`` names its module in ``drivers/``),
the reference module the configuration or the mix names (``reference/``)
and, with ``--trace 1``, one reader a per-layer metric
(``metrics/<metric>.py``, or ``metrics/<stem>.py`` for ``<stem>.<suffix>``).

A run: set-up and warm-up (``setup_s``: process start to the window's
start, less the seconds the reference spent making an input), the window of ``--seconds`` (end-to-end metrics; under the profiler
with ``--trace 1``, per-layer metrics), the peak memory, then the program's
state freed and the correctness check against the plain reference.  The
last line of standard output is the result; the numbers compared, each
beside its limit, are the last lines of standard error and the result's
last key.  Exit codes: 0 a result was printed (correct or not), 3 no card
or too few, 4 the program is not in the checkout, 5 JAX was loaded.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

PACKAGE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "compute_path_tracer_tpu")
THREADS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda_cache"}


def _args(argv):
    ap = argparse.ArgumentParser(prog="python -m port_bench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def load_benchmark(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def resolve(bench: dict, root: Path, workload: str):
    """``(cell, config entry, configuration, traffic mix)`` of a cell."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(root / entry["file"]) as f:
        config = json.load(f)
    with open(PACKAGE / "traffic" / f"{cell['traffic']}.json") as f:
        mix = json.load(f)
    return cell, entry, config, mix


def metrics_of(bench: dict, kind: str, workload: str):
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
    that list it, and those that list no cells."""
    return [m for m in bench[kind]
            if workload in m.get("workloads", (workload,))]


def driver(kind: str):
    return importlib.import_module(f"port_bench.drivers.{kind}")


def reader(metric: str):
    """The per-layer metric's reader: ``metrics/<metric>.py:read`` or, for a
    metric split by suffix (``idle_share.edit``), the stem's
    ``metrics/idle_share.py:read``."""
    path = PACKAGE / "metrics" / f"{metric}.py"
    if not path.is_file():
        path = PACKAGE / "metrics" / f"{metric.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"port_bench.metrics.{metric.replace('.', '__')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def gpu_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi: not read"


def run_cell(bench, root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device="cuda", check_card: bool = True,
             process_start: float = None, out=sys.stdout, err=sys.stderr):
    """One run of a cell; returns the exit code.  ``check_card=False`` and
    ``device="cpu"`` let a test drive the rest of a run without a card."""
    cell, _entry, config, mix = resolve(bench, root, workload)
    import torch

    if check_card:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell["chips"]:
            print(f"port_bench: the cell needs {cell['chips']} CUDA "
                  f"device(s), this machine has {have}; no result", file=err)
            return 3
    try:
        import compute_path_tracer_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"port_bench: the program is not in this checkout ({e}); "
              "no result", file=err)
        return 4
    cuda = torch.device(device).type == "cuda"
    if cuda:
        print(f"port_bench: {gpu_line()}", file=err)
    run = driver(mix["kind"]).Cell(config, mix, seed, device)
    gc.collect()  # set-up's garbage, so that the window does not pay it
    if cuda:
        torch.cuda.synchronize()
    # The reference's seconds in set-up (an input it makes) are not set-up.
    setup_s = time.perf_counter() - (PROCESS_START if process_start is None
                                     else process_start) - run.reference_s
    view = None
    if trace:
        from .trace import traced

        result, view = traced(lambda: run.window(seconds, traced=True),
                              lambda r: r["units"])
    else:
        result = run.window(seconds, traced=False)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    found = forbidden_modules()
    if found:
        print(f"port_bench: the run loaded {', '.join(found)}; no result",
              file=err)
        return 5
    checks = run.check()
    metrics = {}
    if trace:
        for m in metrics_of(bench, "per_layer", workload):
            value = reader(m["name"])(view, run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = dict(result["metrics"], setup_s=setup_s)
        for m in metrics_of(bench, "end_to_end", workload):
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    limits = mix["limits"]
    correct = all(checks[k] <= limits[k] for k in limits)
    attempted = int(result["units"])
    line = {
        "correct": bool(correct),
        "attempted": attempted,
        "failed": 0 if correct else attempted,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name() if cuda else "cpu",
            "count": cell["chips"],
            "memory_peak_bytes": int(peak),
        },
    }
    if trace:
        line["device"]["busy_s"] = view.busy_s
        line["device"]["window_s"] = view.window_s
        line["breakdown"] = view.breakdown()
    line["checks"] = {k: {"value": checks[k], "limit": limits[k]}
                      for k in limits}
    for k in limits:
        print(f"check {k}: {checks[k]!r} limit {limits[k]!r}", file=err)
    print(json.dumps(line), file=out, flush=True)
    return 0


def main(argv=None) -> int:
    args = _args(argv)
    root = Path.cwd()
    for var, sub in CACHES.items():
        os.environ[var] = str(root / "build" / "port_bench" / sub)
    # One process with few threads: the host's cores are shared.
    for var in THREADS:
        os.environ[var] = "1"
    bench = load_benchmark(root)
    return run_cell(bench, root, args.workload, args.seed, args.seconds,
                    bool(args.trace))
