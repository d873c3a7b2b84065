"""The readings that set a cell's correctness limits, on the card:

    python -m port_bench.calibrate --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] --control <k>

For each seed one window of the cell's traffic and its check, as a run
makes them (the program's reading: the lower end of each limit), and for
the first ``k`` seeds also the control in the program's place (the
reference in bfloat16: the upper end) and, for an inverse cell, each
fault ``drivers/optimize.py`` can plant in the reference (``FAULTS``).
One JSON line a seed; the benchmark's own runs do not run this."""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from .run import CACHES, driver, load_benchmark, resolve


def main(argv=None) -> int:
    import os

    ap = argparse.ArgumentParser(prog="python -m port_bench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args(argv)
    root = Path.cwd()
    for var, sub in CACHES.items():
        os.environ[var] = str(root / "build" / "port_bench" / sub)
    import torch

    if not torch.cuda.is_available():
        print("port_bench.calibrate: no CUDA device")
        return 3
    _cell, _entry, config, mix = resolve(load_benchmark(root), root,
                                         args.workload)
    for i, seed in enumerate(args.seeds):
        run = driver(mix["kind"]).Cell(config, mix, seed, "cuda")
        window = run.window(args.seconds, traced=False)
        t0 = time.perf_counter()
        checks = run.check()
        t1 = time.perf_counter()
        line = {"workload": args.workload, "seed": seed,
                "units": window["units"], "metrics": window["metrics"],
                "program": checks, "reference_s": t1 - t0}
        if hasattr(run, "look"):
            line["look"] = run.look()
        if i < args.control:
            line["control"] = run.control()
            line["control_s"] = time.perf_counter() - t1
            for fault in getattr(run, "FAULTS", ()):
                line[f"fault_{fault}"] = run.compare(
                    run.reference(fault=fault), run.want)
        print(json.dumps(line), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
