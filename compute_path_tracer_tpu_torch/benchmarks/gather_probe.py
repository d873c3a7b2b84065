"""Per-thread table-load probe on the card (JAX package:
``benchmarks/gather_probe.py``): what does a lane's dynamic load from a
small table cost, against the arithmetic of a map tap?

The JAX probe asked whether Mosaic could lower a per-lane gather from a
VMEM table at all, for a coarse distance grid (K6).  On this card the
primitive is a load by a per-thread index, so the probe measures that: a
block is one row of the tile, its table in shared memory or read through
``__ldg`` (the form of K6's grid tap), and (kernels/hw_probes.py):

* ``correct128``: one tap of a 128-entry row, held to ``take_along_axis``;
* ``gather128``: ``ITERS`` chained taps (each index from the last value);
* ``arith``: ``ITERS`` arithmetic map taps of 12 shapes (what a grid tap
  must beat);
* ``gather512``: the chain on a 512-entry row (the 8x8x8 grid; Mosaic
  needed four chunk gathers and a select, here it is one load).

16 tiles of (64, 128) (131,072 threads), times by CUDA events over the
repeats queued behind a sleep (``common.queued_ms``), in one process; the
chains are also timed at half their iterations, to show every tap is in the
time, and ``correct128`` beside ``torch.gather`` on the same table and
indices (the one PyTorch call that computes it; its int64 index made
before timing).  Run on a machine with an NVIDIA GPU:

    python -m compute_path_tracer_tpu_torch.benchmarks.gather_probe
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..kernels.hw_probes import (
    GATHER_H,
    GATHER_ITERS,
    GRID_ENTRIES,
    LANES,
    gather_arith,
    gather_chain,
    gather_once,
    gather_once_plain,
)
from .common import queued_ms, require_card

TILES = 16
REPS = 50


def inputs(tiles: int = TILES, device="cuda", h: int = GATHER_H) -> dict:
    """The probe's tables and indices, (tiles, h, 128) rows: the correctness
    table 3 j + 1 with rng(0) indices, the chain's table (7 j mod 13) + 1
    with rng(1) indices, and its four multiples side by side (512 entries)
    with rng(2) indices below 512."""
    j = np.arange(LANES, dtype=np.float32)

    def rows(v):
        return torch.from_numpy(np.ascontiguousarray(
            np.broadcast_to(v, (tiles, h, v.shape[-1])))).to(device)

    def ints(seed, hi):
        return torch.from_numpy(np.random.default_rng(seed).integers(
            0, hi, (tiles, h, LANES)).astype(np.int32)).to(device)

    tab = (j * 7.0) % 13.0 + 1.0
    return {"correct_tab": rows(j * 3.0 + 1.0), "correct_idx": ints(0, LANES),
            "tab": rows(tab), "idx": ints(1, LANES),
            "tab512": rows(np.concatenate([tab * (k + 1) for k in range(4)])),
            "idx512": ints(2, GRID_ENTRIES)}


def kernels(inp, iters: int = GATHER_ITERS) -> dict:
    """Each timed kernel of the probe as a call."""
    calls = {}
    for load, sfx in (("smem", ""), ("ldg", "_ldg")):
        calls["correct128" + sfx] = (
            lambda ld=load: gather_once(inp["correct_tab"], inp["correct_idx"],
                                        ld))
        calls["gather128" + sfx] = (
            lambda ld=load: gather_chain(inp["tab"], inp["idx"], iters, ld))
        calls["gather512" + sfx] = (
            lambda ld=load: gather_chain(inp["tab512"], inp["idx512"], iters,
                                         ld))
    calls["arith"] = lambda: gather_arith(inp["idx"], iters)
    return calls


def measure(tiles: int = TILES, reps: int = REPS) -> dict:
    """Each kernel's time, and JAX's fields per lane tap; ``iters_ratio``
    is each chain's time over its time at half the iterations."""
    inp = inputs(tiles)
    ok = all(torch.equal(gather_once(inp["correct_tab"], inp["correct_idx"],
                                     load),
                         gather_once_plain(inp["correct_tab"],
                                           inp["correct_idx"]))
             for load in ("smem", "ldg"))
    rows = {k: queued_ms(fn, reps) for k, fn in kernels(inp).items()}
    half = {k: queued_ms(fn, reps)
            for k, fn in kernels(inp, GATHER_ITERS // 2).items()
            if not k.startswith("correct")}
    idx64 = inp["correct_idx"].long()
    library = {"correct128": queued_ms(
        lambda: torch.gather(inp["correct_tab"], 2, idx64), reps)}
    lanes = inp["idx"].numel() * GATHER_ITERS
    summary = {"correct128": ok, "iters": GATHER_ITERS, "tiles": tiles,
               "correct128_over_torch_gather": (rows["correct128"]
                                                / library["correct128"])}
    for k in ("gather128", "gather128_ldg", "gather512", "gather512_ldg"):
        summary[f"{k}_ns_per_lane_tap"] = rows[k] * 1e6 / lanes
        summary[f"{k}_vs_maptap"] = rows[k] / rows["arith"]
    summary["arith_maptap_ns_per_lane_tap"] = rows["arith"] * 1e6 / lanes
    summary["iters_ratio"] = {k: rows[k] / v for k, v in half.items()}
    return {"rows": rows, "library": library, "summary": summary}


def main() -> int:
    gpu = require_card("gather_probe")
    out = measure()
    print(json.dumps({"probe": "correct128",
                      "ok": out["summary"]["correct128"]}), flush=True)
    for name, ms in out["rows"].items():
        print(json.dumps({"kernel": name, "ms": ms}), flush=True)
    for name, ms in out["library"].items():
        print(json.dumps({"kernel": name, "torch.gather_ms": ms}), flush=True)
    print(json.dumps(dict(out["summary"], probe="throughput", gpu=gpu)),
          flush=True)
    return 0 if out["summary"]["correct128"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
