#!/usr/bin/env python3
"""Where the port's main-path frame time goes, on one NVIDIA GPU.

    python3 profile_main.py [--mode analytic|march]

Drives RenderSession at 1920x1080 over the 64-primitive benchmark scene with
8 bounces, in one of chip_smoke.py's two main paths: ``analytic`` (the
default: K1, the full-analytic bounce) or ``march`` (K2, the baked
t-culled sphere march), and prints:

* the host-clock ms/frame of REPEATS untraced runs of FRAMES frames;
* from one run of FRAMES frames under torch.profiler: the traced ms/frame
  (tracing adds host time to every op, so it exceeds the untraced figure),
  the device ops per frame, the path's megakernel's and the other device
  ops' time per frame, and the device busy share: the union of device-op intervals
  over the traced window (from the start of the first frame to the later
  of the final synchronize and the last device op's end).

The last line is one JSON object with those numbers.  Exits non-zero
without a result when torch finds no CUDA device.  Imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
from functools import partial

MAIN_W, MAIN_H, BOUNCES, N_PRIMS = 1920, 1080, 8, 64
FRAMES = 8
REPEATS = 5
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# --mode -> (frame_fn options, the kernel's name in the trace)
MODES = {
    "analytic": (dict(geometry="baked", analytic_all=True),
                 "megakernel_analytic"),
    "march": (dict(geometry="baked", t_cull=True), "megakernel_march"),
}


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _union_length(intervals) -> float:
    """Total length covered by ``(start, end)`` intervals."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="analytic", choices=tuple(MODES))
    args = ap.parse_args()
    mode, kernel_name = MODES[args.mode]

    if not torch.cuda.is_available():
        print("profile_main: no CUDA device; run this on an NVIDIA GPU",
              file=sys.stderr)
        return 1

    from torch.profiler import ProfilerActivity, profile, record_function

    from compute_path_tracer_tpu_torch.app.config import Settings
    from compute_path_tracer_tpu_torch.kernels import render_frame_megakernel
    from compute_path_tracer_tpu_torch.render.session import RenderSession
    from compute_path_tracer_tpu_torch.scene import benchmark_scene

    gpu = _gpu_line()
    print(f"gpu: {gpu}, mode: {args.mode}")
    sess = RenderSession(benchmark_scene(N_PRIMS), MAIN_W, MAIN_H,
                         Settings(debug=0, bounces=BOUNCES),
                         frame_fn=partial(render_frame_megakernel, **mode),
                         device="cuda")
    sess.step()  # builds the kernel and fills the per-layout caches
    torch.cuda.synchronize()

    untraced = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        for _ in range(FRAMES):
            sess.step()
        torch.cuda.synchronize()
        untraced.append((time.perf_counter() - t0) / FRAMES * 1e3)
    print("untraced ms/frame: " + ", ".join(f"{t:.3f}" for t in untraced))

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("frames"):
            for _ in range(FRAMES):
                sess.step()
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]

    device = [e for e in events
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    region = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("name") == "frames"]
    if not device or len(region) != 1:
        raise RuntimeError(f"the trace holds {len(device)} device ops and "
                           f"{len(region)} 'frames' regions")
    mega = [e for e in device if kernel_name in e["name"]]
    if len(mega) != FRAMES:
        raise RuntimeError(f"{len(mega)} megakernel launches traced for "
                           f"{FRAMES} frames")
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device]
    start = float(region[0]["ts"])
    end = max(start + float(region[0]["dur"]), max(b for _, b in spans))
    mega_us = sum(float(e["dur"]) for e in mega)
    all_us = sum(float(e["dur"]) for e in device)
    summary = {
        "gpu": gpu,
        "mode": args.mode,
        "frames": FRAMES,
        "untraced_ms_per_frame": untraced,
        "traced_ms_per_frame": float(region[0]["dur"]) / FRAMES / 1e3,
        "device_ops_per_frame": len(device) / FRAMES,
        "megakernel_ms_per_frame": mega_us / FRAMES / 1e3,
        "other_device_ms_per_frame": (all_us - mega_us) / FRAMES / 1e3,
        "device_busy_share": _union_length(spans) / (end - start),
    }
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
