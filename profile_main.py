#!/usr/bin/env python3
"""Where the port's main-path frame or training-step time goes, on one
NVIDIA GPU.

    python3 profile_main.py [--mode analytic|march|unboxed|grid|train|fused]
                            [--normals kernel|central] [--remat]
                            [--config analytic|march|secondary|unboxed]

``analytic`` (the default), ``march``, ``unboxed`` and ``grid`` drive
RenderSession at 1920x1080 over the 64-primitive benchmark scene with 8
bounces, in one of chip_smoke.py's rendering main paths: K1, the
full-analytic bounce; K2, the baked t-culled sphere march; K2 with
``analytic_unboxed``, the march capped by the closed form of the guard-less
shapes (bench.py:189); or K6, the march on the baked distance grid
(``dist_grid``, benchmarks/distgrid_bench.py).  They print:

* the host-clock ms/frame of REPEATS untraced runs of FRAMES frames;
* from one run of FRAMES frames under torch.profiler: the traced ms/frame
  (tracing adds host time to every op, so it exceeds the untraced figure),
  the device ops per frame, the path's megakernel's and the other device
  ops' time per frame, and the device busy share: the union of device-op intervals
  over the traced window (from the start of the first frame to the later
  of the final synchronize and the last device op's end).

``train`` drives the training step of the same scene and size:
``make_loss(..., geometry="baked", march="kernel", normals=...)`` (by
default ``normals="kernel"``, bench.py's fast-gradient row; ``central`` is
its first row), backward and an Adam step.  It prints the host-clock
ms/step of REPEATS untraced steps and the peak device memory, then from one
traced step the device ops per step, the busy share, and the device time by
part: the K3 kernel (march_rays), the implicit gradient's map vjp (the ops
launched inside the autograd node ``ImplicitCastBackward``), the rest of the
forward (bake, tables, shading, the bounce loop), the rest of the backward
and the Adam update, and the TOP_OPS device ops with the most time.

``fused`` drives the fused train step (kernels/train.py, one K4 launch per
step) of the same scene and size in one of chip_smoke.py's four
configurations (``--config``; by default ``analytic_all`` with the edge
term, the main one; ``unboxed`` is bench.py:442's ``analytic_unboxed``
without the edge term), with an Adam step: the host-clock ms/step of REPEATS
untraced steps and the peak memory, then from one traced step the device
ops, the busy share and the device time by part: K4 (train_fused and its
sum_rows), the bake and tables, the transposes, bake vjp and loss around
the launch, and Adam.

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
TOP_OPS = 10  # train: the device ops with the most time, by part and name
# --mode -> (frame_fn options, the kernel's name in the trace)
MODES = {
    "analytic": (dict(geometry="baked", analytic_all=True),
                 "megakernel_analytic"),
    "march": (dict(geometry="baked", t_cull=True), "megakernel_march"),
    "unboxed": (dict(geometry="baked", t_cull=True, analytic_unboxed=True),
                "megakernel_march"),
    "grid": (dict(geometry="baked", t_cull=True, dist_grid=True),
             "megakernel_march"),
}
# --config of --mode fused -> make_fused_value_and_grad options (bench.py:462,
# :424, :433, :442)
FUSED_CONFIGS = {
    "analytic": dict(analytic_all=True, edge_grad=True),
    "march": dict(edge_grad=True),
    "secondary": dict(edge_grad=True, edge_secondary=True),
    "unboxed": dict(analytic_unboxed=True),
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


def _trace_events(prof):
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def _profile_train(args, gpu) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from compute_path_tracer_tpu_torch.diff import make_loss
    from compute_path_tracer_tpu_torch.scene import (
        benchmark_scene, compile_scene, params_from_numpy)

    cs = compile_scene(benchmark_scene(N_PRIMS))
    p = params_from_numpy(cs.params, cs.spec, "cuda").requires_grad_()
    loss_fn = make_loss(cs.spec, torch.zeros((MAIN_H, MAIN_W, 3), device="cuda"),
                        width=MAIN_W, height=MAIN_H, bounces=BOUNCES,
                        geometry="baked", march="kernel", normals=args.normals,
                        remat=args.remat)
    opt = torch.optim.Adam([p], lr=2e-2, betas=(0.9, 0.999), eps=1e-8)

    def step():
        with record_function("forward"):
            loss = loss_fn(p)
        with record_function("backward"):
            loss.backward()
        with record_function("adam"):
            opt.step()
            opt.zero_grad(set_to_none=True)

    step()  # builds the kernel and fills the per-spec caches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    untraced = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        untraced.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    print("untraced ms/step: " + ", ".join(f"{t:.3f}" for t in untraced))

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("steps"):
            step()
            torch.cuda.synchronize()
    events = _trace_events(prof)
    device = [e for e in events
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    def spans_of(cat, name):
        return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                for e in events if e.get("cat") == cat and e.get("name") == name]

    ranges = {name: spans_of("user_annotation", name)
              for name in ("steps", "forward", "backward", "adam")}
    # The autograd thread's node of ImplicitCast.backward: the implicit
    # gradient's map vjp (kernels/march.py:implicit_grad).
    ranges["implicit_grad"] = spans_of("cpu_op", "ImplicitCastBackward")
    if not device or len(ranges["steps"]) != 1:
        raise RuntimeError(f"the trace holds {len(device)} device ops and "
                           f"{len(ranges['steps'])} 'steps' regions")
    # Each device op's launch, by correlation id, on the host timeline.
    launched = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") == "cuda_runtime"
                and "correlation" in e.get("args", {})}

    def part(e):
        if "march_rays" in e["name"]:
            return "march_rays"
        ts = launched.get(e.get("args", {}).get("correlation"))
        for name in ("implicit_grad", "forward", "backward", "adam"):
            if ts is not None and any(a <= ts <= b for a, b in ranges[name]):
                return name
        return "other"

    by_part, by_name = {}, {}
    for e in device:
        k = part(e)
        by_part[k] = by_part.get(k, 0.0) + float(e["dur"]) / 1e3
        name = (k, e["name"][:90])
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + float(e["dur"]) / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP_OPS]
    if "march_rays" not in by_part:
        raise RuntimeError("no march_rays kernel in the traced step")
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device]
    start, stop = ranges["steps"][0]
    end = max(stop, max(b for _, b in spans))
    summary = {
        "gpu": gpu,
        "mode": "train",
        "normals": args.normals,
        "remat": args.remat,
        "untraced_ms_per_step": untraced,
        "peak_memory_gib": peak / 2**30,
        "traced_ms_per_step": (stop - start) / 1e3,
        "device_ops_per_step": len(device),
        "march_rays_launches": sum("march_rays" in e["name"] for e in device),
        "implicit_grad_nodes": len(ranges["implicit_grad"]),
        "device_ms_by_part": {
            "march_rays (K3)": by_part.get("march_rays", 0.0),
            "implicit-gradient map vjp": by_part.get("implicit_grad", 0.0),
            "forward, other (bake, tables, shading)": by_part.get("forward", 0.0),
            "backward, other (shading)": by_part.get("backward", 0.0),
            "adam": by_part.get("adam", 0.0),
            "unattributed": by_part.get("other", 0.0),
        },
        "device_busy_share": _union_length(spans) / (end - start),
        "top_device_ops": [{"part": k, "name": name, "ms": ms, "count": n}
                           for (k, name), (ms, n) in top],
    }
    print(json.dumps(summary))
    return 0


def _profile_fused(args, gpu) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from compute_path_tracer_tpu_torch.kernels import train as tm
    from compute_path_tracer_tpu_torch.render.scenegen import material_slot_matrix
    from compute_path_tracer_tpu_torch.scene import (
        benchmark_scene, compile_scene, params_from_numpy)

    cs = compile_scene(benchmark_scene(N_PRIMS))
    p = params_from_numpy(cs.params, cs.spec, "cuda").requires_grad_()
    vag = tm.make_fused_value_and_grad(
        cs.spec, torch.zeros((MAIN_H, MAIN_W, 3), device="cuda"), width=MAIN_W,
        height=MAIN_H, bounces=BOUNCES, **FUSED_CONFIGS[args.config])
    opt = torch.optim.Adam([p], lr=2e-2, betas=(0.9, 0.999), eps=1e-8)
    # The refract_chance slots stay at zero, as optimize_to_target pins them:
    # the fused step rejects a scene that refracts.
    pinned = torch.as_tensor(material_slot_matrix(cs.spec)[:, 13],
                             device="cuda")
    tables = tm.fused_tables

    def traced_tables(*a, **kw):
        with record_function("bake"):
            return tables(*a, **kw)

    tm.fused_tables = traced_tables

    def step():
        with record_function("fused_step"):
            _, p.grad = vag(p)
        with record_function("adam"):
            p.grad[pinned] = 0.0
            opt.step()

    step()  # builds the kernel and fills the per-spec caches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    untraced = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        untraced.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    print("untraced ms/step: " + ", ".join(f"{t:.3f}" for t in untraced))

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("steps"):
            step()
            torch.cuda.synchronize()
    events = _trace_events(prof)
    device = [e for e in events
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    ranges = {name: [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                     for e in events if e.get("cat") == "user_annotation"
                     and e.get("name") == name]
              for name in ("steps", "bake", "adam")}
    if not device or len(ranges["steps"]) != 1:
        raise RuntimeError(f"the trace holds {len(device)} device ops and "
                           f"{len(ranges['steps'])} 'steps' regions")
    launched = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") == "cuda_runtime"
                and "correlation" in e.get("args", {})}

    def part(e):
        if "train_fused" in e["name"] or "sum_rows" in e["name"]:
            return "K4"
        ts = launched.get(e.get("args", {}).get("correlation"))
        for name in ("bake", "adam"):
            if ts is not None and any(a <= ts <= b for a, b in ranges[name]):
                return name
        return "transposes"

    by_part = {}
    for e in device:
        k = part(e)
        by_part[k] = by_part.get(k, 0.0) + float(e["dur"]) / 1e3
    if "K4" not in by_part:
        raise RuntimeError("no train_fused kernel in the traced step")
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device]
    start, stop = ranges["steps"][0]
    end = max(stop, max(b for _, b in spans))
    summary = {
        "gpu": gpu,
        "mode": "fused",
        "config": args.config,
        "untraced_ms_per_step": untraced,
        "peak_memory_gib": peak / 2**30,
        "traced_ms_per_step": (stop - start) / 1e3,
        "device_ops_per_step": len(device),
        "device_ms_by_part": {
            "K4 (train_fused + sum_rows)": by_part.get("K4", 0.0),
            "bake and tables": by_part.get("bake", 0.0),
            "transposes, bake vjp, loss": by_part.get("transposes", 0.0),
            "adam": by_part.get("adam", 0.0),
        },
        "device_busy_share": _union_length(spans) / (end - start),
    }
    print(json.dumps(summary))
    return 0


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="analytic",
                    choices=tuple(MODES) + ("train", "fused"))
    ap.add_argument("--config", default="analytic",
                    choices=tuple(FUSED_CONFIGS),
                    help="fused: analytic_all + edge_grad (the main one), "
                         "march + edge_grad, with edge_secondary, or "
                         "analytic_unboxed")
    ap.add_argument("--normals", default="kernel", choices=("kernel", "central"),
                    help="train: the shading normal (kernel = K3's, detached)")
    ap.add_argument("--remat", action="store_true",
                    help="train: recompute each bounce in the backward")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("profile_main: no CUDA device; run this on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    if args.mode == "fused":
        gpu = _gpu_line()
        print(f"gpu: {gpu}, mode: fused, config: {args.config}")
        return _profile_fused(args, gpu)
    if args.mode == "train":
        gpu = _gpu_line()
        print(f"gpu: {gpu}, mode: train, normals: {args.normals}, remat: "
              f"{args.remat}")
        return _profile_train(args, gpu)
    mode, kernel_name = MODES[args.mode]

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
    events = _trace_events(prof)
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
