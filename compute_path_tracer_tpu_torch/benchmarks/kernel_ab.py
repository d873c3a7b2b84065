"""A/B of the megakernels and the fused step's kernel of two checkouts on
one card.

Builds this checkout (B) and another one (A, a directory holding an
unpacked commit, e.g. from ``git archive``) and times, in one process per
run, alternated A B B A, the kernel launches of K1 (``analytic_all``), K2
(faithful and baked t-culled), K2b (``analytic_unboxed``), K6
(``dist_grid``) and K4 (the four fused configurations of ``bench.py``) at
1920x1080, 8 bounces, on the 64-primitive benchmark scene, by CUDA events
around each launch (a warm-up call first).  It also tells, for each kernel
function of the two builds, whether its SASS (``cuobjdump -sass``) is the
same, so a change to shared device code can be seen to leave a kernel
alone.  Run on a machine with an NVIDIA GPU and the CUDA toolkit:

    python -m compute_path_tracer_tpu_torch.benchmarks.kernel_ab OTHER_DIR
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
W, H, BOUNCES, N_PRIMS, REPS = 1920, 1080, 8, 64, 5
MARCH = dict(geometry="baked", t_cull=True)
FRAMES = (("K1 analytic_all", dict(geometry="baked", analytic_all=True)),
          ("K2 faithful", dict(geometry="faithful")),
          ("K2", MARCH),
          ("K2b analytic_unboxed", dict(MARCH, analytic_unboxed=True)),
          ("K6 dist_grid", dict(MARCH, dist_grid=True)))
STEPS = (("K4 analytic_all + edge_grad", dict(analytic_all=True, edge_grad=True)),
         ("K4 march + edge_grad", dict(edge_grad=True)),
         ("K4 march + edge_grad + edge_secondary",
          dict(edge_grad=True, edge_secondary=True)),
         ("K4 analytic_unboxed", dict(analytic_unboxed=True)))
# The anonymous namespace's name in a mangled kernel name hashes the file.
ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_[0-9]+_\w+?_cu_[0-9a-f]+")


def _sass(root: str) -> dict:
    """Builds ``root``'s kernels; {kernel function: (instructions, hash of
    the SASS)}."""
    sys.path.insert(0, root)
    from compute_path_tracer_tpu_torch.kernels import build

    lib = build.build()
    dump = subprocess.run(
        [str(Path(build._nvcc()).parent / "cuobjdump"), "-sass", str(lib)],
        capture_output=True, text=True, check=True).stdout
    funcs, name = {}, None
    for line in dump.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            name = ANON.sub("", m.group(1))
            funcs[name] = []
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if m and name:
            funcs[name].append(m.group(1).strip())
    return {k: (len(v), hashlib.sha1("\n".join(v).encode()).hexdigest())
            for k, v in funcs.items()}


def _times(root: str) -> dict:
    """{kernel: sorted ms of REPS launches} with ``root``'s package."""
    sys.path.insert(0, root)
    import torch
    from compute_path_tracer_tpu_torch.kernels import megakernel as mk
    from compute_path_tracer_tpu_torch.kernels import train as tm
    from compute_path_tracer_tpu_torch.scene import (
        benchmark_scene, compile_scene, params_from_numpy)

    dev = torch.device("cuda")
    cs = compile_scene(benchmark_scene(N_PRIMS))
    params = params_from_numpy(cs.params, cs.spec, dev)

    def launches(mod, attr, fn):
        orig, events = getattr(mod, attr), []

        def timed(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig(*a, **kw)
            end.record()
            events.append((start, end))
            return out

        fn()
        torch.cuda.synchronize()
        setattr(mod, attr, timed)
        try:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        finally:
            setattr(mod, attr, orig)
        return sorted(a.elapsed_time(b) for a, b in events)

    out = {}
    for key, mode in FRAMES:
        launcher = ("launch_megakernel" if mode.get("analytic_all")
                    else "launch_march")
        out[key] = launches(mk, launcher, lambda: mk.render_frame_megakernel(
            cs.spec, params, width=W, height=H, bounces=BOUNCES, **mode))
    target = torch.zeros((H, W, 3), device=dev)
    for key, kw in STEPS:
        step = tm.make_fused_value_and_grad(cs.spec, target, width=W, height=H,
                                            bounces=BOUNCES, **kw)
        out[key] = launches(tm, "launch_train_fused", lambda: step(params))
    return out


def _child(mode: str, root: str) -> dict:
    res = subprocess.run([sys.executable, __file__, f"--{mode}", root],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"{mode} of {root} failed:\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", nargs="?", help="the A checkout's directory")
    ap.add_argument("--times", help=argparse.SUPPRESS)
    ap.add_argument("--sass", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.times or args.sass:
        print(json.dumps(_times(args.times) if args.times else _sass(args.sass)))
        return 0
    import torch

    if not torch.cuda.is_available() or not args.other:
        print("kernel_ab: needs an NVIDIA GPU and the A checkout's directory",
              file=sys.stderr)
        return 1
    roots = {"A": str(Path(args.other).resolve()), "B": str(ROOT)}
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"gpu: {gpu}; A {roots['A']}, B {roots['B']}", flush=True)
    with ThreadPoolExecutor(2) as pool:
        sass = dict(zip(roots, pool.map(lambda r: _child("sass", r), roots.values())))
    runs = {"A": [], "B": []}
    for label in "ABBA":
        runs[label].append(_child("times", roots[label]))
        print(f"run {label}: " + json.dumps(runs[label][-1]), flush=True)
    summary = {}
    for key in runs["A"][0]:
        a = statistics.median(t for r in runs["A"] for t in r[key])
        b = statistics.median(t for r in runs["B"] for t in r[key])
        summary[key] = {"A_ms": a, "B_ms": b, "B_over_A": b / a}
        print(f"{key}: A {a:.3f} ms, B {b:.3f} ms (medians of {2 * REPS}), "
              f"B/A {b / a:.4f} [{gpu}]")
    same = {}
    for name in sorted(set(sass["A"]) | set(sass["B"])):
        a, b = sass["A"].get(name), sass["B"].get(name)
        same[name] = ("only B" if a is None else "only A" if b is None
                      else "same" if a[1] == b[1]
                      else f"differs ({a[0]} -> {b[0]} instructions)")
        print(f"SASS {name}: {same[name]}")
    print(json.dumps({"gpu": gpu, "ms": summary, "sass": same}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
