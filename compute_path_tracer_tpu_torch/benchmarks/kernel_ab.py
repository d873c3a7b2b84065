"""A/B of the megakernels, the ray march and the fused step's kernel of two
checkouts on one card.

Builds this checkout (B) and another one (A, a directory holding an
unpacked commit, e.g. from ``git archive``) and times, in one process per
run, alternated A B B A, the kernel launches of K1 (``analytic_all``), K2
(faithful and baked t-culled), K2b (``analytic_unboxed``), K6
(``dist_grid``), K3 (``march_rays`` as the training path calls it: t-culled
with the normal, on the 1080p primary rays and on the rays that survive
their bounce of a plain ``path_trace``) and K4 (the four fused
configurations of ``bench.py``) at 1920x1080, 8 bounces, on the
64-primitive benchmark scene, by CUDA events around each launch (a warm-up
call first).  The frames and K3's t, ids and normals of every run are
hashed: A's and B's must be the same bit for bit (K4 sums with atomics and
is not compared).  It also tells, for each kernel function of the two
builds, whether its SASS (``cuobjdump -sass``) is the same, so a change to
shared device code can be seen to leave a kernel alone, and prints ptxas's
registers and stack frame of K2's and K3's kernels in both.  Run on a
machine with an NVIDIA GPU and the CUDA toolkit:

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
import tempfile
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
RAYS = ("K3 primary", "K3 survivors")
# Outputs that must be bit-equal between A and B.
SAME = ("K2 faithful", "K2", "K2b analytic_unboxed") + RAYS
# The anonymous namespace's name in a mangled kernel name hashes the file.
ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_[0-9]+_\w+?_cu_[0-9a-f]+")
# K2's and K3's kernels, for ptxas's figures.
WALKERS = re.compile(r"megakernel_walk|megakernel_marchILb[01]ELb[01]ELi0E|"
                     r"march_rays")


def _sass(root: str) -> dict:
    """Builds ``root``'s kernels, printing ptxas's report (a library built
    before prints the report kept beside it, where there is one); {kernel
    function: (instructions, hash of the SASS)}."""
    sys.path.insert(0, root)
    from compute_path_tracer_tpu_torch.kernels import build

    built = build.library_path().exists()
    lib = build.build(verbose=True)
    if built and (lib.parent / "ptxas.log").exists():
        print((lib.parent / "ptxas.log").read_text())
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


def _digest(*tensors) -> str:
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _rays(root: str, out: str) -> dict:
    """Writes to ``out`` K3's two ray sets: the 1080p primary rays of frame
    0 and the rays that survive their bounce of a plain ``path_trace``
    (``march_rays_plain``, t-culled with the normal, as the training path
    casts); {set: ray count}."""
    sys.path.insert(0, root)
    import torch
    from compute_path_tracer_tpu_torch.constants import MAT_SIZE
    from compute_path_tracer_tpu_torch.kernels.march import march_rays_plain
    from compute_path_tracer_tpu_torch.render.program import (
        build_program, program_table)
    from compute_path_tracer_tpu_torch.render.reference import (
        camera_rays, gather_material, path_trace)
    from compute_path_tracer_tpu_torch.scene import (
        benchmark_scene, compile_scene, params_from_numpy)

    dev = torch.device("cuda")
    cs = compile_scene(benchmark_scene(N_PRIMS))
    params = params_from_numpy(cs.params, cs.spec, dev)
    prog = build_program(cs.spec, "baked")
    with torch.no_grad():
        table = program_table(prog, params, True)
        mats = table[prog.f_mat:].view(prog.n_shapes, MAT_SIZE)
        ys, xs = torch.meshgrid(
            torch.arange(H, dtype=torch.int32, device=dev),
            torch.arange(W, dtype=torch.int32, device=dev), indexing="ij")
        rng, ro, rd = camera_rays(xs, ys, 0, 1.0, W / H, width=W, height=H)
        cast = []

        def march(o, d, _checks):
            cast.append([c.contiguous() for c in (*o, *d)])
            return march_rays_plain(prog, table, o, d, t_cull=True,
                                    with_normal=True)

        path_trace(lambda o, d: (), march, None,
                   lambda idx: gather_material(mats, idx), ro, rd, rng, 1)
    sets = dict(zip(RAYS, cast))
    torch.save({k: [c.cpu() for c in v] for k, v in sets.items()}, out)
    return {k: v[0].shape[0] for k, v in sets.items()}


def _times(root: str, rays: str) -> dict:
    """{"ms": {kernel: sorted ms of REPS launches}, "hash": {kernel: digest
    of its last output}} with ``root``'s package, K3 on ``rays``."""
    sys.path.insert(0, root)
    import torch
    from compute_path_tracer_tpu_torch.kernels import march as km
    from compute_path_tracer_tpu_torch.kernels import megakernel as mk
    from compute_path_tracer_tpu_torch.kernels import train as tm
    from compute_path_tracer_tpu_torch.render.program import (
        build_program, program_table)
    from compute_path_tracer_tpu_torch.scene import (
        benchmark_scene, compile_scene, params_from_numpy)
    from compute_path_tracer_tpu_torch.vecmath import Vec3

    dev = torch.device("cuda")
    cs = compile_scene(benchmark_scene(N_PRIMS))
    params = params_from_numpy(cs.params, cs.spec, dev)
    last = {}

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
                res = fn()
            torch.cuda.synchronize()
        finally:
            setattr(mod, attr, orig)
        return sorted(a.elapsed_time(b) for a, b in events), res

    out = {}
    for key, mode in FRAMES:
        launcher = ("launch_megakernel" if mode.get("analytic_all")
                    else "launch_march")
        out[key], frame = launches(
            mk, launcher, lambda: mk.render_frame_megakernel(
                cs.spec, params, width=W, height=H, bounces=BOUNCES, **mode))
        last[key] = _digest(frame)
    prog = build_program(cs.spec, "baked")
    with torch.no_grad():
        table = program_table(prog, params, True)
    for key, c in torch.load(rays).items():
        c = [t.to(dev) for t in c]
        out[key], (t, idx, n) = launches(km, "march_rays", lambda: km.march_rays(
            prog, table, Vec3(*c[:3]), Vec3(*c[3:]), t_cull=True,
            with_normal=True))
        last[key] = _digest(t, idx, *n)
    target = torch.zeros((H, W, 3), device=dev)
    for key, kw in STEPS:
        step = tm.make_fused_value_and_grad(cs.spec, target, width=W, height=H,
                                            bounces=BOUNCES, **kw)
        out[key] = launches(tm, "launch_train_fused", lambda: step(params))[0]
    return {"ms": out, "hash": last}


def _child(mode: str, root: str, *extra) -> tuple:
    """Runs this script's ``mode`` on ``root`` in a process of its own;
    (its JSON last line, the rest of its output)."""
    res = subprocess.run([sys.executable, __file__, f"--{mode}", root, *extra],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"{mode} of {root} failed:\n{res.stderr[-4000:]}")
    lines = res.stdout.strip().splitlines()
    return json.loads(lines[-1]), "\n".join(lines[:-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", nargs="?", help="the A checkout's directory")
    ap.add_argument("--times", help=argparse.SUPPRESS)
    ap.add_argument("--sass", help=argparse.SUPPRESS)
    ap.add_argument("--rays", help=argparse.SUPPRESS)
    ap.add_argument("--file", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.times:
        print(json.dumps(_times(args.times, args.file)))
        return 0
    if args.sass or args.rays:
        print(json.dumps(_sass(args.sass) if args.sass
                         else _rays(args.rays, args.file)))
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
    from compute_path_tracer_tpu_torch.kernels.build import parse_ptxas

    with ThreadPoolExecutor(2) as pool:
        built = dict(zip(roots, pool.map(lambda r: _child("sass", r),
                                         roots.values())))
    sass = {k: v[0] for k, v in built.items()}
    ptxas = {}
    for label, (_, log) in built.items():
        ptxas[label] = {ANON.sub("", k): v for k, v in parse_ptxas(log).items()
                        if WALKERS.search(k)}
        for k, v in sorted(ptxas[label].items()):
            print(f"ptxas {label} {k}: {v}")
    with tempfile.TemporaryDirectory() as tmp:
        rays = str(Path(tmp) / "rays.pt")
        counts = _child("rays", roots["B"], "--file", rays)[0]
        print(f"K3 rays: {counts}", flush=True)
        runs = {"A": [], "B": []}
        for label in "ABBA":
            runs[label].append(_child("times", roots[label], "--file", rays)[0])
            print(f"run {label}: " + json.dumps(runs[label][-1]), flush=True)
    summary = {}
    for key in runs["A"][0]["ms"]:
        a = statistics.median(t for r in runs["A"] for t in r["ms"][key])
        b = statistics.median(t for r in runs["B"] for t in r["ms"][key])
        summary[key] = {"A_ms": a, "B_ms": b, "B_over_A": b / a}
        print(f"{key}: A {a:.3f} ms, B {b:.3f} ms (medians of {2 * REPS}), "
              f"B/A {b / a:.4f} [{gpu}]")
    equal = {}
    for key in runs["A"][0]["hash"]:
        digests = {r["hash"][key] for label in "AB" for r in runs[label]}
        equal[key] = len(digests) == 1
        print(f"output {key}: {'A = B bit for bit' if equal[key] else 'DIFFERS'}")
    same = {}
    for name in sorted(set(sass["A"]) | set(sass["B"])):
        a, b = sass["A"].get(name), sass["B"].get(name)
        same[name] = ("only B" if a is None else "only A" if b is None
                      else "same" if a[1] == b[1]
                      else f"differs ({a[0]} -> {b[0]} instructions)")
        print(f"SASS {name}: {same[name]}")
    print(json.dumps({"gpu": gpu, "ms": summary, "bit_equal": equal,
                      "ptxas": ptxas, "sass": same}))
    return 0 if all(equal[k] for k in SAME) else 1


if __name__ == "__main__":
    sys.exit(main())
