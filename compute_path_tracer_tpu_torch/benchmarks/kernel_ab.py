"""A/B of the megakernels, the ray march and the fused step's kernel of two
checkouts on one card.

Builds this checkout (B) and another one (A, a directory holding an
unpacked commit, e.g. from ``git archive``) and times, in one process per
run, alternated A B B A, the kernel launches of K1 (``analytic_all``), K5
(``analytic_soa`` on the 256- and 512-primitive benchmark scenes), K2
(faithful and baked t-culled), K2b (``analytic_unboxed``, and ``omega``
1.6: RELAX), debug 4 (the STATS kernel), K6 (``dist_grid``), K3 (``march_rays`` as the
training path calls it: t-culled with the normal, on the 1080p primary rays
and on the rays that survive their bounce of a plain ``path_trace``) and K4
(the five fused configurations of ``bench.py``) at 1920x1080, 8 bounces, on
the 64-primitive benchmark scene unless stated, and four probes at their
drivers' shapes: the bf16 march (``P-bf16 f32``, ``map``, ``all``: 4 tiles
of (256, 128) rays, 64 reps of 64 steps), the dense march (``P-dense``)
and the ILP march (``P-ilp seq``, ``P-ilp fused``) on the 1080p primary
rays, and the wavefront's bounce (``P-wavefront``, ``P-wavefront
sorted``: one 1080p frame's 9 launches summed, the rays compacted, or
compacted and sorted), by CUDA events around each launch (a warm-up call
first); ``--only REGEX`` times only the rows whose name matches.  Every
output of every run is hashed, and A's and B's must be the same bit for
bit: the frames, K3's t, ids and normals, K4's image and its (shape,
channel) sums, which the kernel adds in a fixed order (the gradient's
atomics are torch's, outside the kernel), the probes' t (and the dense
probe's ids), and the wavefront's frame with its ray buffer and RNG after
the last bounce.  It also
prints K6's warp statistics (``launch_march(grid_stats=)``) in both, and
tells, for each kernel function of the two builds, whether its SASS
(``cuobjdump -sass``) is the same, so a change to shared device code can be
seen to leave a kernel alone (a kernel in one build only is matched to one
of the other's with the same SASS: a rename), and prints ptxas's
registers, stack frame and spills of K1's and the marching kernels
(K2's, RELAX's, debug 4's, K6's, K3's, K4's, the dense and ILP probes',
the wavefront's) and of the bf16 march in both.  Run on a
machine with an NVIDIA GPU and the CUDA toolkit:

    python -m compute_path_tracer_tpu_torch.benchmarks.kernel_ab OTHER_DIR [--only REGEX]
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
SOA = dict(geometry="baked", analytic_soa=True)
# (row, mode, primitives of the benchmark scene)
FRAMES = (("K1 analytic_all", dict(geometry="baked", analytic_all=True), N_PRIMS),
          ("K5 analytic_soa 256", SOA, 256),
          ("K5 analytic_soa 512", SOA, 512),
          ("K2 faithful", dict(geometry="faithful"), N_PRIMS),
          ("K2", MARCH, N_PRIMS),
          ("K2b analytic_unboxed", dict(MARCH, analytic_unboxed=True), N_PRIMS),
          ("K2b omega 1.6", dict(MARCH, omega=1.6), N_PRIMS),
          ("K2 debug 4", dict(MARCH, debug=4), N_PRIMS),
          ("K6 dist_grid", dict(MARCH, dist_grid=True), N_PRIMS))
STEPS = (("K4 analytic_all + edge_grad", dict(analytic_all=True, edge_grad=True)),
         ("K4 march + edge_grad", dict(edge_grad=True)),
         ("K4 march + edge_grad + edge_secondary",
          dict(edge_grad=True, edge_secondary=True)),
         ("K4 analytic_unboxed", dict(analytic_unboxed=True)),
         ("K4 march", {}))
RAYS = ("K3 primary", "K3 survivors")
BF16 = ("P-bf16 f32", "P-bf16 map", "P-bf16 all")
DENSE = "P-dense"
ILP = ("P-ilp seq", "P-ilp fused")
WAVE = ("P-wavefront", "P-wavefront sorted")
# The anonymous namespace's name in a mangled kernel name hashes the file;
# it ends in an 8-digit hash, then the kernel name's length.
ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_[0-9]+_\w+?_cu_[0-9a-f]{8}\d+")
# The marching kernels, for ptxas's figures.
WALKERS = re.compile(r"megakernel_analytic|megakernel_walk|megakernel_grid|"
                     r"megakernel_relax|megakernel_stats|march_rays|train_fused|"
                     r"march_dense|march_ilp|wavefront_bounce|bf16_march")


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


def _times(root: str, rays: str, only: str) -> dict:
    """{"ms": {kernel: sorted ms of REPS launches}, "hash": {kernel: digest
    of its last output}} with ``root``'s package, K3 on ``rays``, for the
    rows whose name matches ``only``."""
    sys.path.insert(0, root)
    import torch
    from compute_path_tracer_tpu_torch.kernels import march as km
    from compute_path_tracer_tpu_torch.kernels import megakernel as mk
    from compute_path_tracer_tpu_torch.kernels import train as tm
    from compute_path_tracer_tpu_torch.render.baked import bake
    from compute_path_tracer_tpu_torch.render.distgrid import make_dist_grid
    from compute_path_tracer_tpu_torch.render.program import (
        build_program, program_table)
    from compute_path_tracer_tpu_torch.scene import (
        benchmark_scene, compile_scene, params_from_numpy)
    from compute_path_tracer_tpu_torch.vecmath import Vec3

    dev = torch.device("cuda")
    scenes = {}
    for n in {n for _, _, n in FRAMES}:
        c = compile_scene(benchmark_scene(n))
        scenes[n] = (c.spec, params_from_numpy(c.params, c.spec, dev))
    spec, params = scenes[N_PRIMS]
    pick = re.compile(only)
    last = {}

    def launches(mod, attr, fn, group=1, last_args=None):
        """(sorted ms of the REPS timed calls of ``fn``, each the sum of
        its ``group`` launches of ``mod.attr``, fn's last result, the last
        launch's own result); ``last_args``, a list, takes the last
        launch's arguments."""
        orig, events, outs = getattr(mod, attr), [], [None]

        def timed(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig(*a, **kw)
            end.record()
            events.append((start, end))
            outs[0] = out
            if last_args is not None:
                last_args[:] = a
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
        ms = [a.elapsed_time(b) for a, b in events]
        return (sorted(sum(ms[i:i + group]) for i in range(0, len(ms), group)),
                res, outs[0])

    out = {}
    for key, mode, n in FRAMES:
        if not pick.search(key):
            continue
        launcher = ("launch_megakernel" if mode.get("analytic_all")
                    or mode.get("analytic_soa") else "launch_march")
        out[key], frame, _ = launches(
            mk, launcher, lambda: mk.render_frame_megakernel(
                *scenes[n], width=W, height=H, bounces=BOUNCES, **mode))
        last[key] = _digest(frame)
    prog = build_program(spec, "baked")
    with torch.no_grad():
        table = program_table(prog, params, True)
        grid = make_dist_grid(spec, bake(spec, params))
    grid_stats = torch.zeros(5, dtype=torch.int64, device=dev)
    mk.launch_march(prog, table, torch.zeros((H, W, 3), device=dev), frame=0,
                    last_clear=0, bounces=BOUNCES, fov=1.0, aspect=W / H,
                    debug=0, t_cull=True, grid=grid, grid_stats=grid_stats)
    for key, c in (torch.load(rays).items()
                   if any(pick.search(k) for k in RAYS) else ()):
        if not pick.search(key):
            continue
        c = [t.to(dev) for t in c]
        out[key], (t, idx, n), _ = launches(
            km, "march_rays", lambda: km.march_rays(
                prog, table, Vec3(*c[:3]), Vec3(*c[3:]), t_cull=True,
                with_normal=True))
        last[key] = _digest(t, idx, *n)
    target = torch.zeros((H, W, 3), device=dev)
    for key, kw in STEPS:
        if not pick.search(key):
            continue
        step = tm.make_fused_value_and_grad(spec, target, width=W, height=H,
                                            bounces=BOUNCES, **kw)
        out[key], _, fused = launches(tm, "launch_train_fused",
                                      lambda: step(params))
        last[key] = _digest(*(v for v in fused if v is not None))
    if any(pick.search(k) for k in BF16):
        from compute_path_tracer_tpu_torch.benchmarks import bf16_probe
        from compute_path_tracer_tpu_torch.kernels import hw_probes as hp

        ro, rd, sph = bf16_probe.inputs(bf16_probe.TILES)
        for key, v in zip(BF16, hp.BF16_VARIANTS):
            if pick.search(key):
                out[key], t, _ = launches(
                    hp, "bf16_march", lambda v=v: hp.bf16_march(ro, rd, sph, v))
                last[key] = _digest(t)
    if pick.search(DENSE):
        from compute_path_tracer_tpu_torch.benchmarks.common import probe_rays
        from compute_path_tracer_tpu_torch.kernels import probes as pr

        ro, rd = probe_rays(W, H, dev)
        out[DENSE], (t, idx), _ = launches(
            pr, "march_dense", lambda: pr.march_dense(prog, table, ro, rd))
        last[DENSE] = _digest(t, idx)
    if any(pick.search(k) for k in ILP):
        from compute_path_tracer_tpu_torch.benchmarks.common import probe_rays
        from compute_path_tracer_tpu_torch.kernels import probes as pr

        ro, rd = probe_rays(W, H, dev)
        for key, inter in zip(ILP, (False, True)):
            if pick.search(key):
                out[key], t, _ = launches(
                    pr, "march_ilp", lambda i=inter: pr.march_ilp(
                        prog, table, ro, rd, interleave=i))
                last[key] = _digest(t)
    if any(pick.search(k) for k in WAVE):
        from compute_path_tracer_tpu_torch.benchmarks import frozen_wavefront as fw
        from compute_path_tracer_tpu_torch.kernels import wavefront as wf

        for key, sort in zip(WAVE, (False, True)):
            if pick.search(key):
                args = []
                out[key], img, _ = launches(
                    wf, "wavefront_bounce", lambda s=sort: fw.render_frame_wavefront(
                        spec, params, frame=1, last_clear=1, width=W, height=H,
                        bounces=BOUNCES, sort_rays=s), BOUNCES + 1, args)
                last[key] = _digest(img, args[3], args[4])
    return {"ms": out, "hash": last, "grid_stats": grid_stats.tolist()}


def sass_same(sass: dict) -> dict:
    """{kernel function: whether its SASS is the same in builds "A" and
    "B"} from each build's ``_sass``, printed.  A kernel in one build only
    is matched to one of the other's, by that build alone, with the same
    SASS: a rename."""
    same = {}
    for name in sorted(set(sass["A"]) | set(sass["B"])):
        a, b = sass["A"].get(name), sass["B"].get(name)
        if a is None or b is None:
            mine, other = ("B", "A") if a is None else ("A", "B")
            twin = [k for k, v in sass[other].items()
                    if k not in sass[mine] and v[1] == (a or b)[1]]
            same[name] = f"only {mine}" + (
                f", the same SASS as {other}'s {twin[0]}" if twin else "")
        else:
            same[name] = ("same" if a[1] == b[1]
                          else f"differs ({a[0]} -> {b[0]} instructions)")
        print(f"SASS {name}: {same[name]}")
    return same


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
    ap.add_argument("--only", default="",
                    help="time only the rows whose name matches this regex")
    ap.add_argument("--times", help=argparse.SUPPRESS)
    ap.add_argument("--sass", help=argparse.SUPPRESS)
    ap.add_argument("--rays", help=argparse.SUPPRESS)
    ap.add_argument("--file", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.times:
        print(json.dumps(_times(args.times, args.file, args.only)))
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
        if any(re.search(args.only, k) for k in RAYS):
            counts = _child("rays", roots["B"], "--file", rays)[0]
            print(f"K3 rays: {counts}", flush=True)
        runs = {"A": [], "B": []}
        for label in "ABBA":
            runs[label].append(_child("times", roots[label], "--file", rays,
                                      "--only", args.only)[0])
            print(f"run {label}: " + json.dumps(runs[label][-1]), flush=True)
    summary = {}
    for key in runs["A"][0]["ms"]:
        a = statistics.median(t for r in runs["A"] for t in r["ms"][key])
        b = statistics.median(t for r in runs["B"] for t in r["ms"][key])
        summary[key] = {"A_ms": a, "B_ms": b, "B_over_A": b / a}
        print(f"{key}: A {a:.3f} ms, B {b:.3f} ms (medians of {2 * REPS}), "
              f"B/A {b / a:.4f} [{gpu}]")
    for label in "AB":
        print(f"K6 warp statistics {label} (iterations, with an exact tap, "
              f"mixed, lane exact taps, lane cheap taps): "
              f"{runs[label][0]['grid_stats']}")
    equal = {}
    for key in runs["A"][0]["hash"]:
        digests = {r["hash"][key] for label in "AB" for r in runs[label]}
        equal[key] = len(digests) == 1
        print(f"output {key}: {'A = B bit for bit' if equal[key] else 'DIFFERS'}")
    same = sass_same(sass)
    print(json.dumps({"gpu": gpu, "ms": summary, "bit_equal": equal,
                      "grid_stats": {k: runs[k][0]["grid_stats"] for k in "AB"},
                      "ptxas": ptxas, "sass": same}))
    return 0 if all(equal.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
