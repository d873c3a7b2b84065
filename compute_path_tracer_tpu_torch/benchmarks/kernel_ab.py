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
rays, the wavefront's bounce (``P-wavefront``, ``P-wavefront
sorted``: one 1080p frame's 9 launches summed, the rays compacted, or
compacted and sorted), the box transforms (``P-mxu scalar``, ``P-mxu
tensor``: 16 tiles of (64, 128) rays, 32 shapes, 64 reps), the fused
forward-plus-adjoint bounce (``P-fused-bwd frame``, ``P-fused-bwd tile``:
the 1080p frame and the probe's (64, 128) tile), the capped march
(``P-capped``, the 1080p primary rays) and the gather probe's kernels
from shared memory (``P-gather correct128``, ``gather128``,
``gather512``, ``arith``: 16 tiles of (64, 128) lanes, 512 iterations) and
the segment sum (``P-segsum probe``: 1 x 28 x 16,384 lanes, S = 64;
``P-segsum K4``: 9 x 13 x 2,073,600, S = 64, ids uniform in [-1, S);
``P-segsum K4 clustered``: the same with an id a run of 64 lanes), by
CUDA events around each launch (a warm-up call first; the launches of the
last five probes queued behind a sleep, so that the host's time to issue
them is not counted); ``--only REGEX`` times only the rows whose name
matches.  Every output of every run is hashed, and A's and B's must be the
same bit for bit: the frames, K3's t, ids and normals, K4's image and its
(shape, channel) sums, which the kernel adds in a fixed order (the
gradient's atomics are torch's, outside the kernel), the probes' t (and
the dense probe's ids), the wavefront's frame with its ray buffer and RNG
after the last bounce, the scalar transforms' sums, fused-bwd's zero
gradient and the gather kernels' outputs.  The tensor-core sums and
fused-bwd's loss (a float64 sum added by atomics in no fixed order) are
not hashed: in each run they are held to their own build's plain version
(``hw_probes.mxu_tensor_diff``; the loss within ``FB_LOSS_TOL``
relative), and so is the segment sum (within ``SEGSUM_TOL`` of max |ref|
of a float64 ``index_add_``), which a build with atomics adds in no fixed
order; a run that fails its check fails the script.  It also
prints K6's warp statistics (``launch_march(grid_stats=)``) in both, and
tells, for each kernel function of the two builds, whether its SASS
(``cuobjdump -sass``) is the same, so a change to shared device code can be
seen to leave a kernel alone (a kernel in one build only is matched to one
of the other's with the same SASS: a rename), and prints ptxas's
registers, stack frame and spills of K1's and the marching kernels
(K2's, RELAX's, debug 4's, K6's, K3's, K4's, the dense, capped and ILP
probes', the wavefront's), of the bf16 march, the box transforms,
fused-bwd, the gather kernels and the segment sum in both, with the
segment sum's tensor-core, atomic and copy instructions counted in its
SASS.  Run on a
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
MXU = ("P-mxu scalar", "P-mxu tensor")
FUSED_BWD = ("P-fused-bwd frame", "P-fused-bwd tile")
CAPPED = "P-capped"
GATHER = ("P-gather correct128", "P-gather gather128", "P-gather gather512",
          "P-gather arith")
SEGSUM = ("P-segsum probe", "P-segsum K4", "P-segsum K4 clustered")
# fused-bwd's loss against its plain version (chip_smoke.py's FB_LOSS_TOL),
# the segment sum against a float64 sum (its SEGSUM_TOL, of max |ref|).
FB_LOSS_TOL = 1e-5
SEGSUM_TOL = 1e-5
# The sleep queued before each launch of those rows: about 2 ms.
QUEUE_CYCLES = 4_000_000
# The anonymous namespace's name in a mangled kernel name hashes the file;
# it ends in an 8-digit hash, then the kernel name's length.
ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_[0-9]+_\w+?_cu_[0-9a-f]{8}\d+")
# The marching kernels, for ptxas's figures.
WALKERS = re.compile(r"megakernel_analytic|megakernel_walk|megakernel_grid|"
                     r"megakernel_relax|megakernel_stats|march_rays|train_fused|"
                     r"march_dense|march_capped|march_ilp|wavefront_bounce|"
                     r"bf16_march|mxu_scalar|mxu_tensor|fused_bwd|gather_once|"
                     r"gather_chain|gather_arith|segsum")
# The segment sum's instructions counted in its SASS, by whole opcode: its
# tensor-core products, atomics, copies and barriers.
SEGSUM_OPS = re.compile(r"HMMA|ATOM|RED|LDGSTS|BAR")


def _sass(root: str) -> dict:
    """Builds ``root``'s kernels, printing ptxas's report (a library built
    before prints the report kept beside it, where there is one); {"funcs":
    {kernel function: (instructions, hash of the SASS)}, "segsum": {segment
    sum kernel: {opcode matching SEGSUM_OPS: count}}}."""
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
    ops = {k: [re.sub(r"^@!?U?P\w+\s+", "", i).split()[0] for i in v]
           for k, v in funcs.items() if "segsum" in k}
    return {"funcs": {k: (len(v), hashlib.sha1("\n".join(v).encode()).hexdigest())
                      for k, v in funcs.items()},
            "segsum": {k: {o: v.count(o) for o in sorted(set(v))
                           if SEGSUM_OPS.match(o)} for k, v in ops.items()}}


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
    of its last output}, "checks": {kernel: its check against its plain
    version}} with ``root``'s package, K3 on ``rays``, for the rows whose
    name matches ``only``."""
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

    def launches(mod, attr, fn, group=1, last_args=None, queued=False):
        """(sorted ms of the REPS timed calls of ``fn``, each the sum of
        its ``group`` launches of ``mod.attr``, fn's last result, the last
        launch's own result); ``last_args``, a list, takes the last
        launch's arguments; ``queued`` queues a sleep before each call."""
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
                if queued:
                    torch.cuda._sleep(QUEUE_CYCLES)
                res = fn()
            torch.cuda.synchronize()
        finally:
            setattr(mod, attr, orig)
        ms = [a.elapsed_time(b) for a, b in events]
        return (sorted(sum(ms[i:i + group]) for i in range(0, len(ms), group)),
                res, outs[0])

    out, checks = {}, {}
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
    if any(pick.search(k) for k in MXU):
        from compute_path_tracer_tpu_torch.benchmarks import mxu_transform_probe as mxp
        from compute_path_tracer_tpu_torch.kernels import hw_probes as hp

        ro, rd, m, mat, off = mxp.inputs(mxp.TILES)
        if pick.search(MXU[0]):
            out[MXU[0]], t, _ = launches(
                hp, "mxu_scalar", lambda: hp.mxu_scalar(ro, rd, m), queued=True)
            last[MXU[0]] = _digest(t)
        if pick.search(MXU[1]):
            out[MXU[1]], t, _ = launches(
                hp, "mxu_tensor", lambda: hp.mxu_tensor(ro, rd, mat, off),
                queued=True)
            err, share, flips = hp.mxu_tensor_diff(
                t, hp.mxu_tensor_plain(ro, rd, mat, off), hp.MXU_REPS)
            checks[MXU[1]] = {"max_abs_diff": err, "share_off": share,
                              "flips": flips,
                              "ok": share <= hp.MXU_SHARE_OFF}
    if any(pick.search(k) for k in FUSED_BWD):
        from compute_path_tracer_tpu_torch.kernels import grad_probes as gp

        with torch.no_grad():
            bv = bake(spec, params)
        fprog, ftable = gp.fused_bwd_tables(spec, params, bv)
        for key, rect in zip(FUSED_BWD, (gp.FRAME_RECT, gp.TILE_RECT)):
            if not pick.search(key):
                continue
            out[key], (loss, grad), _ = launches(
                gp, "launch_fused_bwd", lambda r=rect: gp.launch_fused_bwd(
                    fprog, ftable, r, bv.shape[0]), queued=True)
            plain = float(gp.fused_bwd_plain(spec, params, bv, rect)[0][0])
            rel = abs(float(loss[0]) - plain) / abs(plain)
            zero = bool(torch.isfinite(grad).all()) and not bool(grad.any())
            checks[key] = {"loss": float(loss[0]), "plain_loss": plain,
                           "rel": rel, "zero_grad": zero,
                           "ok": rel <= FB_LOSS_TOL and zero}
            last[key] = _digest(grad)
    if pick.search(CAPPED):
        from compute_path_tracer_tpu_torch.benchmarks.common import probe_rays
        from compute_path_tracer_tpu_torch.kernels import probes as pr

        ro, rd = probe_rays(W, H, dev)
        cprog = pr.capped_program(spec)
        with torch.no_grad():
            ctable = program_table(cprog, params, True)
        out[CAPPED], t, _ = launches(
            pr, "march_capped", lambda: pr.march_capped(cprog, ctable, ro, rd),
            queued=True)
        last[CAPPED] = _digest(t)
    if any(pick.search(k) for k in GATHER):
        from compute_path_tracer_tpu_torch.benchmarks import gather_probe as gpr
        from compute_path_tracer_tpu_torch.kernels import hw_probes as hp

        inp = gpr.inputs(gpr.TILES)
        calls = {GATHER[0]: ("gather_once", lambda: hp.gather_once(
                     inp["correct_tab"], inp["correct_idx"])),
                 GATHER[1]: ("gather_chain", lambda: hp.gather_chain(
                     inp["tab"], inp["idx"])),
                 GATHER[2]: ("gather_chain", lambda: hp.gather_chain(
                     inp["tab512"], inp["idx512"])),
                 GATHER[3]: ("gather_arith", lambda: hp.gather_arith(
                     inp["idx"]))}
        for key, (attr, fn) in calls.items():
            if pick.search(key):
                out[key], res, _ = launches(hp, attr, fn, queued=True)
                last[key] = _digest(res)
    if any(pick.search(k) for k in SEGSUM):
        from compute_path_tracer_tpu_torch.kernels import grad_probes as gp

        for key, (idx, cot, n_seg) in _segsum_inputs(pick, dev):
            out[key], got, _ = launches(
                gp, "segsum", lambda: gp.segsum(idx, cot, n_seg), queued=True)
            ref = gp.segsum_plain(idx, cot.double(), n_seg)
            rel = float((got.double() - ref).abs().max() / ref.abs().max())
            checks[key] = {"rel": rel, "ok": rel <= SEGSUM_TOL
                           and bool(torch.isfinite(got).all())}
            del got, ref
    return {"ms": out, "hash": last, "checks": checks,
            "grid_stats": grid_stats.tolist()}


def _segsum_inputs(pick, dev):
    """The segment sum rows picked: (row, (idx, cot, S)), made here from a
    seed so that both checkouts time the same inputs: ids uniform in [-1,
    S) (clustered: one a run of 64 lanes), cotangents standard normal."""
    import torch

    g = torch.Generator(device=dev).manual_seed(0)
    probe = (torch.randint(-1, 64, (1, 64 * 256), generator=g, device=dev,
                           dtype=torch.int32),
             torch.randn((1, 28, 64 * 256), generator=g, device=dev), 64)
    if pick.search(SEGSUM[0]):
        yield SEGSUM[0], probe
    if not any(pick.search(k) for k in SEGSUM[1:]):
        return
    n = W * H
    idx = torch.randint(-1, 64, (9, n), generator=g, device=dev,
                        dtype=torch.int32)
    cot = torch.randn((9, 13, n), generator=g, device=dev)
    if pick.search(SEGSUM[1]):
        yield SEGSUM[1], (idx, cot, 64)
    runs = torch.randint(-1, 64, (9, n // 64), generator=g, device=dev,
                         dtype=torch.int32)
    if pick.search(SEGSUM[2]):
        yield SEGSUM[2], (runs.repeat_interleave(64, dim=1).contiguous(), cot,
                          64)


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
    sass = {k: v[0]["funcs"] for k, v in built.items()}
    for label, (res, _) in built.items():
        for k, v in sorted(res["segsum"].items()):
            print(f"SASS {label} {ANON.sub('', k)}: {v}")
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
    passed = True
    for label in "AB":
        for i, r in enumerate(runs[label]):
            for key, c in r["checks"].items():
                passed &= c["ok"]
                print(f"check {key} {label}{i}: "
                      f"{'passed' if c['ok'] else 'FAILED'} {json.dumps(c)}")
    same = sass_same(sass)
    print(json.dumps({"gpu": gpu, "ms": summary, "bit_equal": equal,
                      "checks_passed": passed,
                      "segsum_sass": {k: v[0]["segsum"] for k, v in built.items()},
                      "grid_stats": {k: runs[k][0]["grid_stats"] for k in "AB"},
                      "ptxas": ptxas, "sass": same}))
    return 0 if all(equal.values()) and passed else 1


if __name__ == "__main__":
    sys.exit(main())
