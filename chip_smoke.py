#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port's main paths.

    python3 chip_smoke.py

Needs one NVIDIA GPU (sm_90a) with the CUDA toolkit; exits non-zero without
printing a result when there is none or when the port's package is missing.
It builds the CUDA kernels from the checkout and, for each kernel, holds it
against its plain torch version on the card (at 320x180 over scenes and
modes, and one frame at its main path's 1920x1080), then drives its main
path through RenderSession at 1920x1080 over the 64-primitive benchmark
scene with 8 bounces (the JAX package's bench.py rows):

* K1, megakernel_analytic: the full-analytic bounce
  (``geometry="baked", analytic_all=True``);
* K2, megakernel_march: the sphere march (``geometry="baked", t_cull=True``,
  bench.py's marching row); its checks cover faithful and baked geometry,
  subtraction, smooth union, refraction, the first-shape clobber and debug
  0-3.

It prints timings beside the card's name and power limit, a kernels JSON
line, and {"ok": true, "device": {...}} last; any failed check raises.
Imports nothing of JAX.
"""

import json
import subprocess
import sys
import tempfile
import time
from functools import partial

CHECK_W, CHECK_H = 320, 180      # kernel-vs-plain phase
MAIN_W, MAIN_H, BOUNCES = 1920, 1080, 8
N_PRIMS = 64
TIMED_FRAMES = 8
DIFF_TOL = 1e-2                  # a pixel differs when max-channel |diff| > this
SHARE_LIMIT = 5e-3               # ... and a check fails above this share
ANALYTIC = dict(geometry="baked", analytic_all=True)
MARCH = dict(geometry="baked", t_cull=True)


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _clobber_scene():
    """A guarded first shape beside a child union: while its AABB check
    passes it clobbers the child union's shapes (the reference's first-shape
    assign), which K1 evaluates as ancestor guards and K2 as a fold."""
    from compute_path_tracer_tpu_torch.scene import KIND_SPHERE, Scene, Shape, Union

    root = Union(name="R")
    child = Union(name="C")
    inner = child.add_shape(Shape(KIND_SPHERE, name="inner"))
    inner.transform.aabb = False
    inner.size.set(0.8)
    inner.material.brightness.set(2.0)
    root.add_union(child)
    first = root.add_shape(Shape(KIND_SPHERE, name="first"))
    first.transform.position.set(0.5, 0.0, 0.0)
    first.material.brightness.set(1.0)
    first.material.light_col.set(1.0, 0.5, 0.2)
    return Scene([root])


def _cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _compare(name, kernel_img, plain_img, limit=SHARE_LIMIT):
    """Share of pixels off by > DIFF_TOL and the max |diff|; raises on a
    breach or on non-finite values."""
    import torch

    if not (torch.isfinite(kernel_img).all() and torch.isfinite(plain_img).all()):
        raise AssertionError(f"{name}: non-finite values")
    d = (kernel_img - plain_img).abs().amax(dim=-1)
    share, err = float((d > DIFF_TOL).float().mean()), float(d.max())
    print(f"check {name}: share of pixels off by > {DIFF_TOL}: {share:.6f} "
          f"(limit {limit}), max abs diff {err:.3e}, "
          f"mean {float(kernel_img.mean()):.5f}")
    if share > limit:
        raise AssertionError(f"{name}: {share} of pixels differ (> {limit})")
    return share, err


def _check_cases(mk, key, cases):
    """Kernel against plain at CHECK_W x CHECK_H; each case must launch
    kernel ``key`` once.  Returns the max |diff| over the cases."""
    import torch

    max_err = 0.0
    for name, (spec, params), kw, acc, limit in cases:
        before = mk.LAUNCHES[key]
        k = mk.render_frame_megakernel(
            spec, params, None if acc is None else acc.clone(),
            width=CHECK_W, height=CHECK_H, **kw)
        p = mk.render_frame_megakernel_plain(
            spec, params, None if acc is None else acc.clone(),
            width=CHECK_W, height=CHECK_H, **kw)
        torch.cuda.synchronize()
        if mk.LAUNCHES[key] - before != 1:
            raise AssertionError(f"{name}: {key} was not launched once")
        max_err = max(max_err, _compare(name, k, p, limit)[1])
    return max_err


def _drive_session(mk, key, sess, label, gpu):
    """The main path: one warm-up frame and TIMED_FRAMES timed frames, with
    every kernel count set to 0 just before and read just after; each frame
    must launch kernel ``key`` once and no other kernel."""
    import torch

    from compute_path_tracer_tpu_torch.app.perf import rays_per_second

    for k in mk.LAUNCHES:
        mk.LAUNCHES[k] = 0
    sess.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_FRAMES):
        sess.step()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(mk.LAUNCHES)
    expect = {k: (TIMED_FRAMES + 1 if k == key else 0) for k in counts}
    if counts != expect:
        raise AssertionError(f"{label}: kernel launches {counts}, expected "
                             f"{expect}")
    accum = sess.accum
    if tuple(accum.shape) != (MAIN_H, MAIN_W, 3):
        raise AssertionError(f"{label}: accumulator shape {tuple(accum.shape)}")
    if not bool(torch.isfinite(accum).all()) or float(accum.mean()) <= 0.0:
        raise AssertionError(f"{label}: accumulator is not finite and positive")
    frame_ms = dt / TIMED_FRAMES * 1e3
    rays = rays_per_second(MAIN_W, MAIN_H, TIMED_FRAMES, dt, bounces=BOUNCES)
    print(f"main path {label}: {TIMED_FRAMES} frames {MAIN_W}x{MAIN_H}, "
          f"{N_PRIMS} prims, {BOUNCES} bounces: {frame_ms:.3f} ms/frame, "
          f"{rays:.4e} rays/s, mean {float(accum.mean()):.5f} [{gpu}]")
    return counts[key]


def _main_shape_check(mk, key, spec, params, mode):
    """The kernel against the plain version at the main path's own shape
    (frame 0, fresh accumulator); returns (share, max |diff|, plain ms)."""
    import torch

    kw = dict(width=MAIN_W, height=MAIN_H, bounces=BOUNCES, **mode)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = mk.render_frame_megakernel_plain(spec, params, None, 0, 0, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    before = mk.LAUNCHES[key]
    kernel = mk.render_frame_megakernel(spec, params, None, 0, 0, **kw)
    torch.cuda.synchronize()
    if mk.LAUNCHES[key] - before != 1:
        raise AssertionError(f"the {MAIN_W}x{MAIN_H} check did not launch {key}")
    share, err = _compare(f"{key} {MAIN_W}x{MAIN_H}, bounces {BOUNCES} frame 0",
                          kernel, plain)
    return share, err, plain_ms


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; run this on an NVIDIA GPU",
              file=sys.stderr)
        return 1

    from compute_path_tracer_tpu_torch.app.config import Settings
    from compute_path_tracer_tpu_torch.io.png import load_png_rgba
    from compute_path_tracer_tpu_torch.kernels import build
    from compute_path_tracer_tpu_torch.kernels import megakernel as mk
    from compute_path_tracer_tpu_torch.render.baked import bake
    from compute_path_tracer_tpu_torch.render.program import (
        build_program, program_table)
    from compute_path_tracer_tpu_torch.render.session import RenderSession
    from compute_path_tracer_tpu_torch.render.soa import (
        build_soa_smem_layout, pack_soa_smem)
    from compute_path_tracer_tpu_torch.scene import (
        benchmark_scene, blend_demo, compile_scene, csg_demo, glass_demo,
        params_from_numpy)

    gpu = _gpu_line()
    dev = torch.device("cuda")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    print(f"gpu: {gpu}")

    # -- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = build.build(verbose=True)
    mk.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib_path}")

    def compiled(scene):
        cs = compile_scene(scene)
        return cs.spec, params_from_numpy(cs.params, cs.spec, dev)

    bench = compiled(benchmark_scene(N_PRIMS))
    spec = bench[0]
    glass, clobber = compiled(glass_demo()), compiled(_clobber_scene())
    gen = torch.Generator(device="cpu").manual_seed(0)
    prior = torch.rand((CHECK_H, CHECK_W, 3), generator=gen).to(dev)

    # -- K1 against its plain version, on the card --------------------------
    b8 = dict(ANALYTIC, bounces=BOUNCES, frame=0)
    k1_err = _check_cases(mk, "megakernel_analytic", (
        ("K1 bounces 8 frame 0", bench, b8, None, 5e-3),
        ("K1 bounces 8 frame 3, running mean", bench,
         dict(b8, frame=3, last_clear=3), prior, 5e-3),
        ("K1 bounces 0", bench, dict(b8, bounces=0), None, 1e-3),
        ("K1 debug 3", bench, dict(b8, debug=3), None, 5e-3),
        # Paths the benchmark scene does not take: refraction and the
        # first-shape clobber's ancestor guards.
        ("K1 glass_demo, refraction", glass, b8, None, 5e-3),
        ("K1 clobber scene, ancestor guards", clobber, b8, None, 5e-3),
    ))

    # -- K2 against its plain version, on the card --------------------------
    csg, blend = compiled(csg_demo()), compiled(blend_demo())
    k2_cases = []
    for name, scene, mode in (
            ("csg_demo faithful", csg, dict(geometry="faithful")),
            ("csg_demo baked", csg, dict(geometry="baked")),
            ("blend_demo baked", blend, dict(geometry="baked")),
            ("glass_demo baked, refraction", glass, dict(geometry="baked")),
            ("clobber scene baked", clobber, dict(geometry="baked")),
            (f"benchmark_scene({N_PRIMS}) baked t_cull", bench, MARCH)):
        for debug in (0, 1, 2, 3):
            k2_cases.append((f"K2 {name} debug {debug}", scene,
                             dict(mode, bounces=BOUNCES, debug=debug), None,
                             SHARE_LIMIT))
    k2_cases.append(("K2 csg_demo faithful t_cull frame 3, running mean", csg,
                     dict(geometry="faithful", t_cull=True, bounces=BOUNCES,
                          frame=3, last_clear=3), prior, SHARE_LIMIT))
    k2_err = _check_cases(mk, "megakernel_march", k2_cases)

    # -- K1 main path: RenderSession at 1080p, full-analytic ---------------
    sess = RenderSession(benchmark_scene(N_PRIMS), MAIN_W, MAIN_H,
                         Settings(debug=0, bounces=BOUNCES),
                         frame_fn=partial(mk.render_frame_megakernel, **ANALYTIC),
                         device=dev)
    k1_launches = _drive_session(mk, "megakernel_analytic", sess, "K1 analytic",
                                 gpu)

    # Layer times at the main-path shape: bake + pack alone, the kernel
    # alone on packed tables, and the kernel against one plain frame.
    layout = build_soa_smem_layout(spec)
    sp = sess.params

    def bake_pack():
        return pack_soa_smem(layout, bake(spec, sp), sp)

    with torch.no_grad():
        bake_ms = _cuda_ms(bake_pack, 20)
        soa_f, soa_i = bake_pack()
    scratch = sess.accum.clone()
    k1_ms = _cuda_ms(lambda: mk.launch_megakernel(
        layout, soa_f, soa_i, scratch, frame=1, last_clear=1, bounces=BOUNCES,
        fov=sess.settings.fov, aspect=sess.aspect, debug=0), 5)
    k1_share, k1_main_err, k1_plain_ms = _main_shape_check(
        mk, "megakernel_analytic", spec, sp, ANALYTIC)
    k1_err = max(k1_err, k1_main_err)
    print(f"K1 layers at {MAIN_W}x{MAIN_H}: bake+pack {bake_ms:.3f} ms, kernel "
          f"{k1_ms:.3f} ms, plain torch frame {k1_plain_ms:.3f} ms [{gpu}]")

    # -- a value edit: same spec object, changed image ----------------------
    spec_before = sess.compiled.spec
    unedited = mk.render_frame_megakernel(
        spec_before, sess.params, None, sess.frame, 0, width=MAIN_W,
        height=MAIN_H, bounces=BOUNCES, aspect=sess.aspect, **ANALYTIC)
    ground = next(s for s in sess.scene.roots[0].children_shapes
                  if s.name == "Ground")
    ground.transform.position.y.set(ground.transform.position.y.val + 0.5)
    sess.mark_values_changed()
    edited = sess.step()
    torch.cuda.synchronize()
    if sess.compiled.spec is not spec_before:
        raise AssertionError("a value edit recompiled the spec")
    changed = float(((edited - unedited).abs().amax(dim=-1) > 0).float().mean())
    if changed <= 0.0:
        raise AssertionError("the value edit did not change the image")
    print(f"value edit: spec kept, {changed:.4f} of pixels changed")

    # -- PNG export round trip ----------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/frame.png"
        sess.save_image(path)
        rgba = load_png_rgba(path)
    if rgba.shape != (MAIN_H, MAIN_W, 4) or int(rgba[..., :3].max()) == 0:
        raise AssertionError(f"PNG read back as {rgba.shape}, "
                             f"max {int(rgba.max())}")
    print(f"png: {rgba.shape} read back")
    del sess, scratch, edited, unedited

    # -- K2 main path: RenderSession at 1080p, baked t-culled march --------
    sess = RenderSession(benchmark_scene(N_PRIMS), MAIN_W, MAIN_H,
                         Settings(debug=0, bounces=BOUNCES),
                         frame_fn=partial(mk.render_frame_megakernel, **MARCH),
                         device=dev)
    k2_launches = _drive_session(mk, "megakernel_march", sess,
                                 "K2 march (baked, t_cull)", gpu)
    sp = sess.params
    prog = build_program(spec, "baked")
    with torch.no_grad():
        table_ms = _cuda_ms(lambda: program_table(prog, sp, True), 20)
        table = program_table(prog, sp, True)
    scratch = sess.accum.clone()
    k2_ms = _cuda_ms(lambda: mk.launch_march(
        prog, table, scratch, frame=1, last_clear=1, bounces=BOUNCES,
        fov=sess.settings.fov, aspect=sess.aspect, debug=0, t_cull=True), 5)
    k2_share, k2_main_err, k2_plain_ms = _main_shape_check(
        mk, "megakernel_march", spec, sp, MARCH)
    k2_err = max(k2_err, k2_main_err)
    print(f"K2 layers at {MAIN_W}x{MAIN_H}: program table {table_ms:.3f} ms, "
          f"kernel {k2_ms:.3f} ms, plain torch frame {k2_plain_ms:.3f} ms "
          f"[{gpu}]")

    csrc = "compute_path_tracer_tpu_torch/kernels/csrc/"
    replaces = "compute_path_tracer_tpu/kernels/megakernel.py:1546"
    report = {"kernels": [
        {"name": "megakernel_analytic", "route": "cuda",
         "source": csrc + "megakernel_analytic.cu", "replaces": replaces,
         "launches": k1_launches, "max_abs_err": k1_err,
         "main_shape_share_off": k1_share, "ms": k1_ms,
         "plain_ms": k1_plain_ms},
        {"name": "megakernel_march", "route": "cuda",
         "source": csrc + "megakernel_march.cu", "replaces": replaces,
         "launches": k2_launches, "max_abs_err": k2_err,
         "main_shape_share_off": k2_share, "ms": k2_ms,
         "plain_ms": k2_plain_ms},
    ]}
    print(gpu)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
