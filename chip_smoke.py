#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port's main path.

    python3 chip_smoke.py

Needs one NVIDIA GPU (sm_90a) with the CUDA toolkit; exits non-zero without
printing a result when there is none or when the port's package is missing.
It builds the CUDA kernel from the checkout, holds it against its plain
torch version on the card (six cases at 320x180, and one frame at the main
path's 1920x1080), drives RenderSession at 1920x1080 over the 64-primitive
benchmark scene with 8 bounces (the JAX package's headline render,
bench.py), and prints timings beside the card's name and power limit.  The last line is {"ok": true, "device": {...}} on success; any
failed check raises.  Imports nothing of JAX.
"""

import json
import subprocess
import sys
import tempfile
import time

CHECK_W, CHECK_H = 320, 180      # kernel-vs-plain phase
MAIN_W, MAIN_H, BOUNCES = 1920, 1080, 8
N_PRIMS = 64
TIMED_FRAMES = 8
DIFF_TOL = 1e-2                  # a pixel differs when max-channel |diff| > this


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _clobber_scene():
    """A guarded first shape beside a child union: while its AABB check
    passes it clobbers the child union's shapes (the reference's first-shape
    assign), which the kernel evaluates as ancestor guards."""
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; run this on an NVIDIA GPU",
              file=sys.stderr)
        return 1

    from compute_path_tracer_tpu_torch.app.config import Settings
    from compute_path_tracer_tpu_torch.app.perf import rays_per_second
    from compute_path_tracer_tpu_torch.io.png import load_png_rgba
    from compute_path_tracer_tpu_torch.kernels import build
    from compute_path_tracer_tpu_torch.kernels import megakernel as mk
    from compute_path_tracer_tpu_torch.render.baked import bake
    from compute_path_tracer_tpu_torch.render.session import RenderSession
    from compute_path_tracer_tpu_torch.render.soa import (
        build_soa_smem_layout, pack_soa_smem)
    from compute_path_tracer_tpu_torch.scene import (
        benchmark_scene, compile_scene, glass_demo, params_from_numpy)

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

    # -- kernel against its plain version, on the card ----------------------
    def compiled(scene):
        cs = compile_scene(scene)
        return cs.spec, params_from_numpy(cs.params, cs.spec, dev)

    bench = compiled(benchmark_scene(N_PRIMS))
    spec = bench[0]
    gen = torch.Generator(device="cpu").manual_seed(0)
    prior = torch.rand((CHECK_H, CHECK_W, 3), generator=gen).to(dev)
    b8 = dict(bounces=BOUNCES, frame=0)
    cases = (
        ("bounces 8 frame 0", bench, b8, None, 5e-3),
        ("bounces 8 frame 3, running mean", bench,
         dict(bounces=BOUNCES, frame=3, last_clear=3), prior, 5e-3),
        ("bounces 0", bench, dict(bounces=0, frame=0), None, 1e-3),
        ("debug 3", bench, dict(b8, debug=3), None, 5e-3),
        # Paths the benchmark scene does not take: refraction and the
        # first-shape clobber's ancestor guards.
        ("glass_demo, refraction", compiled(glass_demo()), b8, None, 5e-3),
        ("clobber scene, ancestor guards", compiled(_clobber_scene()), b8,
         None, 5e-3),
    )
    launches0 = mk.LAUNCHES
    max_abs_err = 0.0
    for name, (c_spec, c_params), kw, acc, limit in cases:
        k = mk.render_frame_megakernel(
            c_spec, c_params, None if acc is None else acc.clone(),
            width=CHECK_W, height=CHECK_H, **kw)
        p = mk.render_frame_megakernel_plain(
            c_spec, c_params, None if acc is None else acc.clone(),
            width=CHECK_W, height=CHECK_H, **kw)
        torch.cuda.synchronize()
        if not (torch.isfinite(k).all() and torch.isfinite(p).all()):
            raise AssertionError(f"{name}: non-finite values")
        d = (k - p).abs().amax(dim=-1)
        frac = float((d > DIFF_TOL).float().mean())
        err = float(d.max())
        max_abs_err = max(max_abs_err, err)
        print(f"check {name}: share of pixels off by > {DIFF_TOL}: {frac:.6f} "
              f"(limit {limit}), max abs diff {err:.3e}, mean {float(k.mean()):.5f}")
        if frac > limit:
            raise AssertionError(f"{name}: {frac} of pixels differ (> {limit})")
    if mk.LAUNCHES - launches0 != len(cases):
        raise AssertionError(f"{mk.LAUNCHES - launches0} launches for "
                             f"{len(cases)} kernel calls")

    # -- main path: RenderSession at 1080p, 64 prims, 8 bounces -------------
    sess = RenderSession(benchmark_scene(N_PRIMS), MAIN_W, MAIN_H,
                         Settings(debug=0, bounces=BOUNCES), device=dev)
    mk.LAUNCHES = 0
    sess.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_FRAMES):
        sess.step()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = mk.LAUNCHES
    if launches != TIMED_FRAMES + 1:
        raise AssertionError(f"main path made {launches} kernel launches, "
                             f"expected {TIMED_FRAMES + 1}")
    accum = sess.accum
    if tuple(accum.shape) != (MAIN_H, MAIN_W, 3):
        raise AssertionError(f"accumulator shape {tuple(accum.shape)}")
    if not bool(torch.isfinite(accum).all()) or float(accum.mean()) <= 0.0:
        raise AssertionError("main-path accumulator is not finite and positive")
    frame_ms = dt / TIMED_FRAMES * 1e3
    rays = rays_per_second(MAIN_W, MAIN_H, TIMED_FRAMES, dt, bounces=BOUNCES)
    print(f"main path: {TIMED_FRAMES} frames {MAIN_W}x{MAIN_H}, {N_PRIMS} prims, "
          f"{BOUNCES} bounces: {frame_ms:.3f} ms/frame, {rays:.4e} rays/s, "
          f"mean {float(accum.mean()):.5f} [{gpu}]")

    # Layer times at the main-path shape: bake + pack alone, the kernel
    # alone on packed tables, and one frame of the plain version.
    layout = build_soa_smem_layout(spec)
    sp = sess.params

    def bake_pack():
        return pack_soa_smem(layout, bake(spec, sp), sp)

    with torch.no_grad():
        bake_ms = _cuda_ms(bake_pack, 20)
        soa_f, soa_i = bake_pack()
    scratch = accum.clone()
    kernel_ms = _cuda_ms(lambda: mk.launch_megakernel(
        layout, soa_f, soa_i, scratch, frame=1, last_clear=1, bounces=BOUNCES,
        fov=sess.settings.fov, aspect=sess.aspect, debug=0), 5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = mk.render_frame_megakernel_plain(
        spec, sp, None, 0, 0, width=MAIN_W, height=MAIN_H, bounces=BOUNCES)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3

    # The kernel against the plain version at the main path's own shape:
    # its RNG seeds and the ragged edge of the 16x16 block grid.
    before = mk.LAUNCHES
    kernel_frame = mk.render_frame_megakernel(
        spec, sp, None, 0, 0, width=MAIN_W, height=MAIN_H, bounces=BOUNCES)
    torch.cuda.synchronize()
    if mk.LAUNCHES - before != 1:
        raise AssertionError("the 1080p check frame did not launch the kernel")
    if not (torch.isfinite(kernel_frame).all() and torch.isfinite(plain).all()):
        raise AssertionError("1080p check frame: non-finite values")
    d = (kernel_frame - plain).abs().amax(dim=-1)
    main_share = float((d > DIFF_TOL).float().mean())
    main_err = float(d.max())
    max_abs_err = max(max_abs_err, main_err)
    del plain, kernel_frame, d
    print(f"check {MAIN_W}x{MAIN_H}, bounces {BOUNCES} frame 0: share of "
          f"pixels off by > {DIFF_TOL}: {main_share:.6f} (limit 5e-3), "
          f"max abs diff {main_err:.3e}")
    if main_share > 5e-3:
        raise AssertionError(f"1080p: {main_share} of pixels differ (> 5e-3)")
    print(f"layers at {MAIN_W}x{MAIN_H}: bake+pack {bake_ms:.3f} ms, kernel "
          f"{kernel_ms:.3f} ms, plain torch frame {plain_ms:.3f} ms [{gpu}]")

    # -- a value edit: same spec object, changed image ----------------------
    spec_before = sess.compiled.spec
    frame_no = sess.frame
    unedited = mk.render_frame_megakernel(
        spec_before, sess.params, None, frame_no, 0, width=MAIN_W,
        height=MAIN_H, bounces=BOUNCES, aspect=sess.aspect)
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

    report = {"kernels": [{
        "name": "megakernel_analytic",
        "route": "cuda",
        "source": "compute_path_tracer_tpu_torch/kernels/csrc/"
                  "megakernel_analytic.cu",
        "replaces": "compute_path_tracer_tpu/kernels/megakernel.py:1546",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "main_shape_share_off": main_share,
        "main_shape_max_abs_err": main_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}
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
