"""What the measurements share: the card check, the benchmark scene, the
probes' primary rays and CUDA-event timing."""

from __future__ import annotations

import sys

import torch

from ..app.profiling import gpu_line
from ..ops.camera import calc_uv, primary_ray
from ..scene import benchmark_scene, compile_scene, params_from_numpy
from ..vecmath import Vec3


def require_card(name: str) -> str:
    """Exits with status 1 when there is no CUDA device; otherwise prints
    and returns the card's name and power limit (nvidia-smi)."""
    if not torch.cuda.is_available():
        print(f"{name}: no CUDA device; run this on an NVIDIA GPU",
              file=sys.stderr)
        sys.exit(1)
    gpu = gpu_line()
    print(f"gpu: {gpu}", flush=True)
    return gpu


def bench_scene(n_prims: int, device):
    """``benchmark_scene(n_prims)``'s spec and params on ``device``."""
    cs = compile_scene(benchmark_scene(n_prims))
    return cs.spec, params_from_numpy(cs.params, cs.spec, device)


def probe_rays(width: int, height: int, device):
    """The probes' primary rays (ops/camera.py, fov 1, no jitter: the JAX
    probes' rays at pixel corners), flat (n,) row-major."""
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device), indexing="ij")
    u, v = calc_uv(xs.reshape(-1), ys.reshape(-1), width, height,
                   width / height)
    ro, rd = primary_ray(u, v, 1.0)
    return (Vec3(*(c.contiguous() for c in ro)),
            Vec3(*(c.contiguous() for c in rd)))


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` calls after one
    warm-up call, by CUDA events."""
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
