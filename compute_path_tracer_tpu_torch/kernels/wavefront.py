"""One bounce of the wavefront renderer through ``csrc/wavefront.cu``, and
its plain torch version (JAX package:
``benchmarks/frozen_wavefront.py:_bounce_call``).

The ray state lives in a flat buffer of ``n`` rays: ``ray`` (9, n) float32,
the planes ro.xyz, rd.xyz and thr.rgb, and ``rng`` (n,) int32 holding each
ray's uint32 RNG state bit for bit.  Rays ``[0, k)`` are live, ``k`` a
(1,) int32 tensor on the buffer's device that the kernel reads there, so a
bounce needs no host synchronisation.  ``wavefront_bounce`` shades the live
rays over a faithful CSG program (render/program.py): its guards, the exact
march, the 6-tap normal, the material, ``shade_bounce`` and the Russian
roulette.  It updates ``ray`` and ``rng`` in place (a miss keeps its state,
a hit that dies its throughput, as the JAX kernel's selects leave them) and
returns ``(add, alive)``: (n, 3) float32 radiance to add to each ray's
pixel and (n,) int32 survivors, zero for every ray at or past ``k``.

On CUDA tensors it launches the kernel on the current stream without
synchronising and counts the launch in ``LAUNCHES``; on CPU tensors it
runs :func:`wavefront_bounce_plain`; on any other device it raises.  The
renderer around it is the port's ``benchmarks/frozen_wavefront.py``.
"""

from __future__ import annotations

import torch

from ..constants import FP, MAT_SIZE
from ..render.program import (
    Program,
    make_map_program,
    program_bounds,
    program_code_on,
)
from ..render.reference import (
    calc_normal,
    cast_ray,
    gather_material,
    roulette,
    shade_bounce,
    take_lanes,
)
from ..vecmath import Vec3, vwhere
from .build import load_library

# Launches since import (or since a caller reset them).
LAUNCHES = {"wavefront_bounce": 0}

_U32 = 0xFFFFFFFF


def _check(prog: Program, table, k, ray, rng) -> int:
    if prog.geometry != "faithful":
        raise ValueError("the wavefront bounce marches a faithful program")
    device = table.device
    n = ray.shape[-1]
    checks = (
        (table, torch.float32, (prog.f_len,)),
        (k, torch.int32, (1,)),
        (ray, torch.float32, (9, n)),
        (rng, torch.int32, (n,)),
    )
    for name, (t, dtype, shape) in zip(("table", "k", "ray", "rng"), checks):
        if (t.device != device or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous {dtype} {shape} on "
                             f"{device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    return n


@torch.no_grad()
def wavefront_bounce_plain(prog: Program, table, k, ray, rng, count=None):
    """The kernel's bounce in vectorized torch over the live rays ``[0,
    k)`` (``k`` is read on the host).  ``count``, a dict, accumulates the
    kernel's work: ``"segments"`` (the live rays), ``"survivors"`` and the
    map's tally (``make_map_program``) of the march and the normal taps."""
    n = _check(prog, table, k, ray, rng)
    live = int(k[0])
    add = torch.zeros((n, 3), dtype=torch.float32, device=ray.device)
    alive = torch.zeros(n, dtype=torch.int32, device=ray.device)
    if count is not None:
        count["segments"] = count.get("segments", 0) + live
    if live == 0:
        return add, alive
    ro, rd, thr = (Vec3(*ray[j:j + 3, :live]) for j in (0, 3, 6))
    map_fn = make_map_program(prog, table.tolist(), count)

    def map_checked(p, checks):
        return map_fn(p, checks[0])

    checks, _ = program_bounds(prog, table, ro, rd, False)
    t, idx = cast_ray(map_checked, ro, rd, checks)
    hit = ~(t > FP)
    lanes = torch.nonzero(hit).flatten()
    ro, rd, thr = (Vec3(*(c[lanes] for c in v)) for v in (ro, rd, thr))
    hp = ro + rd * t[lanes]
    nrm = calc_normal(map_checked, hp, take_lanes(checks, lanes))
    mats = table[prog.f_mat:].view(prog.n_shapes, MAT_SIZE)
    state = rng[lanes].to(torch.int64) & _U32
    state, new_ro, new_rd, emit, thr_factor, ray_prob = shade_bounce(
        state, rd, hp, nrm, gather_material(mats, idx[lanes]))
    state, surv, new_thr = roulette(state, thr * thr_factor / ray_prob)
    # 0 + emission x throughput, as the kernel adds it to its zero sum.
    add.index_add_(0, lanes, (emit * thr).stack())
    alive[lanes] = surv.to(torch.int32)
    if count is not None:
        count["survivors"] = count.get("survivors", 0) + surv.sum()
    ray[:, lanes] = torch.stack([*new_ro, *new_rd,
                                 *vwhere(surv, new_thr, thr)])
    rng[lanes] = state.to(torch.int32)
    return add, alive


def wavefront_bounce(prog: Program, table, k, ray, rng):
    """One bounce of the live rays ``[0, k)`` of the buffer; returns ``(add,
    alive)`` and updates ``ray`` and ``rng`` in place (see the module
    note).  ``prog`` is ``build_program(spec, "faithful")``, ``table`` its
    ``program_table(prog, params)``."""
    if table.device.type == "cpu":
        return wavefront_bounce_plain(prog, table, k, ray, rng)
    if table.device.type != "cuda":
        raise ValueError(f"no kernel for device {table.device}")
    n = _check(prog, table, k, ray, rng)
    add = torch.empty((n, 3), dtype=torch.float32, device=ray.device)
    alive = torch.empty(n, dtype=torch.int32, device=ray.device)
    if n:
        code = program_code_on(prog, table.device)
        with torch.cuda.device(table.device):
            err = load_library().cpt_wavefront_bounce(
                code.data_ptr(), prog.ops.shape[0], table.data_ptr(),
                prog.n_boxed, prog.f_box, prog.f_mat, k.data_ptr(), n,
                ray.data_ptr(), rng.data_ptr(), add.data_ptr(),
                alive.data_ptr(),
                torch.cuda.current_stream(table.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"wavefront_bounce launch failed: CUDA error "
                               f"{err}")
        LAUNCHES["wavefront_bounce"] += 1
    return add, alive
