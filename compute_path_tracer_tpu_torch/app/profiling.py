"""Profiling hooks and roofline accounting (JAX package:
``app/profiling.py``).

* ``device_trace``: a ``torch.profiler`` trace of the card around a block.
* ``FrameCost``: the JAX package's analytic estimate of a frame's work.
* The operation counts per executed item, read off the CUDA sources, and
  ``bound_ms``: the least time the card could take for a work count, the
  largest of its bytes over the memory rate, its FP32 operations over
  ``fp32_peak``, for table taps its shared-memory words over
  ``smem_rate`` and, where a kernel's roots and reciprocals are counted,
  its MUFU instructions over ``mufu_rate``.  chip_smoke.py's bounds read
  them from here.
* ``measured_frame_cost``: a frame's executed work from debug 4, per warp of
  K2 (kernels/megakernel.py:MarchStats).
* ``measure_frame_time``: the median time of a frame on the card.

The JAX module's TPU figures are not carried over: its nominal VPU peak
gives way to ``fp32_peak``, read off the card, and its attainable rate
(``ATTAINABLE_VPU_TFLOPS``) is the port's ``vpu_peak`` probe's on the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import subprocess
import time

import numpy as np
import torch

from ..kernels.march import march_rays_plain
from ..kernels.megakernel import (
    WARP,
    MarchStats,
    render_frame_megakernel,
    render_frame_megakernel_plain,
)
from ..render.program import OPC_SHAPE

# The card's attainable FP32 rate: the best of vpu_peak's chain widths
# (python -m compute_path_tracer_tpu_torch.benchmarks.vpu_peak: 64 chains of
# fused multiply-adds over 16 tiles of (64, 128)), 0.951 of fp32_peak's
# 66.91 TFLOP/s, measured on an NVIDIA H100 80GB HBM3 at a power limit of
# 700.00 W.
ATTAINABLE_VPU_TFLOPS = 63.61

# -- the analytic estimate (the JAX package's model) --------------------------

# Approximate per-primitive vector-op cost of one map() evaluation:
# transform (scale+move+rot3d ~21) + sdf (~8) + scale fix + CSG combine (~7).
_OPS_PER_PRIM_EVAL = 36
# map taps per bounce: march steps + 6 normal taps.
_NORMAL_TAPS = 6
# Per shape-evaluation cost of the baked map, one blended constant (sphere
# ~10, cube ~27, octahedron ~25, combine and guard ~4).
_OPS_PER_BAKED_EVAL = 20


@dataclasses.dataclass
class FrameCost:
    """Analytic operation estimate for one progressive frame, assuming no
    early exit and no culling."""

    width: int
    height: int
    n_prims: int
    bounces: int
    march_steps: int = 80

    @property
    def map_evals_per_bounce(self) -> int:
        return self.march_steps + _NORMAL_TAPS

    @property
    def flops(self) -> float:
        rays = self.width * self.height * (self.bounces + 1)
        return (float(rays) * self.map_evals_per_bounce * self.n_prims
                * _OPS_PER_PRIM_EVAL)

    def achieved_tflops(self, frame_seconds: float) -> float:
        return self.flops / frame_seconds / 1e12

    def utilization(self, frame_seconds: float, peak_tflops: float = None
                    ) -> float:
        """Fraction of the card's FP32 peak (``fp32_peak``, unless given)
        the frame achieved under this model; above 1.0 culling and early
        exit win."""
        if peak_tflops is None:
            peak_tflops = fp32_peak() / 1e12
        return self.achieved_tflops(frame_seconds) / peak_tflops


# -- operation counts and the bound -------------------------------------------

# Operations per executed item, counted from the kernels' sources (each add,
# sub, mul, div, sqrt, min, max, abs and compare one): the slab test of one
# AABB per ray segment, one map tap (the point, the step, its tests), one
# baked leaf with its fold, by kind (sphere, cube, plane, octahedron), and
# K1's closed-form test of a leaf without a box.  Integer guard bookkeeping,
# loads and K1's tests of the boxed leaves a ray enters are not counted, so
# the bound is a lower one.
HBM_BYTES_PER_S = 3.35e12
SLAB_OPS = 26
TAP_OPS = 11
LEAF_OPS = {0: 12, 1: 39, 2: 7, 3: 32}
# The exact normal (normals="autodiff", csg_program.cuh:grad_exact_walk), by
# the same rules: per walk the normalisation of its gradient (a dot product,
# the test, the root, the reciprocal and 3 muls), and per baked leaf its
# LEAF_OPS (the value and its fold) and what only the gradient takes:
# sphere the 3 divisions of length_grad (its dot product and root are the
# value's), cube those 3, the tie slopes and abs slopes of its max
# component and 3 sign products (26) and A^T (15), plane none, octahedron
# one branch's clip slope, 3 divisions and spread (13), the abs slopes (6)
# and A^T (15); and per fold the union's tie test (2).
GRAD_TAP_OPS = 11
GRAD_LEAF_OPS = {k: LEAF_OPS[k] + v
                 for k, v in {0: 3 + 2, 1: 41 + 2, 2: 0 + 2, 3: 34 + 2}.items()}
ANALYTIC_LEAF_OPS = {0: 22, 1: 70, 2: 16, 3: 113}
# K4's work beyond the map taps and leaves above, per item, read off
# train_fused.cu (the same counting rules): one bounce's replay with its
# adjoint (replay_adjoint), one leaf's slot partials by kind
# (leaf_partials), one leaf of the secondary exclusion fold by kind, and the
# per-pixel edge bookkeeping (slope, sigmoid, seed).
REPLAY_OPS = 180
PARTIAL_OPS = {0: 14, 1: 75, 2: 8, 3: 70}
EXCL_OPS = {0: 11, 1: 38, 2: 6, 3: 31}
EDGE_RAY_OPS = 40
# The grid march (csg_program.cuh:grid_tap, march_grid), counted from
# cast_grid's tally: every grid tap the cell index (3 subs, 3 muls, 3
# floors, 6 clamps), the box test (6 compares), the near test and, per
# smooth node, the dip (a mul and a sub); a tap outside the box the
# fallback (the box distance, 12 ops, and the root, 6) and each plane row
# (3 muls, 3 adds and a min); a cheap step the point (3 muls, 3 adds), the
# step, the cap's min and the far test.  An exact step's point and step are
# in TAP_OPS.
GRID_TAP_OPS, GRID_DIP_OPS = 22, 2
GRID_OUTSIDE_OPS, GRID_PLANE_OPS = 18, 7
GRID_CHEAP_OPS = 9
# The hardware probes (csrc/hw_probes.cu), by the same rules: vpu_peak per
# element, each chain's start (an add), two fused multiply-adds (two ops
# each) per iteration and the chains' sum; gather_probe per tap the chain's
# add (its index arithmetic is integer) and one shared-memory word, and per
# iteration of the arithmetic map tap 12 shapes of a sub, a mul, two adds,
# the root, a sub and a min, then x's step and the sum; bf16_probe per march
# step (float32 ops, bf16 ops): the point (3 muls, 3 adds), per sphere 3
# subs, 3 muls, 2 adds, the root (float32 in every variant), a sub and a
# min, then the step's abs, test and add, and per rep the sum, per ray the
# mean's division; mxu_transform_probe per shape three rows of the
# transforms (oq: 3 muls, 3 adds; dq: 3 muls, 2 adds) and the slab (abs,
# test, division, 2 subs, 2 muls, 2 mins, 2 maxes), the hit (2 tests, abs,
# min), and per rep the sum.  Conversions and selects are not counted.
GATHER_CHAIN_OPS = 1
GATHER_ARITH_OPS = 12 * 7 + 2
BF16_STEP_OPS = {"f32": (141, 0), "map": (20, 121), "all": (12, 129)}
MXU_SHAPE_OPS = 3 * (6 + 5 + 11) + 4
# Their MUFU instructions, which the operation counts above take as one
# FP32 operation each: gather_probe's arithmetic tap one MUFU.RSQ a root,
# 12 an iteration; bf16_probe one a sphere and ray-step (the float32
# root's MUFU.RSQ, or each packed half's sqrt.approx.f32: 24 a pair-step);
# mxu_transform_probe one MUFU.RCP a row, 3 a shape.
GATHER_ARITH_MUFU = 12
BF16_STEP_MUFU = 12
MXU_SHAPE_MUFU = 3
# The wavefront renderer's bytes (csrc/wavefront.cu and the compaction of
# benchmarks/frozen_wavefront.py): the kernel reads and writes a live ray's
# state (9 floats and the RNG word) and writes its add (3 floats) and alive
# flag; the compaction moves each survivor's state and its int64 pixel id,
# read once and written once.
WAVE_STATE_BYTES = 40
WAVE_BOUNCE_BYTES = 2 * WAVE_STATE_BYTES + 16
WAVE_COMPACT_BYTES = 2 * (WAVE_STATE_BYTES + 8)
# FP32 lanes of one Hopper SM, and the words its shared memory serves a
# clock: 32 banks of four bytes, one word each (NVIDIA's CUDA C++
# Programming Guide, shared memory of compute capability 9.0).
_SM_LANES = 128
SMEM_WORDS_PER_SM_CLOCK = 32
# MUFU instructions an SM issues a clock, per lane: 16 (the same guide's
# throughput table, compute capability 9.0: reciprocal, reciprocal square
# root, square root, log2, exp2, sine, cosine).
MUFU_PER_SM_CLOCK = 16


def gpu_line(query: str = "name,power.limit") -> str:
    """``nvidia-smi --query-gpu=<query> --format=csv,noheader`` of the first
    card."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _sms_and_clock(device):
    """The card's SM count and its max SM clock in Hz (``clocks.max.sm``)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms, float(gpu_line("clocks.max.sm").split()[0]) * 1e6


def fp32_peak(device=0) -> float:
    """FP32 operations per second at the card's max SM clock: its SMs
    (``torch.cuda.get_device_properties``) x 128 lanes x 2 (a fused
    multiply-add) x the ``clocks.max.sm`` that nvidia-smi reports."""
    sms, hz = _sms_and_clock(device)
    return sms * _SM_LANES * 2 * hz


def smem_rate(device=0) -> float:
    """Shared-memory words per second at the clock ``fp32_peak`` uses: its
    SMs x 32 words x ``clocks.max.sm``."""
    sms, hz = _sms_and_clock(device)
    return sms * SMEM_WORDS_PER_SM_CLOCK * hz


def mufu_rate(device=0) -> float:
    """MUFU instructions (lanes) per second at the clock ``fp32_peak``
    uses: its SMs x 16 x ``clocks.max.sm`` (4.18e12 on 132 SMs at 1,980
    MHz)."""
    sms, hz = _sms_and_clock(device)
    return sms * MUFU_PER_SM_CLOCK * hz


def bound_ms(n_bytes, ops, peak, smem_words=0, mufu=0):
    """(bound ms, what sets it): the largest of the bytes over the memory
    rate ("bytes"), the operations over ``peak`` ("operations"), the
    shared-memory words over ``smem_rate`` ("shared memory") and the MUFU
    instructions over ``mufu_rate`` ("MUFU")."""
    terms = {"bytes": n_bytes / HBM_BYTES_PER_S, "operations": ops / peak}
    if smem_words:
        terms["shared memory"] = smem_words / smem_rate()
    if mufu:
        terms["MUFU"] = mufu / mufu_rate()
    by = max(terms, key=terms.get)
    return terms[by] * 1e3, by


def _leaf_ops(count) -> float:
    return sum(int(count.get(k, 0)) * v for k, v in LEAF_OPS.items())


def march_ops(count, prog) -> float:
    """FP32 operations of the march work in ``count`` (make_map_program's
    tally, with "segments", and make_grad_program's for the exact
    normal)."""
    return (count["segments"] * prog.n_boxed * SLAB_OPS
            + count["taps"] * TAP_OPS + _leaf_ops(count)
            + int(count.get("grad_taps", 0)) * GRAD_TAP_OPS
            + sum(int(count.get(("grad", k), 0)) * v
                  for k, v in GRAD_LEAF_OPS.items()))


def dense_ops(count, prog) -> float:
    """The dense probe's work in ``count`` (make_map_program's tally of the
    exact march, with "segments"): every leaf of the program on every tap."""
    kinds = prog.ops[prog.ops[:, 0] == OPC_SHAPE, 1].tolist()
    return (count["segments"] * prog.n_boxed * SLAB_OPS
            + int(count["taps"]) * (TAP_OPS + sum(LEAF_OPS[k] for k in kinds)))


def analytic_ops(segments, prog) -> float:
    free = [op[1] for op in prog.ops.tolist()
            if op[0] == OPC_SHAPE and op[3] < 0]
    return segments * (prog.n_boxed * SLAB_OPS
                       + sum(ANALYTIC_LEAF_OPS[k] for k in free))


def cap_ops(count, prog) -> float:
    """FP32 operations of the analytic_unboxed cap: its closed form over the
    program's cap list, once per ray segment that computes it."""
    return count.get("cap_segments", 0) * sum(
        ANALYTIC_LEAF_OPS[k] for k in prog.caps[:, 0].tolist())


def grid_ops(count, spec) -> float:
    """FP32 operations of the grid march in ``count`` (cast_grid's tally),
    beyond its exact taps."""
    from ..render.distgrid import _grid_static

    _b, planes, k_offs = _grid_static(spec)
    return (int(count.get("grid_taps", 0))
            * (GRID_TAP_OPS + GRID_DIP_OPS * len(k_offs))
            + int(count.get("grid_outside", 0))
            * (GRID_OUTSIDE_OPS + GRID_PLANE_OPS * len(planes))
            + int(count.get("grid_cheap", 0)) * GRID_CHEAP_OPS)


def soa_ops(segments, layout) -> float:
    """K1's operations per frame read off the packed tables (K5: no program
    holds 512 guarded shapes): per ray segment, every guarded shape's slab
    test and its valid ancestor slabs, and the closed form of every
    unguarded shape; the closed forms of the guarded shapes a ray enters
    are not counted, as in analytic_ops."""
    per = 0
    for kd in layout.kinds:
        guard = layout.i_const[kd.i_guard:kd.i_guard + kd.n]
        anc = layout.i_const[kd.i_anc_valid:kd.i_anc_valid + kd.n * kd.a]
        per += (int(guard.sum()) * SLAB_OPS + int(anc.sum()) * SLAB_OPS
                + int((guard == 0).sum()) * ANALYTIC_LEAF_OPS[kd.kind])
    return segments * per


def fused_ops(count, prog, analytic) -> float:
    """FP32 operations of K4's work in ``count`` (fused_planes_plain's
    tally)."""
    seg = count.get("segments", 0)
    ops = (analytic_ops(seg, prog) if analytic
           else seg * prog.n_boxed * SLAB_OPS)
    ops += count.get("taps", 0) * TAP_OPS + _leaf_ops(count)
    ops += count.get("edge_rays", 0) * (prog.n_boxed * SLAB_OPS + EDGE_RAY_OPS)
    ops += count.get("replays", 0) * REPLAY_OPS
    ops += sum(int(count.get(("partials", k), 0)) * v
               for k, v in PARTIAL_OPS.items())
    ops += sum(int(count.get(("excl", k), 0)) * v for k, v in EXCL_OPS.items())
    return ops


def wavefront_work(count, prog):
    """(FP32 operations, bytes) of the wavefront frame whose plain bounces
    filled ``count`` (``wavefront_bounce_plain``: segments, survivors and
    the faithful map's tally): the march and normal work as K2's, and the
    bytes the bounces and the compactions move."""
    return (march_ops(count, prog),
            float(count["segments"]) * WAVE_BOUNCE_BYTES
            + float(count["survivors"]) * WAVE_COMPACT_BYTES)


def fused_bwd_ops(prog, table, ro, rd) -> float:
    """FP32 operations of the fused-bwd probe on the rays ``(ro, rd)``: the
    guards and exact march of each ray and the 6 normal taps of each hit,
    counted by K3's plain march (``march_rays_plain``) over the probe's
    baked program; the shading is not counted."""
    count = {"segments": ro.x.shape[0]}
    march_rays_plain(prog, table, ro, rd, t_cull=False, with_normal=True,
                     count=count)
    return march_ops(count, prog)


def segsum_bytes(n_b, n, n_ch, n_seg) -> float:
    """Bytes of the segment sum: each element's id and its ``n_ch``
    cotangents read once, the (n_seg, n_ch) sums written once."""
    return float(n_b) * n * (4 + 4 * n_ch) + 4.0 * n_seg * n_ch


def vpu_ops(elems, width, iters) -> float:
    """FP32 operations of vpu_peak's ``width`` chains on ``elems``
    elements."""
    return float(elems) * (width * (1 + 4 * iters) + width - 1)


def gather_work(kind, elems, iters):
    """(FP32 operations, shared-memory words) of a gather_probe kernel on
    ``elems`` lanes: ``"once"`` (one tap), ``"chain"`` (``iters`` taps of
    the 128- or 512-entry table) or ``"arith"``."""
    if kind == "once":
        return 0.0, float(elems)
    if kind == "chain":
        return float(elems) * iters * GATHER_CHAIN_OPS, float(elems) * iters
    if kind == "arith":
        return float(elems) * iters * GATHER_ARITH_OPS, 0.0
    raise ValueError(f"unknown gather kind {kind!r}")


def gather_mufu(kind, elems, iters) -> float:
    """MUFU instructions of a gather_probe kernel on ``elems`` lanes: the
    arithmetic tap's roots (``"arith"``); the taps take none."""
    if kind not in ("once", "chain", "arith"):
        raise ValueError(f"unknown gather kind {kind!r}")
    return float(elems) * iters * GATHER_ARITH_MUFU if kind == "arith" else 0.0


def bf16_mufu(rays, reps, steps) -> float:
    """MUFU instructions of bf16_probe's march, any variant: a root a
    sphere and ray-step."""
    return float(rays) * reps * steps * BF16_STEP_MUFU


def mxu_mufu(rays, n_shapes) -> float:
    """MUFU instructions of the work mxu_transform_probe's output needs (one
    rep, as ``mxu_ops``): a reciprocal a row."""
    return float(rays) * n_shapes * MXU_SHAPE_MUFU


def bf16_ops(variant, rays, reps, steps) -> float:
    """bf16_probe's ``variant`` as float32 operations: its bf16 operations
    count half, at the packed bf16 rate (two a lane a clock)."""
    f32, bf = BF16_STEP_OPS[variant]
    return float(rays) * (reps * (steps * (f32 + bf / 2) + 1) + 1)


def mxu_ops(rays, n_shapes, reps) -> float:
    """The work mxu_transform_probe's output needs, the same for the scalar
    and tensor-core kernels (one function): one rep's transforms as float32
    multiply-adds and its slab fold, then ``reps`` adds.  Every rep computes
    the same t_min; the kernels repeat it ``reps`` times, which is the
    probe's method: that work is ``reps * mxu_ops(rays, n_shapes, 1)``."""
    return float(rays) * (n_shapes * MXU_SHAPE_OPS + reps)


# -- traces and measured work -------------------------------------------------


@contextlib.contextmanager
def device_trace(logdir: str):
    """A ``torch.profiler`` trace of the host and the card around a block,
    written to ``logdir/trace.json`` (chrome://tracing, Perfetto); yields
    the profiler, whose ``key_averages()`` sum the kernels by name."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def group_stats(img, group=WARP) -> np.ndarray:
    """Debug 4's (x, y, z) per group of pixels, (n_groups, 3) float64: the
    top-left pixel of each group holds it."""
    gh, gw = group
    return img[::gh, ::gw].reshape(-1, 3).double().cpu().numpy()


def lane_fill(img, bounces: int, group=WARP) -> dict:
    """The lane fill of a frame cast one thread a pixel, from its debug 3
    image (K1's or the plain frame's): each pixel's casts, ``min(i_exit + 1,
    bounces + 1)`` with i_exit = its value x ``bounces``, and per ``group``
    of pixels (a warp of the old K1 schedule, K2's 16x2 by default: the
    warp ran until its longest path ended) the longest lane's.
    ``fill`` is the lanes' casts over the group's lanes x its casts;
    ``mean_casts`` per pixel and ``mean_longest`` per group.  ``bounces``
    must be at least 1."""
    gh, gw = group
    i_exit = torch.round(img[..., 0].double() * bounces).long()
    casts = torch.clamp(i_exit + 1, max=bounces + 1)
    h, w = casts.shape
    pad = casts.new_zeros((-(-h // gh) * gh, -(-w // gw) * gw))
    pad[:h, :w] = casts
    longest = pad.view(pad.shape[0] // gh, gh, pad.shape[1] // gw, gw).amax(
        dim=(1, 3))
    return {"fill": float(casts.sum()) / (gh * gw * float(longest.sum())),
            "mean_casts": float(casts.double().mean()),
            "mean_longest": float(longest.double().mean())}


def measured_frame_cost(spec, params, *, width, height, bounces,
                        geometry="baked", t_cull=True, frame=1, group=WARP):
    """A frame's executed work, from debug 4 of the march (JAX: per tile of
    its kernel; here per warp of K2, ``MarchStats``): ``march_steps_total``
    (the warps' march iterations), ``march_evals`` and ``aux_evals`` (the
    lane slots the warps executed for shapes in the march and in the normal
    taps: y and z times the lanes of a group), their sum
    ``shape_evals_executed``, per ray segment ``shape_evals_per_ray``, and
    ``flops_executed`` at the JAX package's blended cost per evaluation.

    On a CUDA tensor K2 measures its warps (``group`` must be ``WARP``); on
    a CPU tensor the plain version groups the pixels by ``group``.  The
    result names the device."""
    kw = dict(width=width, height=height, debug=4, bounces=bounces,
              frame=frame, last_clear=frame, geometry=geometry, t_cull=t_cull)
    group = (int(group[0]), int(group[1]))
    if params.device.type == "cuda":
        if group != WARP:
            raise ValueError(f"the kernel's statistics are per warp {WARP}")
        img = render_frame_megakernel(spec, params, **kw)
        device = torch.cuda.get_device_name(params.device)
    else:
        img = render_frame_megakernel_plain(spec, params,
                                            stats=MarchStats(group), **kw)
        device = str(params.device)
    per = group_stats(img, group)
    lanes = group[0] * group[1]
    march_evals = float(per[:, 1].sum()) * lanes
    aux_evals = float(per[:, 2].sum()) * lanes
    total = march_evals + aux_evals
    rays = width * height * (bounces + 1)
    return {
        "march_steps_total": float(per[:, 0].sum()),
        "march_evals": march_evals,
        "aux_evals": aux_evals,
        "shape_evals_executed": total,
        "shape_evals_per_ray": total / rays,
        "flops_executed": total * _OPS_PER_BAKED_EVAL,
        "device": device,
    }


def measure_frame_time(frame_fn, *args, warmup: int = 1, iters: int = 3,
                       **kwargs) -> float:
    """Median wall time in seconds of ``frame_fn`` on the card, each call
    ended by ``torch.cuda.synchronize`` (which raises where there is no
    card)."""
    for _ in range(warmup):
        frame_fn(*args, **kwargs)
        torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        frame_fn(*args, **kwargs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
