#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port's main paths.

    python3 chip_smoke.py

Needs one NVIDIA GPU (sm_90a) with the CUDA toolkit; exits non-zero without
printing a result when there is none or when the port's package is missing.
It builds the CUDA kernels from the checkout and, for each kernel, holds it
against its plain torch version on the card (at 320x180 over scenes and
modes, and one frame at its main path's 1920x1080; the megakernels' frames
and K4's image bit for bit), then drives its main
path through RenderSession at 1920x1080 over the 64-primitive benchmark
scene with 8 bounces (the JAX package's bench.py rows):

* K1, megakernel_analytic: the full-analytic bounce
  (``geometry="baked", analytic_all=True``): persistent blocks over the
  scene staged in shared memory, lanes refilled with new pixels, the box
  test's reciprocal hoisted per ray.  Its quotient is held to __fdiv_rn on
  2^24 seeded triples and the edge values (no difference allowed), its
  frame to the plain one also at a ragged 333x187, and at 1080p it prints
  the lane fill and the shapes some lane entered per warp cast, with
  refill and without (a warp per 16x2 tile), beside the fill that the
  debug 3 frame gives the old schedule (which the STATS kernel must
  reproduce exactly);
* K2, megakernel_march: the sphere march (``geometry="baked", t_cull=True``,
  bench.py's marching row); its checks cover faithful and baked geometry,
  subtraction, smooth union, refraction, the first-shape clobber, debug
  0-3, and ``benchmark_scene(256)`` (more than one ballot chunk of records
  and of box words, the largest shared-memory staging).  Its plain march
  walks per-warp lists of the program (csg_program.cuh:build_warp_list):
  each bounce's summed list length and list count at 1080p must be the
  plain model's (render/program.py:warp_records), and their means per
  bounce are printed with ptxas's registers and stack frame of the walk
  kernels (K2's, RELAX's, debug 4's, K6's, K3's and K4's);
* K2's last two modes: ``normals="autodiff"`` (each marching
  kernel's EXACT instantiation, the exact gradient of the map in one walk
  of the warp's list) in debug 0 and 1 on csg_demo, blend_demo and the
  benchmark scene, in K2b, RELAX, K6 (its STATS form too) and debug 4,
  and ``refresh_every`` 4 and 8 (the frozen activation window) with and
  without the cap and the exact normal, both geometries: every new
  instantiation bit for bit its plain version at 320x180 (MODE_BOUNCES)
  and, for the exact normal and K = 4, at 1080p against the plain passes
  that count their work; their main paths through RenderSession at 1080p;
  their kernel times A B B A (medians of 10) against the 6-tap normal (K2
  debug 0 and 1, K6) and against K = 1 (K = 2, 4, 8), with the share of
  pixels each moves;
* save_png's native export (io/native.py) against its plain codec on a
  1080p frame: the same bytes, and their host times A B B A.

and the training path through the ray march K3 (march_rays): K3 against its
plain version on scattered rays over three scenes and every mode, on a ray
count that is not a multiple of 32, and on the 1080p primary rays; the
gradient of ``make_loss`` through K3 against the same with K3's plain
version and against the plain march at 320x180, and the implicit backward
on a loss of the hit distance (checked, and timed at 1080p); three timed
training steps (``make_loss(..., geometry="baked", march="kernel",
normals="kernel")``, backward, Adam) at 1920x1080 with 8 bounces (bench.py's
fast-gradient row); ``optimize_to_target`` on a small scene and the CLI's
``optimize``;

and the modes of the same two kernels that the last bench.py rows run:

* K2b on K2's binary: ``analytic_unboxed`` (the guard-less shapes
  intersected in closed form, capping the march; bench.py:189) against its
  plain version on four scenes in debug 0 and 3, ``omega`` 1.6 (RELAX, the
  over-relaxed march on K2's per-warp walk) on baked and faithful geometry,
  ``omega=1.0`` bit for bit the march without it, and its main path
  through RenderSession at 1920x1080;
* K5 on K1's binary: ``analytic_soa`` (bench.py:275) on
  ``benchmark_scene(256)`` and ``(512)`` against its plain version, bit for
  bit K1's ``analytic_all`` frame at 64 primitives, and its main path at
  1920x1080 for each, with K1's lane statistics;
* K6 on K2's binary: ``dist_grid`` (the march on the frame's baked
  lower-bound distance grid, benchmarks/distgrid_bench.py) against its plain
  version on four scenes in debug 0 and 3, with ``analytic_unboxed``, and
  with a zero ``grid_tau`` (every ray runs out of iterations); ``omega``
  ignored under it; its frame against K2's; its main path through
  RenderSession at 1920x1080 with one launch per frame, a 1080p plain frame
  held to the kernel's that counts the work, and kernel-only times at grid
  resolutions 8, 16 and 32 and a wider ``grid_tau`` beside K2's and K2b's,
  with the grid march's warp statistics; it walks K2's per-warp lists, and
  their lengths per bounce at 1080p must be the plain frame's model of
  them;
* multi-frame accumulation (``render_accumulated_megakernel``) through K1
  and K2, bit for bit the frames one at a time;
* debug 4 on K2's binary (its STATS kernel: per-warp march statistics,
  counted over K2's per-warp lists) against the plain reducer (kernels/megakernel.py:MarchStats), all three
  channels bit for bit, on four scenes over geometry, t_cull and
  ``analytic_unboxed``, with partial warps at 200x45, and at 1080p against
  the statistics of the plain pass that also checks K2's 1080p frame; its
  time beside K2's debug-0 time, the warp SIMT share, and its main path,
  ``app/profiling.py:measured_frame_cost`` at 1080p;
* the march probes (kernels/probes.py, ``csrc/march_probes.cu``: dense,
  capped, ILP seq and fused) against their plain versions on four scenes
  at 320x180 and on the 1080p primary rays, dense and ILP also against K3's
  exact march, bit for bit, and ILP on an odd ray count; their main paths,
  the measurement scripts of ``compute_path_tracer_tpu_torch/benchmarks/``
  at 1080p, time them beside K3's t-culled and exact marches; the dense
  probe walks the program staged in shared memory, and its row gives
  ptxas's figures and its own work (every leaf on every tap) at the FP32
  rate vpu_peak attains; the ILP probe walks K3's per-warp lists of the
  staged program, and its row gives ptxas's figures and the mean list
  lengths; the capped probe takes K3's t-culled kernel over the capped
  program, and its per-warp list figures must be the plain model's
  (``probes.capped_list_lengths``) on every scene and at 1080p;
* the hardware probes (kernels/hw_probes.py, ``csrc/hw_probes.cu``:
  vpu_peak's FMA chains at every width, gather_probe's four kernels with
  the table in shared memory and through ``__ldg``, bf16_probe's three
  marches, mxu_transform_probe's scalar and tensor-core transforms) against
  their plain versions at one tile (the JAX probe's) and at the main
  path's tile count, bit for bit but the tensor-core kernel (wgmma), which
  is held to ``hw_probes.mxu_tensor_diff``'s tolerance; their main paths, the
  measurement scripts of ``compute_path_tracer_tpu_torch/benchmarks/``
  (16 tiles of (64, 128); bf16 4 of (256, 128)), time them, and each
  kernel's time at half its reps (a chain's at half its iterations) must
  be about half its full time.  The shared-memory gather chains, over
  replicated rows, take their index by one add rounded toward zero on rows
  that pass a range test and by F2I on the others: both paths are held
  bit for bit on rows made to take each; gather_arith's branch-free root
  must equal ``__fsqrt_rn`` on every float32 of ``hw_probes.ROOT_DOMAIN``,
  which holds every root argument of the driver's inputs, its SASS must
  call no slow path, and ``correct128`` is timed beside ``torch.gather``.
  The bf16 kernels march two reps a thread
  in packed halves with an approximate root: its bits for every bf16 bit
  pattern below 0x8000 must be the card's IEEE root's and the correctly
  rounded one's, their SASS must hold no HFMA2 that contracts a multiply
  and an add, and their row gives ptxas's figures and packed instruction
  counts;
* the wavefront and gradient probes (kernels/wavefront.py,
  kernels/grad_probes.py; ``csrc/wavefront.cu``, ``csrc/grad_probes.cu``):
  the wavefront renderer's frame (one bounce kernel a bounce, the
  compaction in torch) bit for bit its plain frame at 320x180 on the
  benchmark scene and csg_demo, compacted and sorted, with the bounce's
  per-warp list figures equal to the plain model's, and at 1080p, where it
  is also K2's faithful exact frame bit for bit; the fused-bwd probe's
  loss within
  FB_LOSS_TOL of its plain version (autograd through the implicit march)
  at the JAX probe's tile and over the 1080p frame, both gradients all
  zero and finite, its per-warp list figures at the tile equal to the
  plain model's; the segment sum within SEGSUM_TOL of a float64 sum at
  the JAX probe's shape, at K4's (ids uniform and clustered; two launches
  bit for bit) and at S = 130, C = 28 and two ragged n, its non-finite
  entries the plain version's with NaN and inf on kept and dropped lanes,
  its SASS holding HMMA TF32 and no global atomic; their main paths, the
  measurement scripts of ``compute_path_tracer_tpu_torch/benchmarks/``
  (``frozen_wavefront``: 1080p frames, sorted and not, beside K2's, with
  the mean list length per bounce of each;
  ``probe_fused_bwd``: the tile and the frame beside K4's time a bounce;
  ``probe_inkernel_segsum``: the three rows beside ``index_add_``);

and the fused train step through K4 (train_fused): the whole step (loss,
gradient, image) with K4 against the same with its plain version at
320x180 in the winner and map-vjp modes, march and analytic_all phase 1,
with and without the edge terms, spp 2 and bounces 0; K4's image against
K1's and K2's frames; the main configuration (``analytic_all=True,
edge_grad=True``, bench.py:462) at 1080p against its plain version, and
whether K4's sums repeat bit for bit; three timed 1080p steps of each of
the three configurations of bench.py:462, :424 and :433; K4's
``analytic_unboxed`` mode (bench.py:442) against its plain step in four
cases and three timed 1080p steps of it and of the march without it; the
mean length of K4's per-warp lists per bounce at 1080p in each of the five
configurations (phase 1's march, the edge term and the secondary rows'
slope taps, the exclusion march); the flat ball's position recovered
by ``optimize_to_target(fused=True, edge_grad=True)`` and the CLI's
``optimize --fused --edge-grad``.

and the autograd path's edge estimators (diff/vjp.py: ``edge_grad``,
``edge_secondary``, their closest-approach marches in torch, no kernel of
their own): the image with both terms bit for bit the image without them,
their gradient through K3 against the same with K3's plain version (normals
detached and through the kernel) at 320x180, the flat ball's position
gradient of the sign of the loss's central finite difference, and one
timed 1080p step with both terms (K3's launches and time, the closest
marches' and their Danskin vjps' time, peak memory); and the app/io
surface: the CLI's ``optimize --edge-grad --edge-secondary`` without
``--fused``, ``render --checkpoint`` then ``--resume`` in a new process
bit for bit an uninterrupted run under K1 (``--mode analytic``) and K2
(``--mode tcull``), ``demo --max-events 2`` through a value edit and a
structure edit, and the TUI's controller over a card session.

and parallel/ (row-band and sample sharding over torch.distributed): K1
and K2 (baked t-culled and faithful) render 1920x1080 and 320x180 frames as
four bands (``row_offset``, ``crop_h``: 270 and 45 rows, the last row of
blocks partial), as do K5 on ``benchmark_scene(256)``, K6 and RELAX at
320x180, each through a RenderSession bit for bit the whole frame over two
frames, and debug 4 as four even 1080p bands; then, through a one-rank
NCCL group on the card, ``render_frame_sharded`` under K2 and K1 and
``render_samples_sharded`` bit for bit the single-device frames and
``make_sharded_train_step`` (through K3) and
``make_fused_sharded_train_step`` (K4) against the single-device loss and
gradient, as a main path whose launches are counted; and K1's and K2's
1080p time as one launch and as four band launches.

The checks against the plain versions that are host-bound plain passes
(K2, K2b, K5, K6, K3's scattered rays, the gradients through K3 with and
without the edge terms, K4 and debug 4 at 320x180; the 1080p plain passes
of K2, K2b, K6, K4's analytic_unboxed step and the wavefront, which also
count their work for the bounds; the CLI, checkpoint, demo and TUI runs;
parallel/'s band checks and sharded functions)
run in CHECK_WORKERS processes of this script
(``--check-worker``), started after the build and joined before the first
timed phase, so no timing overlaps them; each worker's output, with each
job's seconds and peak memory, is printed when it is joined.  The plain
times of those 1080p passes are therefore taken beside the other workers.

It prints each phase's start and the time the phase before it took,
timings beside the card's name and power limit, a kernels JSON line with
each kernel's time, its plain version's and its bound (and, for the
kernels that walk per-warp lists, their mean lengths per bounce), and
{"ok": true, "device": {...}} last; any failed check raises.  Imports
nothing of JAX.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
from functools import partial

CHECK_W, CHECK_H = 320, 180      # kernel-vs-plain phase
MAIN_W, MAIN_H, BOUNCES = 1920, 1080, 8
# The depth of the kernel-vs-plain checks at CHECK_W x CHECK_H in the check
# workers (K2, K2b, K5, K6, debug 4, K4, the wavefront): their host-bound
# plain passes cost about in proportion to the bounces traced, and at 8
# they took the script near its time limit.  Every check at the main path's
# shape (K1, K2, debug 4, K2b, K5, K6, K3, K4 and its analytic_unboxed
# step, the wavefront) and K1's cases keep BOUNCES.
CHECK_BOUNCES = 4
# The depth of the exact normal's and refresh_every's checks at CHECK_W x
# CHECK_H: the primary hit and one bounce take every normal and window the
# modes change, and their 1080p checks keep BOUNCES.
MODE_BOUNCES = 2
N_PRIMS = 64
TIMED_FRAMES = 8
DIFF_TOL = 1e-2                  # a pixel differs when max-channel |diff| > this
SHARE_LIMIT = 5e-3               # ... and a check fails above this share
ANALYTIC = dict(geometry="baked", analytic_all=True)
MARCH = dict(geometry="baked", t_cull=True)
# K2b's main path (bench.py:189) and K5's (bench.py:275, at SOA_PRIMS).
UNBOXED = dict(MARCH, analytic_unboxed=True)
# K6's main path (benchmarks/distgrid_bench.py), its timed grid resolutions
# and its wider exact-tap shell (16 MHD against GRID_TAU's 4).
GRID = dict(MARCH, dist_grid=True)
GRID_RES = (8, 16, 32)
GRID_TAU_WIDE = 16e-3
ACC_FRAMES = 3
# Debug 4's partial-warp check: a width that is not a multiple of 16 and an
# odd height.
D4_PARTIAL = (200, 45)
# The operation counts per executed item, the card's FP32 peak and the bound
# are app/profiling.py's.
SOA = dict(geometry="baked", analytic_soa=True)
SOA_PRIMS = (256, 512)
# K1's box-test quotient (the reciprocal hoisted per ray) against
# __fdiv_rn: seeded triples in the scenes' ranges, and a ragged frame for
# the persistent schedule's edge tiles.
QUOTIENT_PAIRS = 1 << 24
QUOTIENT_SEED = 13
K1_RAGGED = (333, 187)
OMEGA = 1.6
EXACT = dict(normals="autodiff")  # K2's and K6's exact-gradient normal
REFRESH_KS = (2, 4, 8)           # refresh_every windows timed against 1
MOVED_TOL = 1e-3                 # a pixel moved (JAX's refresh bound's tolerance)
# The training path: bench.py's fast-gradient row (bench.py:406).
TRAIN = dict(geometry="baked", march="kernel", normals="kernel")
TIMED_STEPS = 3
# The autograd path's edge estimators (diff/vjp.py): the primary and the
# secondary silhouette terms on the training configuration.
EDGE = dict(edge_grad=True, edge_secondary=True)
# render --checkpoint / --resume: (--mode, the kernel it launches).
RESUME_MODES = (("analytic", "megakernel_analytic"),
                ("tcull", "megakernel_march"))
K3_RAYS = CHECK_W * CHECK_H      # scattered rays per K3 check
K3_RAGGED = K3_RAYS - 13         # ... and a count that leaves a partial warp
WALK_PRIMS = 256                 # K2's check with the largest staging
T_TOL = 1e-3                     # a K3 ray differs when its id or its hit t does
GRAD_BOUNCES = 2
# Gradient through K3 against the same with K3's plain version: K3 matches
# it bit for bit, so only summation order may differ.
GRAD_LOSS_REL, GRAD_TOP_REL, GRAD_COS = 1e-5, 1e-4, 1e-6
TOP_FLOOR = 1e-6
# Against the plain (exact, uncut) march: t_cull moves hits inside the MHD
# shell, and on a silhouette a few pixels (16 of 57,600 on the benchmark
# scene) see another shape, lamps included, which dominate the loss; the
# gradient's direction must hold.
EXACT_COS = 1e-2

# The fused train step K4: its three 1080p configurations (bench.py:462,
# :424, :433; the first is the main one), its checks against its plain
# version at CHECK_W x CHECK_H, and their gates: loss, the 20 largest
# gradient slots and the cosine.  The slots' gate is 1e-2, not K3's 1e-4:
# with the images bit-equal, the plain version sums with atomics in no
# fixed order over slots with heavy cancellation, and the edge terms' slope
# factors read 6-tap normals, which its torch ops may round otherwise (the
# K2 debug-1 check above shows up to 5.7e-4); measured up to 1.9e-3 on a
# slot while the cosine stays within 3e-7 of 1 (PERF.md).
FUSED_MAIN = dict(analytic_all=True, edge_grad=True)
FUSED_CONFIGS = (("analytic_all + edge_grad", FUSED_MAIN),
                 ("march + edge_grad", dict(edge_grad=True)),
                 ("march + edge_grad + edge_secondary",
                  dict(edge_grad=True, edge_secondary=True)))
# K4's analytic_unboxed configuration (bench.py:442: march phase 1, no edge).
FUSED_UNBOXED = dict(analytic_unboxed=True)
FUSED_LOSS_REL, FUSED_TOP_REL, FUSED_COS = 1e-5, 1e-2, 1e-6
# K4's image must be its plain version's bit for bit: both trace the same
# rays (the plain primary rays divide by the image size as the kernels do,
# vecmath.div_exact), so every case is held to the gates above.  Before
# that, an ulp in a primary ray flipped a lamp's edge pixel and moved the
# secondary edge term's slots by up to 1.9e-2 (PERF.md).


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


# The hardware probes (kernels/hw_probes.py): each kernel against its plain
# version at one tile (the JAX probe's) and at its main path's tile count,
# bit for bit but mxu_tensor, held to hw_probes.mxu_tensor_diff's tolerance
# (its reason there); their main paths are the measurement scripts'
# measure().  A kernel's time at 64 reps (a chain's at 512 iterations) must
# be REP_RATIO_MIN times its time at half: no rep is hoisted away.
REP_RATIO_MIN = 1.6
HW_KEYS = {
    "vpu_peak": ("vpu_chains",),
    "gather_probe": ("gather_once_smem", "gather_once_ldg", "gather128_smem",
                     "gather128_ldg", "gather512_smem", "gather512_ldg",
                     "gather_arith"),
    "bf16_probe": ("bf16_f32", "bf16_map", "bf16_all"),
    "mxu_transform_probe": ("mxu_scalar", "mxu_tensor"),
}


def _bit_diff(k, p):
    """(max |k - p|, share of elements not bit-equal); equal values count
    0."""
    import torch

    d = torch.where(k == p, 0.0, (k.double() - p.double()).abs())
    return float(d.max()), float((k != p).double().mean())


def _plain_timed(fn):
    """``fn()`` and its host-clock ms, synchronised on both sides."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _hw_probe_checks(hp, mods):
    """Every hardware-probe kernel against its plain version on the card,
    at one tile and at the main path's tile count.  Returns per probe
    {"err": max |diff| over both, "off": the largest share off at the main
    tile count, "plain_ms": {kernel: plain ms at the main tile count}}."""
    import torch

    res = {name: {"err": 0.0, "off": 0.0, "plain_ms": {}} for name in mods}
    before = dict(hp.LAUNCHES)

    def record(name, label, tiles, diff, limit=0.0, ms=None):
        err, off = diff
        r = res[name]
        r["err"] = max(r["err"], err)
        if tiles == mods[name].TILES:
            r["off"] = max(r["off"], off)
            r["plain_ms"][label] = ms
        print(f"check {label}, {tiles} tile(s): max |diff| {err:.3e}, share "
              f"off {off:.6f} (limit {limit or 'bit-equal'})"
              + (f", plain {ms:.1f} ms" if ms is not None else ""))
        if off > limit:
            raise AssertionError(f"{label}, {tiles} tile(s): {off} off")

    vpu, gat = mods["vpu_peak"], mods["gather_probe"]
    bf, mxu = mods["bf16_probe"], mods["mxu_transform_probe"]
    for tiles in (1, vpu.TILES):
        x = vpu.inputs(tiles)
        for w in hp.VPU_WIDTHS:
            k = hp.vpu_chains(x, w)
            p, ms = _plain_timed(lambda w=w: hp.vpu_chains_plain(x, w))
            record("vpu_peak", f"vpu_chains {w} chains", tiles,
                   _bit_diff(k, p), ms=ms)
    for tiles in (1, gat.TILES):
        inp = gat.inputs(tiles)
        plain = {
            "correct128": _plain_timed(lambda: hp.gather_once_plain(
                inp["correct_tab"], inp["correct_idx"])),
            "gather128": _plain_timed(lambda: hp.gather_chain_plain(
                inp["tab"], inp["idx"])),
            "gather512": _plain_timed(lambda: hp.gather_chain_plain(
                inp["tab512"], inp["idx512"])),
            "arith": _plain_timed(lambda: hp.gather_arith_plain(inp["idx"]))}
        for label, fn in gat.kernels(inp).items():
            p, ms = plain[label.replace("_ldg", "")]
            record("gather_probe", label, tiles, _bit_diff(fn(), p), ms=ms)
    res["gather_probe"]["conversions"] = _gather_conversion_check(hp)
    res["gather_probe"]["root_mismatches"] = _gather_root_check(hp, gat)
    res["bf16_probe"]["roots"] = _bf16_root_check(hp, torch.device("cuda"))
    bad = hp.mxu_rcp_check(torch.device("cuda")).tolist()
    print(f"check mxu reciprocal (rcp_rn) over every float32 bit pattern: "
          f"{bad[0]} differ from the correctly rounded one where 1e-9 < |x| "
          f"< 2**126, {bad[1]} outside")
    if bad[0]:
        raise AssertionError(f"mxu reciprocal: {bad[0]} patterns differ")
    res["mxu_transform_probe"]["rcp_mismatches"] = bad
    for tiles in (1, bf.TILES):
        ro, rd, sph = bf.inputs(tiles)
        for v in hp.BF16_VARIANTS:
            k = hp.bf16_march(ro, rd, sph, v)
            p, ms = _plain_timed(
                lambda v=v: hp.bf16_march_plain(ro, rd, sph, v))
            if not bool(torch.isfinite(k).all()):
                raise AssertionError(f"bf16_march {v}: non-finite t")
            record("bf16_probe", f"bf16 {v}", tiles, _bit_diff(k, p), ms=ms)
    for tiles in (1, mxu.TILES):
        ro, rd, m, mat, off = mxu.inputs(tiles)
        k = hp.mxu_scalar(ro, rd, m)
        p, ms = _plain_timed(lambda: hp.mxu_scalar_plain(ro, rd, m))
        record("mxu_transform_probe", "mxu scalar", tiles, _bit_diff(k, p),
               ms=ms)
        k = hp.mxu_tensor(ro, rd, mat, off)
        p, ms = _plain_timed(lambda: hp.mxu_tensor_plain(ro, rd, mat, off))
        err, share, flips = hp.mxu_tensor_diff(k, p, hp.MXU_REPS)
        print(f"mxu tensor, {tiles} tile(s): hits flipped {flips:.6f}, rays "
              f"not bit-equal {float((k != p).double().mean()):.4f}")
        record("mxu_transform_probe", "mxu tensor", tiles, (err, share),
               hp.MXU_SHARE_OFF, ms)
    torch.cuda.synchronize()
    missing = [k for k in hp.LAUNCHES if hp.LAUNCHES[k] == before[k]]
    if missing:
        raise AssertionError(f"hardware-probe checks launched no {missing}")
    return res


def _gather_conversion_check(hp):
    """Both index conversions of the shared-memory chains on the card, bit
    for bit their plain version, the layout's model and the __ldg chain: a
    (1, 64, entries) table whose even rows lie in [0, 2**23) (one add
    rounded toward zero) and whose odd rows each hold a negative entry and
    one of 2**23 or more (the exact conversion), 512 iterations."""
    import numpy as np
    import torch

    out = {}
    rng = np.random.default_rng(18)
    for entries in (hp.LANES, hp.GRID_ENTRIES):
        tab = rng.uniform(0.0, hp.RZ_LIMIT, (1, hp.GATHER_H, entries))
        tab = tab.astype(np.float32)
        tab[0, 1::2, 5] = -7.25
        tab[0, 1::2, 9] = 3.0e7
        idx = rng.integers(0, entries, (1, hp.GATHER_H, hp.LANES))
        idx = idx.astype(np.int32)
        rz = hp.gather_rows_in_rz(tab[0])
        assert rz[0::2].all() and not rz[1::2].any()
        t, i = torch.from_numpy(tab).cuda(), torch.from_numpy(idx).cuda()
        plain = hp.gather_chain_plain(t, i).cpu()
        model = torch.from_numpy(hp.gather_chain_model(tab, idx))
        got = {load: hp.gather_chain(t, i, load=load).cpu()
               for load in ("smem", "ldg")}
        same = {"model": bool(torch.equal(model, plain)),
                **{load: bool(torch.equal(v, plain)) for load, v in got.items()}}
        print(f"check gather{entries} index conversions (32 rows one add "
              f"rounded toward zero, 32 the exact conversion): bit for bit "
              f"the plain chain {same}")
        if not all(same.values()):
            raise AssertionError(f"gather{entries} conversions: {same}")
        out[f"gather{entries}"] = same
    return out


def _gather_root_check(hp, gat):
    """gather_arith's branch-free root (sqrt_rn_dom) against __fsqrt_rn on
    the card over every non-negative float32 pattern, and every root
    argument of the driver's inputs inside the domain where 0 differ."""
    import torch

    args = hp.gather_arith_roots(gat.inputs(gat.TILES)["idx"])
    lo, hi = hp.ROOT_DOMAIN
    inside = bool(((args >= lo) & (args <= hi)).all())
    bad = hp.gather_root_check(torch.device("cuda")).tolist()
    print(f"check gather_arith root (sqrt_rn_dom) over every non-negative "
          f"float32 bit pattern: {bad[0]} differ from __fsqrt_rn in "
          f"[{lo:g}, {hi:g}], {bad[1]} outside; the driver's root arguments "
          f"lie in [{float(args.min()):g}, {float(args.max()):g}], inside "
          f"{inside}")
    if bad[0] or not inside:
        raise AssertionError(f"gather_arith root: {bad}, inside {inside}")
    return bad


def _hw_probe_main(hp, mods, other_counts, gpu):
    """Each measurement script's ``measure()``, with every kernel count set
    to 0 just before and read just after: (launches by kernel, result) per
    probe."""
    import torch

    runs = {}
    for name, mod in mods.items():
        for counts in (hp.LAUNCHES, *other_counts):
            for k in counts:
                counts[k] = 0
        out = mod.measure()
        torch.cuda.synchronize()
        keys = HW_KEYS[name]
        launches = {k: hp.LAUNCHES[k] for k in keys}
        others = [k for k, v in hp.LAUNCHES.items() if v and k not in keys]
        others += [k for c in other_counts for k, v in c.items() if v]
        if not all(launches.values()) or others:
            raise AssertionError(f"{name} launched {dict(hp.LAUNCHES)}; "
                                 f"others {others}")
        print(f"main path {name}, CUDA events: "
              + json.dumps({k: v for k, v in out.items() if k != "summary"})
              + f"; {json.dumps(out['summary'])}; launches {launches} [{gpu}]")
        ratios = out.get("reps_ratio") or out["summary"].get("iters_ratio")
        if ratios and min(ratios.values()) < REP_RATIO_MIN:
            raise AssertionError(f"{name}: a kernel's time at half its reps "
                                 f"is not about half: {ratios}")
        runs[name] = (launches, out)
    return runs


def _hw_probe_rows(hp, pf, mods, checks, runs, peak, gather_extra,
                   bf16_extra, mxu_extra):
    """The kernels-line rows of the hardware probes: each probe's headline
    kernel (vpu at its best width, gather128 from shared memory, bf16's
    bf16 map, mxu on the tensor cores) with its bound, and the others'
    times beside; ``gather_extra``, ``bf16_extra`` and ``mxu_extra`` join
    the gather, bf16 and mxu rows."""
    csrc = "compute_path_tracer_tpu_torch/kernels/csrc/hw_probes.cu"
    vpu, gat = mods["vpu_peak"], mods["gather_probe"]
    bf, mxu = mods["bf16_probe"], mods["mxu_transform_probe"]

    def row(name, line, ms, plain_ms, bound, **extra):
        # A shared-memory word is an operation of the kernels line's
        # "bound_by"; "bound_term" names the term that set the bound.
        launches = runs[name][0]
        return {"name": name, "route": "cuda", "source": csrc,
                "replaces": f"benchmarks/{name}.py:{line}",
                "launches": sum(launches.values()),
                "launches_by_kernel": launches,
                "max_abs_err": checks[name]["err"],
                "main_shape_share_off": checks[name]["off"], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound[0],
                "bound_by": "bytes" if bound[1] == "bytes" else "operations",
                "bound_term": bound[1], "library_ms": None, **extra}

    out = runs["vpu_peak"][1]
    w = out["summary"]["best_chains"]
    elems = vpu.TILES * hp.VPU_H * hp.LANES
    rows = [row("vpu_peak", 47, out["rows"][w]["ms"],
                checks["vpu_peak"]["plain_ms"][f"vpu_chains {w} chains"],
                pf.bound_ms(8 * elems, pf.vpu_ops(elems, w, hp.VPU_ITERS),
                            peak),
                chains=w, attainable_tflops=out["summary"]["attainable_tflops"],
                ms_by_chains={c: r["ms"] for c, r in out["rows"].items()})]

    out = runs["gather_probe"][1]
    lanes = gat.TILES * hp.GATHER_H * hp.LANES
    bounds = {}
    for k, kind, entries in (("correct128", "once", hp.LANES),
                             ("gather128", "chain", hp.LANES),
                             ("gather512", "chain", hp.GRID_ENTRIES),
                             ("arith", "arith", 0)):
        ops, words = pf.gather_work(kind, lanes, hp.GATHER_ITERS)
        bounds[k] = pf.bound_ms(4 * lanes * (2 + entries // hp.LANES), ops,
                                peak, words,
                                pf.gather_mufu(kind, lanes, hp.GATHER_ITERS))
    rows.append(row(
        "gather_probe", 132, out["rows"]["gather128"],
        checks["gather_probe"]["plain_ms"]["gather128"], bounds["gather128"],
        ms_by_kernel=out["rows"], bound_ms_by_kernel=bounds,
        library_ms_by_kernel={k: {"torch.gather": v}
                              for k, v in out["library"].items()},
        state="redesigned, PR 18 (chains: replicated rows, one bank a "
              "lane, the index by one add rounded toward zero; arith: the "
              "branch-free root sqrt_rn_dom)",
        conversions=checks["gather_probe"]["conversions"],
        root_mismatches=checks["gather_probe"]["root_mismatches"],
        **gather_extra,
        **{k: v for k, v in out["summary"].items()
           if k.endswith("maptap") or k.endswith("torch_gather")}))

    out = runs["bf16_probe"][1]
    rays = bf.TILES * hp.BF16_H * hp.LANES
    ray_bytes = 28 * rays + bf.TILES * hp.N_SPHERES * 16
    bounds = {v: pf.bound_ms(ray_bytes, pf.bf16_ops(v, rays, hp.BF16_REPS,
                                                    hp.BF16_STEPS), peak,
                             mufu=pf.bf16_mufu(rays, hp.BF16_REPS,
                                               hp.BF16_STEPS))
              for v in hp.BF16_VARIANTS}
    rows.append(row(
        "bf16_probe", 116, out["ms"]["map"],
        checks["bf16_probe"]["plain_ms"]["bf16 map"], bounds["map"],
        ms_by_variant=out["ms"], bound_ms_by_variant=bounds,
        reps_ratio=out["reps_ratio"],
        speedup_vs_f32={r["variant"]: r["speedup_vs_f32"]
                        for r in out["rows"] if "speedup_vs_f32" in r},
        state="redesigned: packed __nv_bfloat162 reps, "
              "sqrt.approx.f32 roots",
        roots=checks["bf16_probe"]["roots"], **bf16_extra))

    # Every rep computes the same t_min, so the bound (both kernels') is one
    # rep's work and the reps' adds; repeating the rep is the probe's
    # method, printed as the work it does.
    out = runs["mxu_transform_probe"][1]
    rays = mxu.TILES * hp.MXU_H * hp.LANES
    need = pf.mxu_ops(rays, hp.MXU_SHAPES, hp.MXU_REPS)
    done = hp.MXU_REPS * pf.mxu_ops(rays, hp.MXU_SHAPES, 1)
    bound = pf.bound_ms(28 * rays + mxu.TILES * hp.MXU_ROWS * 16, need, peak,
                        mufu=pf.mxu_mufu(rays, hp.MXU_SHAPES))
    print(f"mxu_transform_probe: bound {bound[0]:.6f} ms ({bound[1]}) for "
          f"{need:.4e} FP32 ops; its {hp.MXU_REPS} reps do {done:.4e}, "
          f"{done / need:.2f}x")
    rows.append(row(
        "mxu_transform_probe", 107, out["ms"]["tensor"],
        checks["mxu_transform_probe"]["plain_ms"]["mxu tensor"], bound,
        ops_done=done,
        scalar_ms=out["ms"]["scalar"],
        scalar_plain_ms=checks["mxu_transform_probe"]["plain_ms"][
            "mxu scalar"],
        speedup_vs_scalar=out["ms"]["scalar"] / out["ms"]["tensor"],
        reps_ratio=out["reps_ratio"],
        hit_flip_share=out["rows"][1]["hit_flip_share"], **mxu_extra))
    return rows


# The wavefront and gradient probes (kernels/wavefront.py,
# kernels/grad_probes.py).  The fused-bwd kernel sums its pixels' loss
# terms in float64 and rounds once; the plain version sums in float32 over
# at most 2,073,600 positive terms, within about (64 + 21) 2**-24 = 5.1e-6
# of the exact sum (a thread's serial run, then the tree), and both shade
# every pixel alike (K3's exact march is its plain version's ray for ray).
FB_LOSS_TOL = 1e-5
# segsum adds TF32 products (each cotangent split in two terms) in float32 in
# a fixed order: within 1e-5 of max |ref| of a float64 sum, the JAX probe's
# own bound, and the same bit for bit from launch to launch.
SEGSUM_TOL = 1e-5


def _counts_zero(*counts):
    for c in counts:
        for k in c:
            c[k] = 0


def _walked_frames(fw, wf, sspec, sparams, sort_rays, **kw):
    """One wavefront frame through the kernel and one through its plain
    version (on the card), each bounce passed a zeroed ``walk_stats``;
    returns (kernel frame, plain frame, the kernel's (summed length, lists)
    per bounce, the plain model's)."""
    import torch

    orig, rows = wf.wavefront_bounce, {"kernel": [], "plain": []}

    def walked(label, fn):
        def bounce(prog, table, k, ray, rng):
            ws = torch.zeros(2, dtype=torch.int64, device=ray.device)
            rows[label].append(ws)
            return fn(prog, table, k, ray, rng, walk_stats=ws)
        return bounce

    try:
        frames = []
        for label, fn in (("kernel", orig), ("plain", wf.wavefront_bounce_plain)):
            wf.wavefront_bounce = walked(label, fn)
            frames.append(fw.render_frame_wavefront(
                sspec, sparams, sort_rays=sort_rays, **kw))
    finally:
        wf.wavefront_bounce = orig
    return (*frames, *(torch.stack(rows[k]).tolist()
                       for k in ("kernel", "plain")))


def _wavefront_phase(fw, wf, pf, spec, sp, checked, all_counts, peak, gpu,
                     ptxas):
    """The wavefront bounce kernel's main path, the port's
    benchmarks/frozen_wavefront.py, after its checks (``checked``,
    ``_job_wavefront``'s result: at CHECK_W x CHECK_H and at 1080p, with the
    plain frame's count of the work).  Returns its kernels-line row."""
    import torch

    from compute_path_tracer_tpu_torch.render.program import build_program

    count, plain_ms = checked["count"], checked["plain_ms"]
    prog = build_program(spec, "faithful")
    ops, n_bytes = pf.wavefront_work(count, prog)
    bound = pf.bound_ms(n_bytes, ops, peak)
    _counts_zero(*all_counts)
    out = fw.measure()
    torch.cuda.synchronize()
    launches = wf.LAUNCHES["wavefront_bounce"]
    others = [k for c in all_counts for k, v in c.items()
              if v and k not in ("wavefront_bounce", "megakernel_march")]
    if not launches or others:
        raise AssertionError(f"frozen_wavefront launched {launches} bounces; "
                             f"others {others}")
    wave, srt = out["rows"]["wavefront"], out["rows"]["wavefront sorted"]
    print(f"main path frozen_wavefront, {MAIN_W}x{MAIN_H}, {N_PRIMS} prims, "
          f"{BOUNCES} bounces: " + json.dumps(out) + f"; launches {launches}; "
          f"plain frame {plain_ms:.1f} ms while counting {int(count['taps'])} "
          f"taps; bound {bound[0]:.4f} ms ({bound[1]}: {ops:.4e} FP32 ops, "
          f"{n_bytes:.4e} bytes) [{gpu}]")
    k2 = out["rows"]["K2 faithful exact"]
    return {"name": "wavefront_bounce", "route": "cuda",
            "source": "compute_path_tracer_tpu_torch/kernels/csrc/wavefront.cu",
            "replaces": "benchmarks/frozen_wavefront.py:182",
            "launches": launches, "max_abs_err": checked["err"],
            "main_shape_share_off": checked["share"],
            "ms": wave["bounce_kernels_ms"],
            "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": None,
            "state": "redesigned, PR 16 (K2's per-warp walk of the staged "
                     "program, persistent blocks)",
            "ms_per_frame": wave["ms_per_frame"],
            "glue_ms": wave["glue_ms"],
            "alive_per_bounce": wave["alive_per_bounce"],
            "mean_list_per_bounce": wave["mean_list_per_bounce"],
            "sorted_ms_per_frame": srt["ms_per_frame"],
            "sorted_bounce_kernels_ms": srt["bounce_kernels_ms"],
            "sorted_mean_list_per_bounce": srt["mean_list_per_bounce"],
            "k2_faithful_ms_per_frame": k2["ms_per_frame"],
            "k2_mean_list_per_bounce": k2["mean_list_per_bounce"],
            "ptxas": ptxas["wavefront_bounce"]}


def _grad_probe_phase(gp, pf, fbm, sgm, spec, sp, all_counts, peak, gpu,
                      ptxas, seg_sass):
    """fused_bwd at the probe's tile and over the 1080p frame, and segsum at
    the probe's shape, K4's (ids uniform and clustered; two launches bit for
    bit), S = 130 and C = 28 at two ragged n, and with non-finite
    cotangents, against their plain versions; then each measurement
    script's measure() as its main path.  Returns their kernels-line
    rows."""
    import torch

    from compute_path_tracer_tpu_torch.render.baked import bake

    with torch.no_grad():
        bv = bake(spec, sp)
    fb = {}
    for label, rect in (("tile", gp.TILE_RECT), ("frame", gp.FRAME_RECT)):
        before = gp.LAUNCHES["fused_bwd"]
        ws = torch.zeros(2, dtype=torch.int64, device=sp.device)
        loss, grad = gp.fused_bwd(spec, sp, bv, rect, walk_stats=ws)
        # The plain model of the lists at the tile only: no 1080p pass more.
        pws = (torch.zeros(2, dtype=torch.int64, device=sp.device)
               if label == "tile" else None)
        (p_loss, p_grad), ms = _plain_timed(
            lambda r=rect: gp.fused_bwd_plain(spec, sp, bv, r, pws))
        if gp.LAUNCHES["fused_bwd"] - before != 1:
            raise AssertionError(f"fused_bwd {label} did not launch once")
        rel = abs(float(loss[0]) - float(p_loss[0])) / abs(float(p_loss[0]))
        zero = all(bool(torch.isfinite(g).all()) and not bool(g.any())
                   for g in (grad, p_grad))
        lists = ws.tolist()
        fb[label] = dict(loss=float(loss[0]), plain_loss=float(p_loss[0]),
                         rel=rel, plain_ms=ms, walk_stats=lists,
                         mean_list=lists[0] / lists[1])
        print(f"check fused_bwd {label} {rect}: loss {float(loss[0]):.6f}, "
              f"plain {float(p_loss[0]):.6f}, relative diff {rel:.3e} (limit "
              f"{FB_LOSS_TOL}); gradients of {grad.shape[0]} slots all zero "
              f"and finite: {zero}; walk_stats {lists} (mean list "
              f"{lists[0] / lists[1]:.3f} records)"
              + (f", plain model {pws.tolist()}" if pws is not None else "")
              + f"; plain {ms:.1f} ms")
        if rel > FB_LOSS_TOL or not zero or p_grad.shape != grad.shape \
                or (pws is not None and lists != pws.tolist()):
            raise AssertionError(f"fused_bwd {label}")
    prog, table = gp.fused_bwd_tables(spec, sp, bv)
    _, ro, rd = gp.fused_bwd_rays(gp.FRAME_RECT, sp.device)
    fb_bound = pf.bound_ms(4 * prog.f_len + 8 + 4 * bv.shape[0],
                           pf.fused_bwd_ops(prog, table, ro, rd), peak)
    del ro, rd
    seg = {}
    k4 = sgm.k4_shape()
    ragged = dict(n_b=3, n_seg=130, n_ch=28, h=1)
    for label, shape, clustered in (
            ("probe", sgm.PROBE, False), ("K4", k4, False),
            ("K4 clustered", k4, True), ("S 130 C 28 n 12347",
                                         dict(ragged, w=12347), False),
            ("S 130 C 28 n 12344", dict(ragged, w=12344), False)):
        idx, cot = (sgm.inputs_clustered if clustered else sgm.inputs)(
            shape, sp.device)
        before = gp.LAUNCHES["segsum"]
        got = gp.segsum(idx, cot, shape["n_seg"])
        ref = gp.segsum_plain(idx, cot.double(), shape["n_seg"])
        _, ms = _plain_timed(lambda: gp.segsum_plain(idx, cot,
                                                     shape["n_seg"]))
        if gp.LAUNCHES["segsum"] - before != 1:
            raise AssertionError(f"segsum {label} did not launch once")
        again = (bool(torch.equal(got, gp.segsum(idx, cot, shape["n_seg"])))
                 if label == "K4" else None)
        err = float((got.double() - ref).abs().max())
        rel = err / float(ref.abs().max())
        seg[label] = dict(err=err, rel=rel, plain_ms=ms, bound=pf.bound_ms(
            pf.segsum_bytes(shape["n_b"], shape["h"] * shape["w"],
                            shape["n_ch"], shape["n_seg"]), 0.0, peak),
            plan=gp.segsum_plan(shape["n_b"], shape["h"] * shape["w"],
                                shape["n_seg"], shape["n_ch"],
                                gp.sm_count(sp.device))._asdict())
        print(f"check segsum {label} {shape}: max |diff| {err:.3e}, of max "
              f"|ref| {rel:.3e} (limit {SEGSUM_TOL}); plain {ms:.2f} ms; "
              f"plan {seg[label]['plan']}"
              + (f"; a second launch bit for bit the first: {again}"
                 if again is not None else ""))
        if rel > SEGSUM_TOL or not bool(torch.isfinite(got).all()) \
                or again is False:
            raise AssertionError(f"segsum {label}")
        del idx, cot, got, ref
    seg_nonfinite = _segsum_nonfinite(gp, sp.device)
    runs = {}
    for name, mod, key, allowed in (
            ("probe_fused_bwd", fbm, "fused_bwd", ("train_fused",)),
            ("probe_inkernel_segsum", sgm, "segsum", ())):
        _counts_zero(*all_counts)
        out = mod.measure()
        torch.cuda.synchronize()
        others = [k for c in all_counts for k, v in c.items()
                  if v and k != key and k not in allowed]
        if not gp.LAUNCHES[key] or others:
            raise AssertionError(f"{name} launched {gp.LAUNCHES[key]}; "
                                 f"others {others}")
        runs[name] = (gp.LAUNCHES[key], out)
        print(f"main path {name}: " + json.dumps(out) + f"; launches "
              f"{gp.LAUNCHES[key]} [{gpu}]")
    fbo = runs["probe_fused_bwd"][1]
    sgo = runs["probe_inkernel_segsum"][1]["rows"]
    csrc = "compute_path_tracer_tpu_torch/kernels/csrc/grad_probes.cu"
    return [
        {"name": "fused_bwd", "route": "cuda", "source": csrc,
         "replaces": "benchmarks/probe_fused_bwd.py:87",
         "launches": runs["probe_fused_bwd"][0],
         "max_abs_err": max(abs(r["loss"] - r["plain_loss"])
                            for r in fb.values()),
         "loss_rel_diff": {k: r["rel"] for k, r in fb.items()},
         "ms": fbo["rows"]["frame"], "plain_ms": fb["frame"]["plain_ms"],
         "bound_ms": fb_bound[0], "bound_by": fb_bound[1],
         "library_ms": None, "tile_ms": fbo["rows"]["tile"],
         "tile_plain_ms": fb["tile"]["plain_ms"],
         "k4_bounce_ms": fbo["rows"]["K4 per bounce"],
         "state": "redesigned, PR 17 (K3's per-warp walk of the staged "
                  "program)",
         "mean_list": {k: r["mean_list"] for k, r in fb.items()},
         "walk_stats": {k: r["walk_stats"] for k, r in fb.items()},
         "ptxas": ptxas["fused_bwd"],
         "summary": fbo["summary"]},
        {"name": "segsum", "route": "cuda", "source": csrc,
         "replaces": "benchmarks/probe_inkernel_segsum.py:55",
         "launches": runs["probe_inkernel_segsum"][0],
         "max_abs_err": max(r["err"] for r in seg.values()),
         "max_err_of_max_ref": {k: r["rel"] for k, r in seg.items()},
         "ms": sgo["K4"]["ms"], "plain_ms": seg["K4"]["plain_ms"],
         "bound_ms": seg["K4"]["bound"][0], "bound_by": seg["K4"]["bound"][1],
         "library_ms": sgo["K4"]["index_add_ms"],
         "state": "redesigned, PR 19 (one-hot TF32 products on the tensor "
                  "cores, mma.sync, a fixed-order reduce, no global atomics)",
         "probe_shape": {"ms": sgo["probe"]["ms"],
                         "plain_ms": seg["probe"]["plain_ms"],
                         "bound_ms": seg["probe"]["bound"][0],
                         "library_ms": sgo["probe"]["index_add_ms"]},
         "k4_clustered": {"ms": sgo["K4 clustered"]["ms"],
                          "plain_ms": seg["K4 clustered"]["plain_ms"],
                          "library_ms": sgo["K4 clustered"]["index_add_ms"]},
         "plans": {k: r["plan"] for k, r in seg.items()},
         "nonfinite": seg_nonfinite,
         "ptxas": {k: v for k, v in ptxas.items() if "segsum" in k},
         "sass": seg_sass}]


def _short(name):
    """A walk kernel's mangled name as ``kernel<template args>`` (a kernel
    that is no template: its name); None for another kernel."""
    import re

    m = re.search(r"\d+(megakernel_walk|megakernel_grid|megakernel_stats|"
                  r"march_rays|train_fused)(?:I(.+?)EEv|E)", name)
    if m is None:
        return None
    args = re.findall(r"L[bi](\d+)", m.group(2) or "")
    return f"{m.group(1)}<{','.join(args)}>" if args else m.group(1)


def _ptxas_walk(build):
    """ptxas's figures of the walk kernels (K2's megakernel_walk<BAKED,
    TCULL, MARCH, EXACT>: MARCH 0 the plain march, 1 RELAX, 2 the
    refresh_every window; debug 4's megakernel_stats<BAKED, TCULL, EXACT>,
    K6's megakernel_grid<STATS, EXACT>, K3's march_rays, K4's
    train_fused), printed; returns them by short name."""
    figs = {_short(k): v for k, v in build.ptxas_figures().items()
            if _short(k)}
    for k, v in sorted(figs.items()):
        print(f"ptxas {k}: {v['registers']} registers, {v.get('stack', 0)} "
              f"bytes stack frame, {v.get('spill_stores', 0)} bytes spill "
              f"stores, {v.get('spill_loads', 0)} bytes spill loads")
    if len(figs) != 37:
        raise AssertionError(f"ptxas figures of {len(figs)} walk kernels, "
                             f"expected 37")
    return figs


def _ptxas_k1(build):
    """ptxas's figures of K1's instantiations (megakernel_analytic<STATS,
    REFILL>), printed; returns them by short name."""
    import re

    figs = {}
    for k, v in build.ptxas_figures().items():
        m = re.search(r"megakernel_analyticILb(\d)ELb(\d)E", k)
        if m:
            figs[f"megakernel_analytic<{m.group(1)},{m.group(2)}>"] = v
    for k, v in sorted(figs.items()):
        print(f"ptxas {k}: {v['registers']} registers, {v.get('stack', 0)} "
              f"bytes stack frame, {v.get('spill_stores', 0)} bytes spill "
              f"stores, {v.get('spill_loads', 0)} bytes spill loads")
    if len(figs) != 3:
        raise AssertionError(f"ptxas figures of {len(figs)} K1 kernels, "
                             f"expected 3")
    return figs


def _ptxas_probes(build):
    """ptxas's figures of the bf16 march (bf16_march<V>), the dense and ILP
    probes (march_dense, march_ilp_seq, march_ilp_fused), the wavefront's
    bounce (wavefront_bounce), the box transforms (mxu_scalar, mxu_tensor),
    fused-bwd (fused_bwd) and the segment sum (segsum<MT, TS>,
    segsum_reduce), printed; returns them by short name."""
    import re

    figs = {}
    for k, v in build.ptxas_figures().items():
        m = re.search(r"bf16_marchILi(\d)E", k)
        if m:
            figs[f"bf16_march<{m.group(1)}>"] = v
        m = re.search(r"segsumILi(\d)ELi(\d)E|(segsum_reduce)", k)
        if m:
            figs[m.group(3) or f"segsum<{m.group(1)},{m.group(2)}>"] = v
        for name in ("march_dense", "march_capped", "march_ilp_seq",
                     "march_ilp_fused", "wavefront_bounce", "mxu_scalar",
                     "mxu_tensor", "fused_bwd"):
            if name in k:
                figs[name] = v
    for k, v in sorted(figs.items()):
        print(f"ptxas {k}: {v['registers']} registers, {v.get('stack', 0)} "
              f"bytes stack frame, {v.get('spill_stores', 0)} bytes spill "
              f"stores, {v.get('spill_loads', 0)} bytes spill loads")
    if len(figs) != 16:
        raise AssertionError(f"ptxas figures of {len(figs)} probe kernels, "
                             f"expected 16")
    return figs


# The bf16 march's instructions counted in its SASS (opcode stems).
BF16_OPCODES = ("HADD2", "HMUL2", "HFMA2", "HMNMX2", "MUFU", "F2FP", "FADD",
                "FMUL", "FSETP", "FSEL", "LDS")


def _contracted(ins):
    """Whether an HFMA2 both multiplies and adds: no multiplier operand is
    zero or an immediate 1, and its addend is not zero."""
    import re

    ops = [t.strip() for t in ins.partition(" ")[2].split(",")][1:]
    add, mul = ops[-1], ops[:-1]

    def zero(t):
        return re.match(r"-?RZ\b", t) or re.fullmatch(r"-?0(\.0*)?", t)

    def one(t):
        return re.fullmatch(r"1(\.0*)?", t)

    imm = [t for t in mul if re.fullmatch(r"-?[0-9][0-9.e+-]*", t)]
    return not (zero(add) or any(zero(t) for t in mul)
                or (imm and all(one(t) for t in imm)))


def _bf16_sass(sass):
    """The packed bf16 march kernels' SASS (bf16_march<1|2>): counts of the
    instructions in BF16_OPCODES, printed with each distinct HFMA2 form;
    raises where an HFMA2 contracts a multiply and an add, which would
    round once where the probe rounds twice."""
    import re

    out = {}
    for name, code in sass.items():
        m = re.search(r"bf16_marchILi([12])E", name)
        if not m:
            continue
        key = f"bf16_march<{m.group(1)}>"
        ops = [i.split()[0].split(".")[0] for i in code]
        out[key] = {o: ops.count(o) for o in BF16_OPCODES}
        hfma = sorted({re.sub(r"R\d+", "R", i) for i in code
                       if i.startswith("HFMA2")})
        bad = [i for i in code if i.startswith("HFMA2") and _contracted(i)]
        print(f"SASS {key}: {out[key]}; HFMA2 forms {hfma}")
        if bad:
            raise AssertionError(f"{key}: contracted HFMA2 {bad[:4]}")
    if len(out) != 2:
        raise AssertionError(f"SASS of {len(out)} bf16 march kernels")
    return out


# The box transforms' instructions counted in their SASS (opcode stems).
MXU_OPCODES = ("HGMMA", "WARPGROUP", "LDS", "STS", "MUFU", "SHFL", "BAR")


def _mxu_sass(sass):
    """The box transforms' SASS (mxu_scalar, mxu_tensor): counts of the
    instructions in MXU_OPCODES, printed; raises unless mxu_tensor issues
    the 12 HGMMA (wgmma.mma_async) of a rep, six a half."""
    out = {}
    for name, code in sass.items():
        for key in ("mxu_scalar", "mxu_tensor"):
            if key in name:
                ops = [i.split()[0].split(".")[0] for i in code]
                out[key] = {o: ops.count(o) for o in MXU_OPCODES}
                print(f"SASS {key}: {out[key]}")
    if len(out) != 2 or out["mxu_tensor"]["HGMMA"] < 12:
        raise AssertionError(f"SASS of the box transforms: {out}")
    return out


# The gather kernels' instructions counted in their SASS (opcode stems,
# FADD.RZ whole).
GATHER_OPCODES = ("LDS", "FADD", "FADD.RZ", "F2I", "LEA", "LOP3", "MUFU",
                  "CALL")


def _gather_sass(sass):
    """The gather kernels' SASS (gather_chain_smem, gather_chain_ldg,
    gather_arith): counts of the instructions in GATHER_OPCODES, printed;
    raises unless gather_arith takes its 12 roots as MUFU with no call to
    a slow path, and each shared-memory chain has its FADD.RZ form."""
    import re

    out = {}
    for name, code in sass.items():
        m = re.search(r"(gather_chain_smem|gather_chain_ldg)ILi(\d+)E(?:Li(\d+)E)?"
                      r"|(gather_arith)", name)
        if not m:
            continue
        key = (m.group(4) or f"{m.group(1)}<{m.group(2)}"
               + (f",{m.group(3)}>" if m.group(3) else ">"))
        ops = [re.sub(r"^@!?U?P\w+\s+", "", i).split()[0] for i in code]
        out[key] = {o: sum(1 for op in ops if op == o or (
            o != "FADD.RZ" and op.split(".")[0] == o)) for o in GATHER_OPCODES}
        print(f"SASS {key}: {out[key]}")
    smem = [k for k in out if k.startswith("gather_chain_smem")]
    arith = out.get("gather_arith", {})
    if (len(smem) != 2 or any(out[k]["FADD.RZ"] < 1 for k in smem)
            or arith.get("CALL", 1) or arith.get("MUFU", 0) < 12):
        raise AssertionError(f"SASS of the gather kernels: {out}")
    return out


def _segsum_sass(sass):
    """The segment sum's SASS (segsum<MT, TS>, segsum_reduce): counts of its
    tensor-core products (HMMA), atomics (ATOM*, RED*), copies (LDGSTS) and
    barriers (BAR), by whole opcode, printed; raises unless each segsum<MT,
    TS> issues HMMA.1688.F32.TF32 (mma.sync TF32) and no kernel of the sum
    issues an atomic other than a shared-memory one (ATOMS), the scalar
    path's."""
    import re

    out = {}
    for name, code in sass.items():
        m = re.search(r"segsumILi(\d)ELi(\d)E|(segsum_reduce)", name)
        if not m:
            continue
        key = m.group(3) or f"segsum<{m.group(1)},{m.group(2)}>"
        ops = [re.sub(r"^@!?U?P\w+\s+", "", i).split()[0] for i in code]
        out[key] = {o: ops.count(o) for o in sorted(set(ops))
                    if re.match(r"HMMA|ATOM|RED|LDGSTS|BAR", o)}
        print(f"SASS {key}: {out[key]}")
    sums = [k for k in out if k.startswith("segsum<")]
    far = [o for v in out.values() for o in v
           if o.startswith("RED") or (o.startswith("ATOM")
                                      and not o.startswith("ATOMS"))]
    if (len(sums) != 4 or "segsum_reduce" not in out or far
            or any(out[k].get("HMMA.1688.F32.TF32", 0) < 64 for k in sums)
            or any(o.startswith("ATOM") for o in out["segsum_reduce"])):
        raise AssertionError(f"SASS of the segment sum: {out}")
    return out


def _segsum_nonfinite(gp, dev):
    """The segment sum with NaN and +-inf on dropped and kept lanes, and
    with two cotangents past TF32's overflow on kept lanes: its non-finite
    entries must be the plain version's (NaN for NaN, each infinity with its
    sign), its finite ones within SEGSUM_TOL of a float64 sum (of max |ref|;
    past the overflow, of each entry)."""
    import numpy as np
    import torch

    r = np.random.default_rng(11)
    idx = r.integers(-1, 64, size=(2, 3000)).astype(np.int32)
    cot = r.normal(size=(2, 13, 3000)).astype(np.float32)
    bad = (np.nan, np.inf, -np.inf)
    drop, keep = np.argwhere(idx < 0), np.argwhere(idx >= 0)
    for k, (b, i) in enumerate(drop[:6]):
        cot[b, k % 13, i] = bad[k % 3]
    for k, (b, i) in enumerate(keep[:6]):
        cot[b, (3 * k) % 13, i] = bad[k % 3]
    rows = {}
    for label, big in (("NaN and inf", ()),
                       ("past the TF32 overflow", (np.finfo(np.float32).max,
                                                   -3.39e38))):
        c = cot.copy()
        for (b, i), v in zip(keep[6:], big):
            c[b, 2, i] = v
        it, ct = torch.from_numpy(idx).to(dev), torch.from_numpy(c).to(dev)
        got = gp.segsum(it, ct, 64)
        plain = gp.segsum_plain(it, ct, 64)
        ref = gp.segsum_plain(it, ct.double(), 64)
        same = all(bool(torch.equal(f(got), f(plain))) for f in
                   (torch.isnan, torch.isposinf, torch.isneginf))
        fin = torch.isfinite(plain)
        diff = (got.double() - ref)[fin].abs()
        rel = float((diff / torch.clamp(ref[fin].abs(), min=1.0)).max()
                    if big else diff.max() / ref[fin].abs().max())
        rows[label] = dict(nonfinite_equal=same, rel=rel,
                           nonfinite=int((~fin).sum()))
        print(f"check segsum {label} on kept and dropped lanes: non-finite "
              f"entries ({int((~fin).sum())}) the plain version's: {same}; "
              f"finite entries within {rel:.3e} (limit {SEGSUM_TOL})")
        if not same or rel > SEGSUM_TOL:
            raise AssertionError(f"segsum {label}")
    return rows


def _bf16_root_check(hp, dev):
    """The bf16 march's root (root2: sqrt.approx.f32, rounded) of every bf16
    bit pattern below 0x8000 on the card, against the card's IEEE root and
    the plain correctly rounded one: the same bits for zero, the finite
    values and infinity, a NaN for each NaN."""
    import torch

    got = hp.bf16_roots(dev).cpu()
    want = hp.bf16_roots_plain()
    n_exact = 0x7F81  # 0x0000-0x7F80: zero, the finite values, infinity
    same = [bool(torch.equal(got[k, :n_exact], want[0, :n_exact]))
            for k in range(2)]
    nan = bool(torch.isnan(got[:, n_exact:].view(torch.bfloat16)).all())
    print(f"check bf16 roots of {hp.BF16_PATTERNS} bit patterns: approximate "
          f"= correctly rounded {same[0]}, IEEE = correctly rounded "
          f"{same[1]}, NaN to NaN {nan}")
    if not (all(same) and nan):
        diff = torch.nonzero(got[0, :n_exact] != want[0, :n_exact]).flatten()
        raise AssertionError(f"bf16 roots differ at {diff[:8].tolist()}")
    return {"patterns": hp.BF16_PATTERNS, "exact": n_exact,
            "approx_equal": same[0], "ieee_equal": same[1]}


_PHASE = {}


def _stamp(start, phase):
    """Prints the seconds since ``start`` as ``phase`` begins, and the
    seconds the phase before it took: the script must end well inside its
    time limit."""
    now = time.perf_counter() - start
    last = _PHASE.get("name")
    took = f" ({last}: {now - _PHASE['at']:.1f} s)" if last else ""
    _PHASE.update(name=phase, at=now)
    print(f"[{now:.1f} s] {phase}{took}", flush=True)


def _medians_abba(a, b, reps=10):
    """A B B A in one process: each of the four runs times ``reps``
    launches one by one with CUDA events after a warm-up and takes their
    median; returns (A's two medians, B's two medians) in ms."""
    import torch

    def run(fn):
        fn()
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        for e0, e1 in ev:
            e0.record()
            fn()
            e1.record()
        torch.cuda.synchronize()
        ms = sorted(e0.elapsed_time(e1) for e0, e1 in ev)
        return (ms[(reps - 1) // 2] + ms[reps // 2]) / 2

    a1, b1, b2, a2 = run(a), run(b), run(b), run(a)
    return (a1, a2), (b1, b2)


def _moved(a, b):
    """Share of pixels off by more than MOVED_TOL and by more than
    DIFF_TOL between two frames."""
    d = (a - b).abs().amax(dim=-1)
    return float((d > MOVED_TOL).float().mean()), float((d > DIFF_TOL).float().mean())


def _exact_refresh_phase(mk, pf, spec, sp, prog, table, grid, peak,
                         frame_bytes, checks, gpu):
    """The main paths of K2's exact normal and frozen activation window
    (RenderSession at MAIN_W x MAIN_H, the counts set to 0 just before and
    read just after), their kernel times A B B A against the 6-tap normal
    and K = 1 (K6 and debug 1 as well), the share of pixels each moves and
    their bounds from the plain passes' counts (a check worker's job).
    Returns the two rows of the kernels line."""
    import torch

    from compute_path_tracer_tpu_torch.app.config import Settings
    from compute_path_tracer_tpu_torch.constants import DEFAULT_FOV
    from compute_path_tracer_tpu_torch.render.session import RenderSession
    from compute_path_tracer_tpu_torch.scene import benchmark_scene

    launches = {}
    for key, mode, label in (("exact", dict(MARCH, **EXACT),
                              "K2 normals=autodiff (baked, t_cull)"),
                             ("refresh", dict(MARCH, refresh_every=4),
                              "K2 refresh_every 4 (baked, t_cull)")):
        sess = RenderSession(benchmark_scene(N_PRIMS), MAIN_W, MAIN_H,
                             Settings(debug=0, bounces=BOUNCES),
                             frame_fn=partial(mk.render_frame_megakernel,
                                              **mode), device=sp.device)
        launches[key] = _drive_session(mk, "megakernel_march", sess, label,
                                       gpu)
        del sess
    run = dict(frame=1, last_clear=1, bounces=BOUNCES, fov=DEFAULT_FOV,
               aspect=MAIN_W / MAIN_H, t_cull=True)
    scratch = torch.zeros((MAIN_H, MAIN_W, 3), device=sp.device)

    def k2(**kw):
        return lambda: mk.launch_march(prog, table, scratch, **run, **kw)

    def frame0(**kw):
        acc = torch.zeros_like(scratch)
        mk.launch_march(prog, table, acc, **dict(run, frame=0, last_clear=0),
                        **kw)
        return acc

    times, moved = {}, {}
    for name, a_kw, b_kw in (
            ("K2 debug 0", dict(debug=0), dict(debug=0, **EXACT)),
            ("K2 debug 1", dict(debug=1), dict(debug=1, **EXACT)),
            ("K6 debug 0", dict(debug=0, grid=grid),
             dict(debug=0, grid=grid, **EXACT))):
        times[name] = _medians_abba(k2(**a_kw), k2(**b_kw))
        moved[name] = _moved(frame0(**a_kw), frame0(**b_kw))
    for k in REFRESH_KS:
        name = f"K2 refresh_every {k}"
        times[name] = _medians_abba(k2(debug=0), k2(debug=0, refresh_every=k))
        moved[name] = _moved(frame0(debug=0), frame0(debug=0, refresh_every=k))
    torch.cuda.synchronize()
    for name, (a, b) in times.items():
        print(f"A B B A {name} at {MAIN_W}x{MAIN_H}, {BOUNCES} bounces, "
              f"medians of 10: A (6-tap normal / K=1) {a[0]:.3f}, {a[1]:.3f} "
              f"ms, B {b[0]:.3f}, {b[1]:.3f} ms, B/A "
              f"{(b[0] + b[1]) / (a[0] + a[1]):.4f}; pixels moved in frame 0: "
              f"{moved[name][0]:.6f} by > {MOVED_TOL}, {moved[name][1]:.6f} by "
              f"> {DIFF_TOL} [{gpu}]")
    rows = {}
    for key, name, ms_name in (("exact", "megakernel_march (normals=autodiff)",
                                "K2 debug 0"),
                               ("refresh", "megakernel_march (refresh_every)",
                                "K2 refresh_every 4")):
        m = checks["k2 exact and refresh 1080p"][key]
        bound, by = pf.bound_ms(frame_bytes + 4 * prog.f_len,
                                pf.march_ops(m["count"], prog), peak)
        b = times[ms_name][1]
        rows[key] = {"name": name, "launches": launches[key],
                     "max_abs_err": m["err"],
                     "main_shape_share_off": m["share"],
                     "ms": (b[0] + b[1]) / 2, "plain_ms": m["plain_ms"],
                     "bound_ms": bound, "bound_by": by, "library_ms": None}
        print(f"{name} at {MAIN_W}x{MAIN_H}: kernel {rows[key]['ms']:.3f} ms, "
              f"plain torch frame {m['plain_ms']:.3f} ms while counting, "
              f"bound {bound:.4f} ms ({by}); work "
              f"{m['count']['segments']} segments, {m['count']['taps']} map "
              f"taps, {m['count'].get('grad_taps', 0)} exact-normal walks "
              f"[{gpu}]")
    rows["exact"]["ab_ms"] = {k: times[k] for k in
                              ("K2 debug 0", "K2 debug 1", "K6 debug 0")}
    rows["exact"]["moved"] = {k: moved[k] for k in
                              ("K2 debug 0", "K2 debug 1", "K6 debug 0")}
    rows["refresh"]["ab_ms"] = {k: times[f"K2 refresh_every {k}"]
                                for k in REFRESH_KS}
    rows["refresh"]["moved"] = {k: moved[f"K2 refresh_every {k}"]
                                for k in REFRESH_KS}
    return rows


def _png_export_phase(img, gpu):
    """save_png's two codecs on one frame (``img``, (H, W, 3) float32 on the
    host): the native library of io/native.py (its first build timed) and
    the plain Python one, A B B A, medians of 5 each; their RGBA8 bytes
    must be equal and their PNGs must inflate to the same scanlines."""
    import statistics
    import zlib

    import numpy as np

    from compute_path_tracer_tpu_torch.io import native
    from compute_path_tracer_tpu_torch.io.png import (
        encode_png_rgba, hdr_to_rgba8)

    t0 = time.perf_counter()
    if not native.available():
        print("png export: the native library cannot be built here; "
              "save_png takes the plain codec")
        return
    build_s = time.perf_counter() - t0

    def run(fn):
        ms = []
        for _ in range(5):
            t = time.perf_counter()
            out = fn()
            ms.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ms), out

    def plain():
        return encode_png_rgba(hdr_to_rgba8(img))

    def fast():
        return native.encode_png_rgba_native(native.hdr_to_rgba8_native(img))

    (a1, pa), (b1, pb), (b2, _), (a2, _) = (run(plain), run(fast), run(fast),
                                            run(plain))
    rgba = hdr_to_rgba8(img)
    if not np.array_equal(native.hdr_to_rgba8_native(img), rgba):
        raise AssertionError("the native HDR to RGBA8 differs from the plain")
    h, w = rgba.shape[:2]
    lines = np.concatenate([np.zeros((h, 1), np.uint8),
                            rgba.reshape(h, w * 4)], axis=1).tobytes()
    for name, data in (("plain", pa), ("native", pb)):
        # One IDAT chunk after the signature and IHDR (33 bytes), filter 0.
        n = int.from_bytes(data[33:37], "big")
        if data[37:41] != b"IDAT" or zlib.decompress(data[41:41 + n]) != lines:
            raise AssertionError(f"the {name} PNG is not the frame's RGBA8")
    print(f"png export of a {w}x{h} frame (save_png's two codecs on the "
          f"host, A B B A, medians of 5): plain {a1:.1f}, {a2:.1f} ms, "
          f"native {b1:.1f}, {b2:.1f} ms, native/plain "
          f"{(b1 + b2) / (a1 + a2):.3f}; {len(pa)} and {len(pb)} bytes, "
          f"{'the same' if pa == pb else 'different'} files; first "
          f"available() (the g++ build) {build_s:.2f} s [{gpu}]")


def _walk_means(stats):
    """Mean list length per row of a list of (summed length, lists) rows;
    0 where no list was built."""
    return [a / b if b else 0.0 for a, b in stats]


def _compare(name, kernel_img, plain_img, limit=SHARE_LIMIT, exact=False):
    """Share of pixels off by > DIFF_TOL and the max |diff|; raises on a
    breach, on non-finite values, or, with ``exact``, unless the images are
    equal bit for bit."""
    import torch

    if not (torch.isfinite(kernel_img).all() and torch.isfinite(plain_img).all()):
        raise AssertionError(f"{name}: non-finite values")
    d = (kernel_img - plain_img).abs().amax(dim=-1)
    share, err = float((d > DIFF_TOL).float().mean()), float(d.max())
    n_off = int((d > 0).sum())
    print(f"check {name}: share of pixels off by > {DIFF_TOL}: {share:.6f} "
          f"(limit {'bit-equal' if exact else limit}), pixels not bit-equal "
          f"{n_off}, max abs diff {err:.3e}, mean {float(kernel_img.mean()):.5f}")
    if share > limit or (exact and n_off):
        raise AssertionError(f"{name}: {share} of pixels differ by > "
                             f"{DIFF_TOL}, {n_off} at all")
    return share, err


def _check_cases(mk, key, cases):
    """Kernel against plain at CHECK_W x CHECK_H, bit for bit (the plain
    versions on the card round as the kernels do); each case must launch
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
        max_err = max(max_err, _compare(name, k, p, limit, exact=True)[1])
    return max_err


def _drive_session(mk, key, sess, label, gpu, prims=N_PRIMS):
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
          f"{prims} prims, {BOUNCES} bounces: {frame_ms:.3f} ms/frame, "
          f"{rays:.4e} rays/s, mean {float(accum.mean()):.5f} [{gpu}]")
    return counts[key]


def _band_split(mk, cuda_ms, spec, params, gpu):
    """K1 (``analytic_all``) and K2 (baked, t-culled) at MAIN_W x MAIN_H as
    one launch and as PARALLEL_BANDS band launches one after another (what
    the ranks of a PARALLEL_BANDS-rank ``render_frame_sharded`` launch, here
    on one card), kernel only, timed A B B A; returns {kernel: (one launch
    ms, band launches ms)}, each the mean of its two runs."""
    import torch

    from compute_path_tracer_tpu_torch.constants import DEFAULT_FOV
    from compute_path_tracer_tpu_torch.render.baked import bake
    from compute_path_tracer_tpu_torch.render.program import (
        build_program, program_table)
    from compute_path_tracer_tpu_torch.render.soa import (
        build_soa_smem_layout, pack_soa_smem)

    layout = build_soa_smem_layout(spec)
    prog = build_program(spec, "baked")
    with torch.no_grad():
        soa = pack_soa_smem(layout, bake(spec, params), params)
        table = program_table(prog, params, True)
    accum = torch.zeros((MAIN_H, MAIN_W, 3), dtype=torch.float32,
                        device=params.device)
    run = dict(frame=1, last_clear=1, bounces=BOUNCES, fov=DEFAULT_FOV,
               aspect=MAIN_W / MAIN_H, debug=0, height=MAIN_H)
    band = MAIN_H // PARALLEL_BANDS
    launch = {"K1": lambda a, r0: mk.launch_megakernel(
                  layout, *soa, a, row_offset=r0, **run),
              "K2": lambda a, r0: mk.launch_march(
                  prog, table, a, t_cull=True, row_offset=r0, **run)}
    out = {}
    for name, fn in launch.items():
        def whole():
            fn(accum, 0)

        def bands():
            for r0 in range(0, MAIN_H, band):
                fn(accum[r0:r0 + band], r0)

        a1, a4, b4, b1 = (cuda_ms(f, 5) for f in (whole, bands, bands, whole))
        out[name] = ((a1 + b1) / 2, (a4 + b4) / 2)
        print(f"band split {name} at {MAIN_W}x{MAIN_H}, {BOUNCES} bounces: one "
              f"launch {a1:.3f} / {b1:.3f} ms, {PARALLEL_BANDS} band launches "
              f"of {band} rows {a4:.3f} / {b4:.3f} ms (x"
              f"{out[name][1] / out[name][0]:.3f}) [{gpu}]")
    return out


def _main_shape_check(mk, key, spec, params, mode, label=None, count=None,
                      stats=None):
    """The kernel against the plain version at the main path's own shape
    (frame 0, fresh accumulator), bit for bit; returns (share, max |diff|,
    plain ms).
    ``count``, a dict, takes the plain frame's tally of the kernel's work
    for the bound, and its time then includes the counting; ``stats``, a
    MarchStats, takes the same pass's debug-4 statistics."""
    import torch

    kw = dict(width=MAIN_W, height=MAIN_H, bounces=BOUNCES, **mode)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = mk.render_frame_megakernel_plain(spec, params, None, 0, 0,
                                             count=count, stats=stats, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    before = mk.LAUNCHES[key]
    kernel = mk.render_frame_megakernel(spec, params, None, 0, 0, **kw)
    torch.cuda.synchronize()
    if mk.LAUNCHES[key] - before != 1:
        raise AssertionError(f"the {MAIN_W}x{MAIN_H} check did not launch {key}")
    share, err = _compare(f"{label or key} {MAIN_W}x{MAIN_H}, bounces {BOUNCES} "
                          f"frame 0", kernel, plain, exact=True)
    return share, err, plain_ms


def _quotient_phase(mk, ts, dev):
    """K1's hoisted quotient on the card (quotient_check) against
    __fdiv_rn over QUOTIENT_PAIRS seeded triples and the edge values: no
    quotient in the kernel's range may differ, and no edge that must take
    the division may be in it.  Returns (triples, in range)."""
    import numpy as np
    import torch

    b, o, d = ts.quotient_triples(QUOTIENT_PAIRS, QUOTIENT_SEED)
    eb, eo, ed, must = ts.quotient_edges()
    b, o, d = (torch.from_numpy(np.concatenate(a)).to(dev)
               for a in ((b, eb), (o, eo), (d, ed)))
    q_fast, q_div, in_range = mk.quotient_check(b, o, d)
    torch.cuda.synchronize()
    off = (q_fast.view(torch.int32) != q_div.view(torch.int32)) & in_range
    edges = in_range[-len(must):]
    wrong_edges = int((edges & torch.from_numpy(must).to(dev)).sum())
    print(f"check K1 quotient: {b.numel()} triples ({len(must)} edges), "
          f"{int(in_range.sum())} in the hoisted range, {int(off.sum())} "
          f"differ from __fdiv_rn; {wrong_edges} edges that must divide "
          f"are in the range")
    if int(off.sum()) or wrong_edges:
        raise AssertionError("the hoisted quotient is not the division")
    return b.numel(), int(in_range.sum())


def _lane_stats(mk, pf, ts, spec, params, mode, label, gpu):
    """K1's lane statistics at the main path's shape, frame 0: the STATS
    kernel under the refill schedule and under the old one (a warp per
    16x2 tile), and the old schedule's fill from the kernel's debug 3 frame
    (app/profiling.py:lane_fill); both schedules cast the same lanes, and
    the old one's counts are the debug 3 frame's exactly."""
    import torch

    from compute_path_tracer_tpu_torch.constants import DEFAULT_FOV
    from compute_path_tracer_tpu_torch.render.baked import bake

    layout = ts.build_soa_smem_layout(spec)
    with torch.no_grad():
        soa_f, soa_i = ts.pack_soa_smem(layout, bake(spec, params), params)
    accum = torch.zeros((MAIN_H, MAIN_W, 3), device=params.device)
    out = {}
    for per_tile in (False, True):
        st = torch.zeros(len(mk.LANE_STATS), dtype=torch.int64,
                         device=params.device)
        mk.launch_megakernel(layout, soa_f, soa_i, accum, frame=0,
                             last_clear=0, bounces=BOUNCES, fov=DEFAULT_FOV,
                             aspect=MAIN_W / MAIN_H, debug=0, lane_stats=st,
                             per_tile=per_tile)
        s = dict(zip(mk.LANE_STATS, st.tolist()))
        s["fill"] = s["lane_casts"] / (32 * s["warp_casts"])
        s["shapes_per_warp_cast"] = s["warp_shapes"] / s["warp_casts"]
        out["per_tile" if per_tile else "refill"] = s
    d3 = mk.render_frame_megakernel(spec, params, width=MAIN_W, height=MAIN_H,
                                    bounces=BOUNCES, debug=3, **mode)
    out["debug3"] = pf.lane_fill(d3, BOUNCES)
    refill, tile = out["refill"], out["per_tile"]
    print(f"{label} lanes at {MAIN_W}x{MAIN_H}, frame 0: fill {refill['fill']:.4f} "
          f"with refill, {tile['fill']:.4f} a warp per tile (debug 3's "
          f"{out['debug3']['fill']:.4f}); shapes some lane entered per warp "
          f"cast {refill['shapes_per_warp_cast']:.2f} ({tile['shapes_per_warp_cast']:.2f} "
          f"a warp per tile), per lane cast {refill['lane_shapes'] / refill['lane_casts']:.2f}; "
          f"{refill['lane_casts']} lane casts, {refill['slow_casts']} by the "
          f"division [{gpu}]")
    if (refill["lane_casts"] != tile["lane_casts"]
            or abs(tile["fill"] - out["debug3"]["fill"]) > 1e-12):
        raise AssertionError(f"{label}: lane statistics {out}")
    return out


def _cube_scene():
    """tests/test_baked.py:275's guard-less rotated cube beside a guard-less
    lamp: both are capped by analytic_unboxed."""
    from compute_path_tracer_tpu_torch.scene import (
        KIND_CUBE, KIND_SPHERE, Scene, Shape, Union)

    root = Union(name="Root")
    box = root.add_shape(Shape(KIND_CUBE, name="Box"))
    box.size3.set(0.5, 0.4, 0.3)
    box.transform.rotation.set(0.3, 0.5, 0.1)
    box.transform.position.set(0.1, -0.1, 0.4)
    box.transform.aabb = False
    box.material.color.set(0.7, 0.5, 0.3)
    lamp = root.add_shape(Shape(KIND_SPHERE, name="Lamp"))
    lamp.size.set(0.6)
    lamp.transform.position.set(1.2, 1.2, -0.8)
    lamp.material.color.set(0.0, 0.0, 0.0)
    lamp.material.brightness.set(10.0)
    lamp.material.light_col.set(1.0, 1.0, 1.0)
    lamp.transform.aabb = False
    return Scene([root])


def _sphere_and_plane():
    """tests/test_diff.py's inverse-rendering scene: an emissive ball over a
    guard-less ground plane."""
    from compute_path_tracer_tpu_torch.scene import (
        KIND_PLANE, KIND_SPHERE, Scene, Shape, Union)

    root = Union(name="Root")
    ball = root.add_shape(Shape(KIND_SPHERE, name="Ball"))
    ball.size.set(1.0)
    ball.material.color.set(0.8, 0.4, 0.2)
    ball.material.brightness.set(0.5)
    ground = root.add_shape(Shape(KIND_PLANE, name="Ground"))
    ground.transform.position.set(0.0, -1.2, 0.0)
    ground.transform.aabb = False
    return Scene([root])


def _scattered_rays(n, seed, dev):
    """``n`` rays with origins uniform in [-4, 4]^3 and directions uniform on
    the sphere, drawn with numpy."""
    import numpy as np
    import torch

    from compute_path_tracer_tpu_torch.vecmath import Vec3

    r = np.random.default_rng(seed)
    ro = r.uniform(-4.0, 4.0, (3, n)).astype(np.float32)
    d = r.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return (Vec3(*(torch.from_numpy(c).to(dev) for c in ro)),
            Vec3(*(torch.from_numpy(c).to(dev) for c in d)))


def _k3_check(km, name, prog, table, ro, rd, t_cull, with_normal):
    """K3 against its plain version on the same rays: the share of rays
    whose id differs or whose hit t moves by more than T_TOL (limit
    SHARE_LIMIT), and the max |diff| of t and of the normal on the rays that
    agree.  Returns (share, max |diff|, kernel ms, plain ms)."""
    import torch

    mode = dict(t_cull=t_cull, with_normal=with_normal)
    before = km.LAUNCHES["march_rays"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    k = km.march_rays(prog, table, ro, rd, **mode)
    torch.cuda.synchronize()
    k_ms = (time.perf_counter() - t0) * 1e3
    if km.LAUNCHES["march_rays"] - before != 1:
        raise AssertionError(f"{name}: march_rays was not launched once")
    t0 = time.perf_counter()
    p = km.march_rays_plain(prog, table, ro, rd, **mode)
    torch.cuda.synchronize()
    p_ms = (time.perf_counter() - t0) * 1e3
    hit = ~(k[0] > 100.0) | ~(p[0] > 100.0)
    dt = (k[0] - p[0]).abs()
    off = (k[1] != p[1]) | (hit & ~(dt <= T_TOL))
    share = float(off.float().mean())
    agree = hit & ~off
    err = float(dt[agree].max()) if bool(agree.any()) else 0.0
    if with_normal:
        err = max([err] + [float((a - b).abs()[agree].max())
                           for a, b in zip(k[2], p[2]) if bool(agree.any())])
    print(f"check {name}: share of rays off {share:.6f} (limit "
          f"{SHARE_LIMIT}), max abs diff {err:.3e}, hits "
          f"{float(hit.float().mean()):.4f}")
    if share > SHARE_LIMIT or not bool(torch.isfinite(k[0]).all()):
        raise AssertionError(f"{name}: {share} of rays differ (> {SHARE_LIMIT})")
    return share, err, k_ms, p_ms


@contextmanager
def _k3_swapped(km, fn):
    """Route every K3 call of the training path (kernels/march.py resolves
    ``march_rays`` at call time) through ``fn(orig, *args, **kw)``."""
    orig = km.march_rays
    km.march_rays = lambda *a, **kw: fn(orig, *a, **kw)
    try:
        yield
    finally:
        km.march_rays = orig


def _grad(spec, params, target, **kw):
    """The loss of make_loss at 320x180 and its gradient in the params."""
    from compute_path_tracer_tpu_torch.diff import make_loss

    p = params.clone().requires_grad_()
    loss = make_loss(spec, target, width=CHECK_W, height=CHECK_H,
                     bounces=GRAD_BOUNCES, **kw)(p)
    loss.backward()
    return float(loss.detach()), p.grad.detach()


def _hit_t_grad(km, spec, params, ro, rd):
    """sum(w * t) over the hits of the K3 cast (the training path's, with
    its implicit backward) and its gradient in the params and the six ray
    components, concatenated; w is 1 + the ray's index mod 3.  Returns
    ((loss, gradient), backward ms)."""
    import torch

    from compute_path_tracer_tpu_torch.render.baked import bake
    from compute_path_tracer_tpu_torch.vecmath import Vec3

    p = params.clone().requires_grad_()
    rays = [c.clone().requires_grad_() for c in (*ro, *rd)]
    gv = bake(spec, p)
    t, _ = km.make_kernel_cast(spec, p, gv)(Vec3(*rays[:3]), Vec3(*rays[3:]),
                                            None)
    w = 1.0 + (torch.arange(t.shape[0], device=t.device) % 3).to(t.dtype)
    loss = (torch.where(t > 100.0, torch.zeros_like(t), t) * w).sum()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss.backward()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    grad = torch.cat([p.grad] + [r.grad for r in rays])
    return (float(loss.detach()), grad), ms


def _grad_compare(name, a, b, loss_rel, top_rel, cos_tol):
    """Loss relative difference, the max relative error over the 20
    largest-magnitude slots of ``b`` (those above TOP_FLOOR of its largest)
    and the cosine of the two gradients."""
    import torch

    (la, ga), (lb, gb) = a, b
    if not (bool(torch.isfinite(ga).all()) and bool(torch.isfinite(gb).all())):
        raise AssertionError(f"{name}: non-finite gradient")
    top = torch.argsort(gb.abs(), descending=True)[:20]
    # A slot under TOP_FLOOR of the largest is a zero or cancellation
    # residue (sphere_and_plane's 20 largest reach down to 1e-8 and 6e-11,
    # 1e-7 and 4e-10 of its largest), whose relative error says nothing.
    top = top[gb[top].abs() > TOP_FLOOR * gb.abs().max()]
    rel_top = float(((ga[top] - gb[top]).abs() / gb[top].abs()).max())
    cos = float(ga @ gb / (ga.norm() * gb.norm()))
    rel_loss = abs(la - lb) / abs(lb)
    print(f"check {name}: loss {la:.8f} vs {lb:.8f} (rel {rel_loss:.3e}, limit "
          f"{loss_rel}), top-20 rel err {rel_top:.3e} (limit {top_rel}), "
          f"cosine {cos:.8f} (limit 1 - {cos_tol})")
    if rel_loss > loss_rel or rel_top > top_rel or cos < 1.0 - cos_tol:
        raise AssertionError(f"{name}: gradients disagree")


def _drive_training(km, mk, spec, params, gpu):
    """The training path's main path: one warm-up step and TIMED_STEPS timed
    steps of make_loss(TRAIN) at 1080p, backward and an Adam step, with every
    kernel count set to 0 just before and read just after; each step must
    launch K3 (at most once per bounce) and no other kernel.  Returns (K3
    launches, K3 ms per step, the inputs of one more step's K3 launches)."""
    import torch

    from compute_path_tracer_tpu_torch.diff import make_loss

    loss_fn = make_loss(spec, torch.zeros((MAIN_H, MAIN_W, 3), device=params.device),
                        width=MAIN_W, height=MAIN_H, bounces=BOUNCES, **TRAIN)
    p = params.clone().requires_grad_()
    opt = torch.optim.Adam([p], lr=2e-2, betas=(0.9, 0.999), eps=1e-8)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(p)
        loss.backward()
        opt.step()
        return loss.detach()

    events = []

    def timed(orig, *a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig(*a, **kw)
        end.record()
        events.append((start, end))
        return out

    torch.cuda.reset_peak_memory_stats()
    for counts in (mk.LAUNCHES, km.LAUNCHES):
        for k in counts:
            counts[k] = 0
    losses = [step()]
    torch.cuda.synchronize()
    with _k3_swapped(km, timed):
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            losses.append(step())
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = km.LAUNCHES["march_rays"]
    if any(mk.LAUNCHES.values()) or not 0 < launches <= (TIMED_STEPS + 1) * (BOUNCES + 1):
        raise AssertionError(f"training steps launched {dict(km.LAUNCHES)} "
                             f"and {dict(mk.LAUNCHES)}")
    finite = bool(torch.isfinite(p.grad).all()) and bool(torch.isfinite(p).all())
    if not finite:
        raise AssertionError("the training step's gradient is not finite")
    k3_ms = sum(a.elapsed_time(b) for a, b in events) / TIMED_STEPS
    step_ms = dt / TIMED_STEPS * 1e3
    peak = torch.cuda.max_memory_allocated()
    print(f"main path training step: {MAIN_W}x{MAIN_H}, {N_PRIMS} prims, "
          f"{BOUNCES} bounces, {TRAIN}: {step_ms:.3f} ms/step, "
          f"{MAIN_W * MAIN_H * (BOUNCES + 1) / (dt / TIMED_STEPS):.4e} rays/s, "
          f"K3 {launches / (TIMED_STEPS + 1):.2f} launches/step, "
          f"{k3_ms:.3f} ms/step, peak memory {peak / 2**30:.3f} GiB, "
          f"losses {[float(x) for x in losses]}, gradient finite [{gpu}]")

    kept = []

    def keep(orig, prog, table, ro, rd, **kw):
        kept.append((prog, table.clone(), type(ro)(*(c.clone() for c in ro)),
                     type(rd)(*(c.clone() for c in rd)), kw))
        return orig(prog, table, ro, rd, **kw)

    with _k3_swapped(km, keep):
        step()
    torch.cuda.synchronize()
    return launches, k3_ms, kept


@contextmanager
def _timed_calls(events, key, module, name):
    """Records CUDA events around every call of ``module.name`` (resolved
    at call time by its callers) into ``events[key]``."""
    import torch

    orig = getattr(module, name)

    def run(*a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig(*a, **kw)
        end.record()
        events[key].append((start, end))
        return out

    setattr(module, name, run)
    try:
        yield
    finally:
        setattr(module, name, orig)


def _drive_edge_step(km, mk, spec, params, gpu):
    """The autograd path with its edge estimators at the main path's shape:
    one timed 1080p step of make_loss(TRAIN, edge_grad, edge_secondary),
    backward and an Adam step, after a warm-up step at CHECK_W x CHECK_H
    (the same scene and options, so every op of the step has run once; the
    1080p step takes about 31 s, PERF.md), every kernel count set to 0 just
    before the timed step and read just after; it must launch K3 (at most
    once a bounce) and no other kernel.  K3, the closest-approach
    marches (diff/vjp.py:_march_closest, torch: no TPU kernel behind them)
    and their Danskin map vjps (_map_vjp) are timed with CUDA events.
    Returns the figures printed."""
    import torch

    from compute_path_tracer_tpu_torch.diff import make_loss
    from compute_path_tracer_tpu_torch.diff import vjp

    p = params.clone().requires_grad_()
    opt = torch.optim.Adam([p], lr=2e-2, betas=(0.9, 0.999), eps=1e-8)

    def step(width, height):
        opt.zero_grad(set_to_none=True)
        loss = make_loss(spec, torch.zeros((height, width, 3),
                                           device=params.device),
                         width=width, height=height, bounces=BOUNCES,
                         **TRAIN, **EDGE)(p)
        loss.backward()
        opt.step()
        return loss.detach()

    step(CHECK_W, CHECK_H)
    torch.cuda.synchronize()
    events = {"k3": [], "closest": [], "danskin": []}
    for counts in (mk.LAUNCHES, km.LAUNCHES):
        for k in counts:
            counts[k] = 0
    torch.cuda.reset_peak_memory_stats()
    with _timed_calls(events, "k3", km, "march_rays"), \
            _timed_calls(events, "closest", vjp, "_march_closest"), \
            _timed_calls(events, "danskin", vjp, "_map_vjp"):
        t0 = time.perf_counter()
        loss = step(MAIN_W, MAIN_H)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    launches = km.LAUNCHES["march_rays"]
    if any(mk.LAUNCHES.values()) or not 0 < launches <= BOUNCES + 1:
        raise AssertionError(f"the edge step launched {dict(km.LAUNCHES)} "
                             f"and {dict(mk.LAUNCHES)}")
    if not (bool(torch.isfinite(p.grad).all()) and bool(torch.isfinite(p).all())
            and bool(p.grad.abs().max() > 0)):
        raise AssertionError("the edge step's gradient is not finite or zero")
    ms = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in events.items()}
    peak = torch.cuda.max_memory_allocated()
    out = {"step_ms": step_ms, "rays_per_s": MAIN_W * MAIN_H * (BOUNCES + 1)
           / (step_ms / 1e3), "k3_launches": launches, "k3_ms": ms["k3"],
           "closest_marches": len(events["closest"]),
           "closest_ms": ms["closest"], "danskin_ms": ms["danskin"],
           "peak_gib": peak / 2**30, "loss": float(loss)}
    print(f"edge step (autograd path): {MAIN_W}x{MAIN_H}, {N_PRIMS} prims, "
          f"{BOUNCES} bounces, {TRAIN} + {EDGE}: {step_ms:.3f} ms/step, "
          f"{out['rays_per_s']:.4e} rays/s, K3 {launches} launches "
          f"{ms['k3']:.3f} ms, {len(events['closest'])} closest-approach "
          f"marches {ms['closest']:.3f} ms ({ms['closest'] / step_ms:.1%} of "
          f"the step), their Danskin map vjps {ms['danskin']:.3f} ms "
          f"({ms['danskin'] / step_ms:.1%}), peak memory "
          f"{peak / 2**30:.3f} GiB, loss {float(loss):.6e}, gradient finite "
          f"[{gpu}]")
    return out


def _flat_ball():
    """tests/test_train_fused.py:246's black, uniformly emissive ball: only
    the edge term moves its position."""
    from compute_path_tracer_tpu_torch.scene import KIND_SPHERE, Scene, Shape, Union

    root = Union(name="Root")
    ball = root.add_shape(Shape(KIND_SPHERE, name="Ball"))
    ball.size.set(0.8)
    ball.material.color.set(0.0, 0.0, 0.0)
    ball.material.brightness.set(2.0)
    ball.material.light_col.set(1.0, 1.0, 1.0)
    return Scene([root])


@contextmanager
def _k4_swapped(tm, fn):
    """Route every K4 launch of the fused step (kernels/train.py resolves
    ``launch_train_fused`` at call time) through ``fn(orig, *args, **kw)``."""
    orig = tm.launch_train_fused
    tm.launch_train_fused = lambda *a, **kw: fn(orig, *a, **kw)
    try:
        yield
    finally:
        tm.launch_train_fused = orig


def _k4_plain(tm, count=None, walk_stats=None):
    """A K4 stand-in that runs its plain version on the same inputs (with
    ``walk_stats``, its model of K4's per-warp lists)."""
    def run(orig, *a, **kw):
        return tm.fused_planes_plain(*a, count=count, walk_stats=walk_stats,
                                     **kw)

    return run


def _k4_walked(walk_stats):
    """A K4 stand-in that launches K4 with ``walk_stats``."""
    def run(orig, *a, **kw):
        return orig(*a, walk_stats=walk_stats, **kw)

    return run


def _k4_lists(name, kernel, plain, b1):
    """K4's per-warp list figures (``walk_stats``: summed length and count
    per group and bounce) against the plain model's, which must be equal;
    returns the mean lengths per group and bounce, printed."""
    k = kernel.view(3, b1, 2).tolist()
    p = plain.view(3, b1, 2).tolist()
    means = {g: _walk_means(rows) for g, rows in
             zip(("march", "edge_slope", "exclusion"), k)}
    print(f"check {name} per-warp lists against the plain model: "
          f"{'equal' if k == p else 'DIFFER'}; mean length per bounce "
          + "; ".join(f"{g} " + ", ".join(f"{m:.2f}" for m in v)
                      for g, v in means.items()), flush=True)
    if k != p:
        raise AssertionError(f"{name}: K4's per-warp lists {k} differ from "
                             f"the plain model's {p}")
    return means


def _fused_step(tm, spec, params, target, width, height, bounces, **kw):
    """One fused step: (loss, gradient, image)."""
    step = tm.make_fused_value_and_grad(spec, target, width=width,
                                        height=height, bounces=bounces,
                                        with_image=True, **kw)
    loss, grad, img = step(params)
    return float(loss), grad, img


def _k4_main_check(tm, spec, params, target, label, kw):
    """One fused step at the main path's shape with K4 and one with its
    plain version, held as the 320x180 cases are, K4's per-warp lists to
    the plain model's; the plain version also counts K4's work for the
    bound (and models the lists).  Returns (image share off, max |gradient
    diff|, plain ms with the counting, count)."""
    import torch

    ws = [torch.zeros(6 * (BOUNCES + 1), dtype=torch.int64,
                      device=target.device) for _ in "kp"]
    torch.cuda.synchronize()
    with _k4_swapped(tm, _k4_walked(ws[0])):
        k = _fused_step(tm, spec, params, target, MAIN_W, MAIN_H, BOUNCES,
                        **kw)
    count = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _k4_swapped(tm, _k4_plain(tm, count, ws[1])):
        p = _fused_step(tm, spec, params, target, MAIN_W, MAIN_H, BOUNCES, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    _k4_lists(f"K4 {MAIN_W}x{MAIN_H} {label}", *ws, BOUNCES + 1)
    share, _ = _compare(f"K4 {MAIN_W}x{MAIN_H} image, {label}", k[2], p[2],
                        exact=True)
    _grad_compare(f"K4 {MAIN_W}x{MAIN_H} gradient, {label}", k[:2], p[:2],
                  FUSED_LOSS_REL, FUSED_TOP_REL, FUSED_COS)
    print(f"K4 plain step at {MAIN_W}x{MAIN_H} ({label}): {plain_ms:.1f} ms, "
          f"host clock, counting included")
    return share, float((k[1] - p[1]).abs().max()), plain_ms, count


def _k4_checks(tm, cases, dev):
    """K4 against its plain version through the whole step at CHECK_W x
    CHECK_H, its per-warp lists against the plain model's; each case must
    launch K4 once per sample.  Returns the max |gradient diff| over the
    cases."""
    import numpy as np
    import torch

    target = torch.from_numpy(np.random.default_rng(3).random(
        (CHECK_H, CHECK_W, 3)).astype(np.float32) * 0.3).to(dev)
    max_err = 0.0
    for name, (spec, params), kw, bounces in cases:
        ws = [torch.zeros(6 * (bounces + 1), dtype=torch.int64, device=dev)
              for _ in "kp"]
        before = tm.LAUNCHES["train_fused"]
        with _k4_swapped(tm, _k4_walked(ws[0])):
            k = _fused_step(tm, spec, params, target, CHECK_W, CHECK_H,
                            bounces, **kw)
        torch.cuda.synchronize()
        if tm.LAUNCHES["train_fused"] - before != kw.get("spp", 1):
            raise AssertionError(f"{name}: train_fused was not launched once "
                                 f"per sample")
        with _k4_swapped(tm, _k4_plain(tm, walk_stats=ws[1])):
            p = _fused_step(tm, spec, params, target, CHECK_W, CHECK_H,
                            bounces, **kw)
        _compare(f"{name} image", k[2], p[2], exact=True)
        _k4_lists(name, *ws, bounces + 1)
        _grad_compare(f"{name} gradient, {CHECK_W}x{CHECK_H}, bounces "
                      f"{bounces}", k[:2], p[:2], FUSED_LOSS_REL,
                      FUSED_TOP_REL, FUSED_COS)
        max_err = max(max_err, float((k[1] - p[1]).abs().max()))
    return max_err


def _k4_band_check(tm, spec, params, dev):
    """K4 launched on a band of the CHECK_W x CHECK_H frame at a row offset
    (its last row of blocks partial), march + edge + secondary, against its
    plain version on the same band: the band's image bit for bit, its
    per-warp lists equal to the plain model's."""
    import numpy as np
    import torch

    from compute_path_tracer_tpu_torch.constants import DEFAULT_FOV

    row0, crop = 92, 84
    mode = tm.FusedMode(CHECK_BOUNCES, True, True, True)
    tables = tm.fused_tables(spec, params)
    target = torch.from_numpy(np.random.default_rng(4).random(
        (3, crop, CHECK_W)).astype(np.float32) * 0.3).to(dev)
    args = (tables, target, 0, DEFAULT_FOV, CHECK_W / CHECK_H, row0)
    kw = dict(width=CHECK_W, height=CHECK_H, mode=mode)
    ws = [torch.zeros(6 * mode.b1, dtype=torch.int64, device=dev)
          for _ in "kp"]
    k = tm.launch_train_fused(*args, walk_stats=ws[0], **kw)
    p = tm.fused_planes_plain(*args, walk_stats=ws[1], **kw)
    torch.cuda.synchronize()
    name = (f"K4 band rows {row0}-{row0 + crop} of {CHECK_W}x{CHECK_H}, march "
            f"+ edge + secondary")
    _compare(f"{name} image", k.col.T, p.col.T, exact=True)
    _k4_lists(name, *ws, mode.b1)


def _k4_check_cases(dev, unboxed):
    """K4 against its plain version at CHECK_W x CHECK_H (``_k4_checks``):
    the march and analytic_all cases, or with ``unboxed`` the
    analytic_unboxed cases and the band check.  Returns the max |gradient
    diff| over the cases."""
    from compute_path_tracer_tpu_torch.kernels import train as tm

    bench, csg = _scene("bench", dev), _scene("csg", dev)
    if not unboxed:
        sap = _scene("sap", dev)
        return _k4_checks(tm, (
            ("K4 winner, march, sphere_and_plane", sap, {}, 2),
            ("K4 winner, march + edge + secondary, sphere_and_plane", sap,
             dict(edge_grad=True, edge_secondary=True), 2),
            ("K4 winner, march", bench, {}, CHECK_BOUNCES),
            ("K4 winner, march + edge", bench, dict(edge_grad=True), CHECK_BOUNCES),
            ("K4 winner, march + edge + secondary", bench,
             dict(edge_grad=True, edge_secondary=True), CHECK_BOUNCES),
            ("K4 winner, analytic_all + edge", bench, FUSED_MAIN, CHECK_BOUNCES),
            ("K4 winner, analytic_all + edge, spp 2", bench,
             dict(FUSED_MAIN, spp=2), CHECK_BOUNCES),
            ("K4 map-vjp csg_demo, march", csg, {}, CHECK_BOUNCES),
            ("K4 map-vjp csg_demo, march + edge + secondary", csg,
             dict(edge_grad=True, edge_secondary=True), CHECK_BOUNCES),
            ("K4 edge_demo, bounces 0 + edge", _scene("edge", dev),
             dict(edge_grad=True), 0),
        ), dev)
    k4b_err = _k4_checks(tm, (
        ("K4 winner, analytic_unboxed", bench, FUSED_UNBOXED, CHECK_BOUNCES),
        ("K4 winner, analytic_unboxed + edge", bench,
         dict(FUSED_UNBOXED, edge_grad=True), CHECK_BOUNCES),
        ("K4 winner, analytic_unboxed + edge + secondary", bench,
         dict(FUSED_UNBOXED, edge_grad=True, edge_secondary=True), CHECK_BOUNCES),
        ("K4 map-vjp csg_demo, analytic_unboxed", csg, FUSED_UNBOXED, CHECK_BOUNCES),
        # Images bit-equal to the plain version's, so the tight gates hold
        # the secondary exclusion march over the skipped shapes: every shape
        # of the cube scene is skipped, csg_demo's plane and lamp are.
        ("K4 winner guard-less cube, analytic_unboxed + edge + secondary",
         _scene("cube", dev),
         dict(FUSED_UNBOXED, edge_grad=True, edge_secondary=True), CHECK_BOUNCES),
        ("K4 map-vjp csg_demo, analytic_unboxed + edge + secondary", csg,
         dict(FUSED_UNBOXED, edge_grad=True, edge_secondary=True), CHECK_BOUNCES),
    ), dev)
    _k4_band_check(tm, *bench, dev)
    return k4b_err


def _d4_check_cases(dev):
    """debug 4 (K2's STATS kernel) against the plain reducer at CHECK_W x
    CHECK_H: every channel bit for bit, over geometry, t_cull and
    analytic_unboxed on four scenes, and partial warps at D4_PARTIAL.
    Returns the max |diff|."""
    import torch

    from compute_path_tracer_tpu_torch.kernels import megakernel as mk

    bench, csg = _scene("bench", dev), _scene("csg", dev)
    sap, cube = _scene("sap", dev), _scene("cube", dev)
    d4_cases = []
    for name, scene, modes in (
            (f"benchmark_scene({N_PRIMS})", bench,
             (MARCH, UNBOXED, dict(geometry="faithful", t_cull=True),
              dict(geometry="baked"))),
            ("csg_demo, subtraction", csg,
             (MARCH, UNBOXED, dict(geometry="faithful", t_cull=True),
              dict(geometry="faithful"))),
            ("guard-less cube", cube, (MARCH, UNBOXED)),
            ("sphere_and_plane", sap, (MARCH, UNBOXED))):
        for mode in modes:
            d4_cases.append((f"K2 debug 4 {name} {mode}", scene,
                             dict(mode, bounces=CHECK_BOUNCES, debug=4), None,
                             SHARE_LIMIT))
    # The exact normal in each of debug 4's four instantiations.
    for name, scene, mode in (
            (f"benchmark_scene({N_PRIMS})", bench, MARCH),
            (f"benchmark_scene({N_PRIMS})", bench, dict(geometry="baked")),
            ("csg_demo, subtraction", csg, UNBOXED),
            ("csg_demo, subtraction", csg,
             dict(geometry="faithful", t_cull=True)),
            ("csg_demo, subtraction", csg, dict(geometry="faithful"))):
        d4_cases.append((f"K2 debug 4 normals=autodiff {name} {mode}", scene,
                         dict(mode, **EXACT, bounces=MODE_BOUNCES, debug=4),
                         None, SHARE_LIMIT))
    d4_err = _check_cases(mk, "megakernel_march", d4_cases)
    pw, ph = D4_PARTIAL
    kw = dict(width=pw, height=ph, bounces=CHECK_BOUNCES, debug=4, **MARCH)
    before = mk.LAUNCHES["megakernel_march"]
    k = mk.render_frame_megakernel(*bench, **kw)
    p = mk.render_frame_megakernel_plain(*bench, **kw)
    torch.cuda.synchronize()
    if mk.LAUNCHES["megakernel_march"] - before != 1:
        raise AssertionError("debug 4 at the partial-warp size did not launch")
    return max(d4_err, _compare(f"K2 debug 4 benchmark_scene({N_PRIMS}) "
                                f"{pw}x{ph}, partial warps", k, p,
                                exact=True)[1])


_SCENES = {}


def _scene(name, dev):
    """The checks' scenes by name, compiled once per process: (spec, params
    on ``dev``); the params are those a RenderSession of the scene holds."""
    if name not in _SCENES:
        from compute_path_tracer_tpu_torch.scene import (
            benchmark_scene, blend_demo, compile_scene, csg_demo, edge_demo,
            glass_demo, params_from_numpy, sphere_and_plane)

        make = {"bench": lambda: benchmark_scene(N_PRIMS),
                "walk": lambda: benchmark_scene(WALK_PRIMS),
                "soa256": lambda: benchmark_scene(256),
                "soa512": lambda: benchmark_scene(512),
                "csg": csg_demo, "blend": blend_demo, "glass": glass_demo,
                "clobber": _clobber_scene, "cube": _cube_scene,
                "sap": sphere_and_plane, "edge": edge_demo}[name]
        cs = compile_scene(make())
        _SCENES[name] = (cs.spec, params_from_numpy(cs.params, cs.spec, dev))
    return _SCENES[name]


def _prior(dev):
    """The seeded running mean that the frame-3 checks accumulate onto."""
    import torch

    gen = torch.Generator(device="cpu").manual_seed(0)
    return torch.rand((CHECK_H, CHECK_W, 3), generator=gen).to(dev)


def _job_k2(dev, part):
    """K2 against its plain version at CHECK_W x CHECK_H: faithful and baked
    geometry, subtraction, smooth union, refraction, the first-shape
    clobber, debug 0-3, a running mean and benchmark_scene(WALK_PRIMS); every
    other case from ``part`` (0 or 1)."""
    from compute_path_tracer_tpu_torch.kernels import megakernel as mk

    csg, blend = _scene("csg", dev), _scene("blend", dev)
    cases = []
    for name, scene, mode in (
            ("csg_demo faithful", csg, dict(geometry="faithful")),
            ("csg_demo baked", csg, dict(geometry="baked")),
            ("blend_demo baked", blend, dict(geometry="baked")),
            ("glass_demo baked, refraction", _scene("glass", dev),
             dict(geometry="baked")),
            ("clobber scene baked", _scene("clobber", dev),
             dict(geometry="baked")),
            (f"benchmark_scene({N_PRIMS}) baked t_cull", _scene("bench", dev),
             MARCH)):
        for debug in (0, 1, 2, 3):
            cases.append((f"K2 {name} debug {debug}", scene,
                          dict(mode, bounces=CHECK_BOUNCES, debug=debug), None,
                          SHARE_LIMIT))
    cases.append(("K2 csg_demo faithful t_cull frame 3, running mean", csg,
                  dict(geometry="faithful", t_cull=True, bounces=CHECK_BOUNCES,
                       frame=3, last_clear=3), _prior(dev), SHARE_LIMIT))
    cases.append((f"K2 benchmark_scene({WALK_PRIMS}) baked t_cull",
                   _scene("walk", dev), dict(MARCH, bounces=CHECK_BOUNCES), None,
                   SHARE_LIMIT))
    # The exact normal (normals="autodiff") in each plain march's
    # instantiation: subtraction and guard skips, the smooth union's blend,
    # the benchmark scene's octahedra and cubes.
    for name, scene, mode, debugs in (
            ("csg_demo faithful", csg, dict(geometry="faithful"), (0,)),
            ("csg_demo faithful t_cull", csg,
             dict(geometry="faithful", t_cull=True), (0, 1)),
            ("blend_demo baked", blend, dict(geometry="baked"), (1,)),
            (f"benchmark_scene({N_PRIMS}) baked t_cull", _scene("bench", dev),
             MARCH, (0, 1))):
        for debug in debugs:
            cases.append((f"K2 normals=autodiff {name} debug {debug}", scene,
                          dict(mode, **EXACT, bounces=MODE_BOUNCES,
                               debug=debug), None, SHARE_LIMIT))
    return {"k2_err": _check_cases(mk, "megakernel_march", cases[part::2])}


def _job_k2b(dev):
    """K2b (analytic_unboxed, omega) and the window (refresh_every) against
    their plain versions at CHECK_W x CHECK_H; omega=1.0 the march without
    it."""
    import torch

    from compute_path_tracer_tpu_torch.kernels import megakernel as mk

    bench, csg = _scene("bench", dev), _scene("csg", dev)
    cases = []
    for name, scene in ((f"benchmark_scene({N_PRIMS})", bench),
                        ("csg_demo, subtraction tree", csg),
                        ("guard-less cube", _scene("cube", dev)),
                        ("clobber scene", _scene("clobber", dev))):
        for debug in (0, 3):
            cases.append((f"K2b analytic_unboxed {name} debug {debug}",
                          scene, dict(UNBOXED, bounces=CHECK_BOUNCES, debug=debug),
                          None, SHARE_LIMIT))
    k2b_err = _check_cases(mk, "megakernel_march", cases)
    k2b_err = max(k2b_err, _check_cases(mk, "megakernel_march", (
        (f"K2b omega {OMEGA} benchmark_scene({N_PRIMS}) baked t_cull", bench,
         dict(MARCH, omega=OMEGA, bounces=CHECK_BOUNCES), None, SHARE_LIMIT),
        (f"K2b omega {OMEGA} csg_demo faithful t_cull", csg,
         dict(geometry="faithful", t_cull=True, omega=OMEGA,
              bounces=CHECK_BOUNCES), None, SHARE_LIMIT),
        (f"K2b omega {OMEGA} + analytic_unboxed csg_demo", csg,
         dict(UNBOXED, omega=OMEGA, bounces=CHECK_BOUNCES), None, SHARE_LIMIT))))
    # The exact normal in K2b (the caps folded into the gradient's map) and
    # RELAX, and the frozen activation window with and without the cap and
    # the exact normal: every RELAX and window instantiation, both
    # geometries.
    faithful = dict(geometry="faithful", t_cull=True)
    k2b_err = max(k2b_err, _check_cases(mk, "megakernel_march", tuple(
        (f"{label} {name}", scene, dict(mode, bounces=MODE_BOUNCES), None,
         SHARE_LIMIT)
        for name, scene, label, mode in (
            (f"benchmark_scene({N_PRIMS})", bench,
             "K2b analytic_unboxed normals=autodiff", dict(UNBOXED, **EXACT)),
            (f"benchmark_scene({N_PRIMS})", bench,
             f"K2b omega {OMEGA} normals=autodiff",
             dict(MARCH, **EXACT, omega=OMEGA)),
            ("csg_demo faithful t_cull", csg,
             f"K2b omega {OMEGA} normals=autodiff",
             dict(faithful, **EXACT, omega=OMEGA)),
            ("csg_demo faithful t_cull", csg, "K2 refresh_every 4",
             dict(faithful, refresh_every=4)),
            ("csg_demo faithful t_cull", csg,
             "K2 refresh_every 4 normals=autodiff",
             dict(faithful, **EXACT, refresh_every=4)),
            (f"benchmark_scene({N_PRIMS}) baked t_cull", bench,
             "K2 refresh_every 4", dict(MARCH, refresh_every=4)),
            (f"benchmark_scene({N_PRIMS}) baked t_cull", bench,
             "K2 refresh_every 4 normals=autodiff",
             dict(MARCH, **EXACT, refresh_every=4)),
            (f"benchmark_scene({N_PRIMS}) + analytic_unboxed", bench,
             "K2 refresh_every 8", dict(UNBOXED, refresh_every=8))))))
    # omega=1.0 is the march without over-relaxation: K2's frame, and on
    # csg_demo, where K2 is its plain version bit for bit, the plain frame.
    for name, (sspec, sparams), mode in (
            (f"benchmark_scene({N_PRIMS}) baked", bench, MARCH),
            ("csg_demo baked", csg, MARCH),
            ("csg_demo faithful", csg, dict(geometry="faithful", t_cull=True))):
        kw = dict(width=CHECK_W, height=CHECK_H, bounces=CHECK_BOUNCES, **mode)
        one = mk.render_frame_megakernel(sspec, sparams, omega=1.0, **kw)
        ref = (mk.render_frame_megakernel_plain if name.startswith("csg")
               else mk.render_frame_megakernel)(sspec, sparams, **kw)
        torch.cuda.synchronize()
        equal = bool(torch.equal(one, ref))
        print(f"check K2 omega=1.0 {name} t_cull against the "
              f"{'plain' if name.startswith('csg') else 'K2'} frame without "
              f"omega: {'bit-equal' if equal else 'DIFFERENT'}")
        if not equal:
            raise AssertionError(f"omega=1.0 changed the {name} frame")
    return {"k2b_err": k2b_err}


def _job_k5(dev):
    """K5 (analytic_soa) against its plain version at CHECK_W x CHECK_H, and
    at 64 primitives bit for bit K1's analytic_all frame."""
    import torch

    from compute_path_tracer_tpu_torch.kernels import megakernel as mk

    bench = _scene("bench", dev)
    k5_err = {n: _check_cases(mk, "megakernel_analytic", (
        (f"K5 analytic_soa benchmark_scene({n})", _scene(f"soa{n}", dev),
         dict(SOA, bounces=CHECK_BOUNCES), None, SHARE_LIMIT),)) for n in SOA_PRIMS}
    soa64 = mk.render_frame_megakernel(*bench, width=CHECK_W, height=CHECK_H,
                                       bounces=CHECK_BOUNCES, **SOA)
    all64 = mk.render_frame_megakernel(*bench, width=CHECK_W, height=CHECK_H,
                                       bounces=CHECK_BOUNCES, **ANALYTIC)
    torch.cuda.synchronize()
    equal = bool(torch.equal(soa64, all64))
    print(f"check K5 analytic_soa against K1 analytic_all, benchmark_scene("
          f"{N_PRIMS}) {CHECK_W}x{CHECK_H}: {'bit-equal' if equal else 'DIFFERENT'}")
    if not equal:
        raise AssertionError("analytic_soa is not analytic_all's frame")
    return {"k5_err": k5_err}


def _job_k6(dev):
    """K6 (dist_grid) against its plain version at CHECK_W x CHECK_H on four
    scenes, with analytic_unboxed and with a zero grid_tau; omega ignored
    under it; its frame against K2's; multi-frame accumulation through K1
    and K2, bit for bit the frames one at a time."""
    import torch

    from compute_path_tracer_tpu_torch.constants import DEFAULT_FOV
    from compute_path_tracer_tpu_torch.kernels import megakernel as mk

    bench = _scene("bench", dev)
    cases = []
    for name, scene in ((f"benchmark_scene({N_PRIMS})", bench),
                        ("csg_demo, subtraction", _scene("csg", dev)),
                        ("blend_demo, smooth union", _scene("blend", dev)),
                        ("sphere_and_plane, plane", _scene("sap", dev))):
        for debug in (0, 3):
            cases.append((f"K6 dist_grid {name} debug {debug}", scene,
                          dict(GRID, bounces=CHECK_BOUNCES, debug=debug), None,
                          SHARE_LIMIT))
    cases.append((f"K6 dist_grid + analytic_unboxed benchmark_scene("
                  f"{N_PRIMS})", bench, dict(GRID, analytic_unboxed=True,
                                             bounces=CHECK_BOUNCES), None,
                  SHARE_LIMIT))
    for name, scene, mode in (
            (f"benchmark_scene({N_PRIMS})", bench, GRID),
            ("blend_demo + analytic_unboxed", _scene("blend", dev),
             dict(GRID, analytic_unboxed=True))):
        cases.append((f"K6 dist_grid normals=autodiff {name}", scene,
                      dict(mode, **EXACT, bounces=MODE_BOUNCES), None,
                      SHARE_LIMIT))
    # With a zero shell no ray takes an exact tap: those that reach a cell
    # whose bound is 0 run out of iterations and take the full map's id.
    cases.append(("K6 dist_grid grid_tau 0, edge_demo, out of iterations",
                  _scene("edge", dev), dict(GRID, grid_tau=0.0,
                                            bounces=CHECK_BOUNCES), None,
                  SHARE_LIMIT))
    k6_err = _check_cases(mk, "megakernel_march", cases)
    # The grid march's STATS form (grid_stats) with the exact normal: the
    # plain version's frame, bit for bit, and the warp statistics taken.
    prog, table, grid = mk._march_tables(*bench, "baked", True, False, True,
                                         mk.GRID_DEFAULT_RES, mk.GRID_TAU)
    acc = torch.zeros((CHECK_H, CHECK_W, 3), device=dev)
    gstats = torch.zeros(5, dtype=torch.int64, device=dev)
    before = mk.LAUNCHES["megakernel_march"]
    mk.launch_march(prog, table, acc, frame=0, last_clear=0,
                    bounces=MODE_BOUNCES, fov=DEFAULT_FOV,
                    aspect=CHECK_W / CHECK_H, debug=0, t_cull=True, grid=grid,
                    grid_stats=gstats, **EXACT)
    p = mk.render_frame_megakernel_plain(*bench, width=CHECK_W,
                                         height=CHECK_H, bounces=MODE_BOUNCES,
                                         **GRID, **EXACT)
    torch.cuda.synchronize()
    if mk.LAUNCHES["megakernel_march"] - before != 1 or not int(gstats[0]):
        raise AssertionError("K6's STATS form with the exact normal did not "
                             "launch or took no statistics")
    k6_err = max(k6_err, _compare(
        f"K6 dist_grid grid_stats normals=autodiff benchmark_scene("
        f"{N_PRIMS})", acc, p, exact=True)[1])
    kw = dict(width=CHECK_W, height=CHECK_H, bounces=CHECK_BOUNCES, **GRID)
    g1 = mk.render_frame_megakernel(*bench, omega=1.0, **kw)
    g16 = mk.render_frame_megakernel(*bench, omega=OMEGA, **kw)
    k2_frame = mk.render_frame_megakernel(*bench, width=CHECK_W,
                                          height=CHECK_H, bounces=CHECK_BOUNCES,
                                          **MARCH)
    torch.cuda.synchronize()
    equal = bool(torch.equal(g1, g16))
    print(f"check K6 omega {OMEGA} against omega 1.0 under dist_grid: "
          f"{'bit-equal' if equal else 'DIFFERENT'}")
    if not equal:
        raise AssertionError("dist_grid did not ignore omega")
    _compare(f"K6 dist_grid against K2 (t_cull alone), benchmark_scene("
             f"{N_PRIMS}) {CHECK_W}x{CHECK_H}", g1, k2_frame)

    # Multi-frame accumulation: ACC_FRAMES launches on one accumulator, bit
    # for bit the frames one at a time, through K1 and through K2.
    for key, mode in (("megakernel_analytic", ANALYTIC),
                      ("megakernel_march", MARCH)):
        kw = dict(width=CHECK_W, height=CHECK_H, bounces=CHECK_BOUNCES, **mode)
        before = mk.LAUNCHES[key]
        acc = mk.render_accumulated_megakernel(*bench, ACC_FRAMES, **kw)
        torch.cuda.synchronize()
        launched = mk.LAUNCHES[key] - before
        one = None
        for f in range(ACC_FRAMES):
            one = mk.render_frame_megakernel(*bench, one, f, f, **kw)
        torch.cuda.synchronize()
        equal = bool(torch.equal(acc, one))
        print(f"check render_accumulated_megakernel ({key}), {ACC_FRAMES} "
              f"frames: {launched} launches, "
              f"{'bit-equal' if equal else 'DIFFERENT'} to {ACC_FRAMES} "
              f"render_frame_megakernel calls")
        if not equal or launched != ACC_FRAMES:
            raise AssertionError(f"render_accumulated_megakernel ({key})")
    return {"k6_err": k6_err}


def _job_k3(dev):
    """K3 against its plain version on K3_RAYS scattered rays over three
    scenes, both geometries, with and without t_cull and the normal, and on
    K3_RAGGED rays (a partial warp)."""
    from compute_path_tracer_tpu_torch.kernels import march as km
    from compute_path_tracer_tpu_torch.render.program import (
        build_program, program_table)

    ro, rd = _scattered_rays(K3_RAYS, 1, dev)
    err = 0.0
    for sname, key in ((f"benchmark_scene({N_PRIMS})", "bench"),
                       ("csg_demo", "csg"), ("blend_demo", "blend")):
        sspec, sparams = _scene(key, dev)
        for geometry in ("baked", "faithful"):
            sprog = build_program(sspec, geometry)
            for t_cull in (False, True):
                stable = program_table(sprog, sparams, t_cull)
                for with_normal in (False, True):
                    err = max(err, _k3_check(
                        km, f"K3 {sname} {geometry} t_cull={t_cull} "
                        f"normal={with_normal}, {K3_RAYS} scattered rays",
                        sprog, stable, ro, rd, t_cull, with_normal)[1])
    ro, rd = _scattered_rays(K3_RAGGED, 2, dev)
    spec, params = _scene("bench", dev)
    sprog = build_program(spec, "baked")
    err = max(err, _k3_check(
        km, f"K3 benchmark_scene({N_PRIMS}) baked t_cull=True normal=True, "
        f"{K3_RAGGED} scattered rays (a partial warp)", sprog,
        program_table(sprog, params, True), ro, rd, True, True)[1])
    return {"k3_err": err}


def _job_grad(dev):
    """The gradient of make_loss through K3 against the same with K3's
    plain version (normals detached and through the kernel) and against
    the plain march, render_image_diff through both marches, and the
    implicit gradient of a loss on the hit distance, at CHECK_W x
    CHECK_H."""
    import torch

    from compute_path_tracer_tpu_torch.diff import render_image_diff
    from compute_path_tracer_tpu_torch.kernels import march as km
    from compute_path_tracer_tpu_torch.render.reference import camera_rays

    spec, sp = _scene("bench", dev)
    gkw = dict(geometry="baked")
    with torch.no_grad():
        target = render_image_diff(spec, sp, width=CHECK_W, height=CHECK_H,
                                   bounces=GRAD_BOUNCES, march="kernel",
                                   normals="detached", **gkw) * 0.9

    def plain_k3(orig, *a, **kw):
        return km.march_rays_plain(*a, **kw)

    for normals in ("detached", "kernel"):
        kernel = _grad(spec, sp, target, march="kernel",
                       normals=normals, **gkw)
        with _k3_swapped(km, plain_k3):
            plain = _grad(spec, sp, target, march="kernel",
                          normals=normals, **gkw)
        _grad_compare(f"gradient through K3 vs its plain version, normals="
                      f"{normals}, {CHECK_W}x{CHECK_H}, bounces "
                      f"{GRAD_BOUNCES}", kernel, plain, GRAD_LOSS_REL,
                      GRAD_TOP_REL, GRAD_COS)
    exact = _grad(spec, sp, target, march="plain",
                  normals="detached", **gkw)
    kernel = _grad(spec, sp, target, march="kernel",
                   normals="detached", **gkw)
    _grad_compare(f"gradient march=kernel vs march=plain (exact), normals="
                  f"detached, {CHECK_W}x{CHECK_H}", kernel, exact,
                  float("inf"), float("inf"), EXACT_COS)
    with torch.no_grad():
        img_k = render_image_diff(spec, sp, width=CHECK_W, height=CHECK_H,
                                  bounces=GRAD_BOUNCES, march="kernel", **gkw)
        img_p = render_image_diff(spec, sp, width=CHECK_W, height=CHECK_H,
                                  bounces=GRAD_BOUNCES, march="plain", **gkw)
    _compare("render_image_diff march=kernel vs march=plain (exact)", img_k,
             img_p)
    # The renderer's loss never reads the hit distance (its radiance is a
    # product of material constants), so autograd prunes the implicit
    # backward from the training step; a loss on t exercises it.
    with torch.no_grad():
        ys, xs = torch.meshgrid(
            torch.arange(CHECK_H, dtype=torch.int32, device=dev),
            torch.arange(CHECK_W, dtype=torch.int32, device=dev), indexing="ij")
        _, cro, crd = camera_rays(xs, ys, 0, 1.0, CHECK_W / CHECK_H,
                                  width=CHECK_W, height=CHECK_H)
    kernel, _ = _hit_t_grad(km, spec, sp, cro, crd)
    with _k3_swapped(km, plain_k3):
        plain, _ = _hit_t_grad(km, spec, sp, cro, crd)
    _grad_compare(f"implicit gradient of sum(w t) through K3 vs its plain "
                  f"version, {CHECK_W}x{CHECK_H} primary rays", kernel, plain,
                  GRAD_LOSS_REL, GRAD_TOP_REL, GRAD_COS)
    return {}


def _job_k2_main(dev):
    """K2 at the main path's shape against the plain pass that counts its
    work and takes debug 4's statistics; debug 4 at that shape against
    those statistics.  Returns the checks' figures, the count, the plain
    model's per-warp lists and debug 4's per-warp and per-lane sums."""
    import torch

    from compute_path_tracer_tpu_torch.app import profiling as pf
    from compute_path_tracer_tpu_torch.kernels import megakernel as mk

    spec, sp = _scene("bench", dev)
    count, stats = {}, mk.MarchStats()
    share, err, plain_ms = _main_shape_check(
        mk, "megakernel_march", spec, sp, MARCH, count=count, stats=stats)
    before = mk.LAUNCHES["megakernel_march"]
    d4 = mk.render_frame_megakernel(spec, sp, None, 0, 0, width=MAIN_W,
                                    height=MAIN_H, bounces=BOUNCES, debug=4,
                                    **MARCH)
    torch.cuda.synchronize()
    if mk.LAUNCHES["megakernel_march"] - before != 1:
        raise AssertionError("debug 4 at 1080p did not launch K2")
    d4_share, d4_err = _compare(f"K2 debug 4 {MAIN_W}x{MAIN_H}, bounces "
                                f"{BOUNCES} frame 0, against the plain pass",
                                d4, stats.image(), exact=True)
    return {"share": share, "err": err, "plain_ms": plain_ms, "count": count,
            "walk": stats.walk_lists().tolist(), "d4_share": d4_share,
            "d4_err": d4_err, "warps": pf.group_stats(d4),
            "lanes": stats.lanes_xyz.tolist()}


def _job_k2x_main(dev):
    """K2 with the exact normal and with refresh_every 4 at the main path's
    shape, each against its plain pass, which counts its work."""
    from compute_path_tracer_tpu_torch.kernels import megakernel as mk

    out = {}
    for key, mode, label in (("exact", dict(MARCH, **EXACT),
                              "K2 normals=autodiff"),
                             ("refresh", dict(MARCH, refresh_every=4),
                              "K2 refresh_every 4")):
        count = {}
        share, err, plain_ms = _main_shape_check(
            mk, "megakernel_march", *_scene("bench", dev), mode, label, count)
        out[key] = {"share": share, "err": err, "plain_ms": plain_ms,
                    "count": count}
    return out


def _job_k2b_main(dev):
    """K2b (analytic_unboxed) at the main path's shape against the plain
    pass that counts its work."""
    from compute_path_tracer_tpu_torch.kernels import megakernel as mk

    count = {}
    share, err, plain_ms = _main_shape_check(
        mk, "megakernel_march", *_scene("bench", dev), UNBOXED,
        "K2b analytic_unboxed", count)
    return {"share": share, "err": err, "plain_ms": plain_ms, "count": count}


def _job_k6_main(dev):
    """K6 (dist_grid) at the main path's shape against the plain pass that
    counts its work; returns the plain model's per-warp lists too."""
    from compute_path_tracer_tpu_torch.kernels import megakernel as mk

    count, stats = {}, mk.MarchStats()
    share, err, plain_ms = _main_shape_check(
        mk, "megakernel_march", *_scene("bench", dev), GRID, "K6 dist_grid",
        count, stats)
    return {"share": share, "err": err, "plain_ms": plain_ms, "count": count,
            "walk": stats.walk_lists().tolist()}


def _job_k4b_main(dev):
    """K4's analytic_unboxed step at the main path's shape against its plain
    step, which counts the work (``_k4_main_check``)."""
    import torch

    from compute_path_tracer_tpu_torch.kernels import train as tm

    target0 = torch.zeros((MAIN_H, MAIN_W, 3), device=dev)
    share, err, plain_ms, count = _k4_main_check(
        tm, *_scene("bench", dev), target0, "analytic_unboxed", FUSED_UNBOXED)
    return {"share": share, "err": err, "plain_ms": plain_ms, "count": count}


def _job_wavefront(dev):
    """The wavefront bounce kernel: bit for bit its plain frame at CHECK_W x
    CHECK_H on the benchmark scene and csg_demo, compacted and sorted, with
    its per-warp list figures (``walk_stats``) equal to the plain model's,
    and at 1080p bit for bit K2's faithful exact frame and the plain frame
    that counts the work."""
    import torch

    from compute_path_tracer_tpu_torch.benchmarks import frozen_wavefront as fw
    from compute_path_tracer_tpu_torch.kernels import megakernel as mk
    from compute_path_tracer_tpu_torch.kernels import wavefront as wf

    err = 0.0
    kw = dict(bounces=CHECK_BOUNCES, frame=1, last_clear=1)
    for name, key in ((f"benchmark_scene({N_PRIMS})", "bench"),
                      ("csg_demo", "csg")):
        sspec, sparams = _scene(key, dev)
        for sort_rays in (False, True):
            order = "sorted" if sort_rays else "compacted"
            before = wf.LAUNCHES["wavefront_bounce"]
            k, p, walk_k, walk_p = _walked_frames(
                fw, wf, sspec, sparams, sort_rays, width=CHECK_W,
                height=CHECK_H, **kw)
            torch.cuda.synchronize()
            if wf.LAUNCHES["wavefront_bounce"] - before != CHECK_BOUNCES + 1:
                raise AssertionError(f"wavefront {name}: not one launch a "
                                     f"bounce")
            err = max(err, _compare(f"wavefront {name} {order} {CHECK_W}x"
                                    f"{CHECK_H}", k, p, exact=True)[1])
            print(f"wavefront {name} {order} {CHECK_W}x{CHECK_H} per-warp "
                  f"lists per bounce (summed length, lists): kernel {walk_k}, "
                  f"plain model {walk_p}; mean "
                  + ", ".join(f"{m:.2f}" for m in _walk_means(walk_k)))
            if walk_k != walk_p:
                raise AssertionError(f"wavefront {name} {order}: the "
                                     f"per-warp lists differ from the plain "
                                     f"model")
    spec, sp = _scene("bench", dev)
    main = dict(width=MAIN_W, height=MAIN_H, bounces=BOUNCES, frame=1,
                last_clear=1)
    k = fw.render_frame_wavefront(spec, sp, **main)
    k2 = mk.render_frame_megakernel(spec, sp, torch.zeros_like(k), **main)
    count = {}
    p, plain_ms = _plain_timed(lambda: fw.render_frame_wavefront(
        spec, sp, count=count, **main))
    _compare(f"wavefront {MAIN_W}x{MAIN_H} against K2's faithful exact frame",
             k, k2, exact=True)
    share, e = _compare(f"wavefront {MAIN_W}x{MAIN_H} against its plain frame",
                        k, p, exact=True)
    return {"err": max(err, e), "share": share, "plain_ms": plain_ms,
            "count": count}


def _job_edge(dev):
    """The autograd path's edge estimators (diff/vjp.py) at CHECK_W x
    CHECK_H, GRAD_BOUNCES, on the benchmark scene baked through K3: the
    image with both edge terms bit for bit the image without them; the
    gradient with them through K3 against the same with K3's plain version
    (normals detached and through the kernel), under the GRAD_* limits
    (their closest-approach marches are torch in both); and the flat
    ball's position gradient with edge_grad, nonzero and of the sign of
    the loss's central finite difference (48x48, bounces 0, the target the
    ball shifted by 0.2)."""
    import torch

    from compute_path_tracer_tpu_torch.diff import make_loss, render_image_diff
    from compute_path_tracer_tpu_torch.kernels import march as km
    from compute_path_tracer_tpu_torch.scene import (
        compile_scene, params_from_numpy)

    spec, sp = _scene("bench", dev)
    kw = dict(width=CHECK_W, height=CHECK_H, bounces=GRAD_BOUNCES,
              geometry="baked", march="kernel", normals="kernel")
    before = km.LAUNCHES["march_rays"]
    with torch.no_grad():
        smooth = render_image_diff(spec, sp, **kw)
        edge = render_image_diff(spec, sp, **EDGE, **kw)
    if km.LAUNCHES["march_rays"] == before:
        raise AssertionError("the edge images did not launch K3")
    equal = bool(torch.equal(smooth, edge))
    print(f"check edge terms leave the image, {CHECK_W}x{CHECK_H}, bounces "
          f"{GRAD_BOUNCES}: {'bit-equal' if equal else 'DIFFERENT'}")
    if not equal:
        raise AssertionError("the edge terms changed the image")
    target = smooth * 0.9

    def plain_k3(orig, *a, **k):
        return km.march_rays_plain(*a, **k)

    for normals in ("detached", "kernel"):
        gkw = dict(geometry="baked", march="kernel", normals=normals, **EDGE)
        kernel = _grad(spec, sp, target, **gkw)
        with _k3_swapped(km, plain_k3):
            plain = _grad(spec, sp, target, **gkw)
        _grad_compare(f"edge gradient through K3 vs its plain version, "
                      f"normals={normals}, {CHECK_W}x{CHECK_H}, bounces "
                      f"{GRAD_BOUNCES}", kernel, plain, GRAD_LOSS_REL,
                      GRAD_TOP_REL, GRAD_COS)

    fb = compile_scene(_flat_ball())
    p0 = params_from_numpy(fb.params, fb.spec, dev)
    sx = fb.spec.roots[0].children_shapes[0].transform.pos[0]
    shifted = p0.clone()
    shifted[sx] += 0.2
    fkw = dict(width=48, height=48, bounces=0, geometry="baked",
               march="kernel", normals="kernel")
    with torch.no_grad():
        ftarget = render_image_diff(fb.spec, shifted, **fkw)
    grads = []
    for edge_grad in (False, True):
        p = p0.clone().requires_grad_()
        make_loss(fb.spec, ftarget, edge_grad=edge_grad, **fkw)(p).backward()
        grads.append(float(p.grad[sx]))
    loss = make_loss(fb.spec, ftarget, **fkw)
    dp = torch.zeros_like(p0)
    dp[sx] = 0.1
    with torch.no_grad():
        fd = (float(loss(p0 + dp)) - float(loss(p0 - dp))) / 0.2
    print(f"check flat ball position gradient, 48x48, through K3: smooth "
          f"{grads[0]:.6e}, edge {grads[1]:.6e}, central difference "
          f"{fd:.6e}")
    if grads[0] != 0.0 or grads[1] == 0.0 or (grads[1] > 0) != (fd > 0):
        raise AssertionError("the flat ball's edge gradient is wrong")
    return {"flat_ball": (grads[1], fd)}


def _band_fn(mk, mode, n):
    """A RenderSession ``frame_fn`` that renders each frame as ``n`` row
    bands of ``render_frame_megakernel`` (``row_offset``, ``crop_h``; the
    last band takes the remainder), each into its rows of the
    accumulator."""
    import torch

    def frame_fn(spec, params, accum=None, frame=0, last_clear=0, *, width,
                 height, **kw):
        if accum is None:
            accum = torch.zeros((height, width, 3), dtype=torch.float32,
                                device=params.device)
        band = -(-height // n)
        for row0 in range(0, height, band):
            crop = min(band, height - row0)
            mk.render_frame_megakernel(
                spec, params, accum[row0:row0 + crop], frame, last_clear,
                width=width, height=height, row_offset=row0, crop_h=crop,
                **mode, **kw)
        return accum

    return frame_fn


# The band checks of the parallel job: (label, scene, width, height,
# bounces, mode); each renders two frames whole and as PARALLEL_BANDS bands.
PARALLEL_BANDS = 4
# The sharded steps' learning rate in the parallel job, a power of two
# large enough that (params - new params) / PARALLEL_LR gives the gradient
# back to float32's rounding of the gradient itself, not of the params.
PARALLEL_LR = 2.0 ** 20


def _band_cases():
    from compute_path_tracer_tpu_torch.scene import benchmark_scene

    cases = []
    for w, h, b in ((MAIN_W, MAIN_H, BOUNCES),
                    (CHECK_W, CHECK_H, CHECK_BOUNCES)):
        cases += [(f"K1 analytic_all {w}x{h}", benchmark_scene(N_PRIMS), w, h,
                   b, ANALYTIC),
                  (f"K2 baked t_cull {w}x{h}", benchmark_scene(N_PRIMS), w, h,
                   b, MARCH),
                  (f"K2 faithful {w}x{h}", benchmark_scene(N_PRIMS), w, h, b,
                   {})]
    return cases + [
        (f"K5 analytic_soa benchmark_scene(256) {CHECK_W}x{CHECK_H}",
         benchmark_scene(256), CHECK_W, CHECK_H, CHECK_BOUNCES, SOA),
        (f"K6 dist_grid {CHECK_W}x{CHECK_H}", benchmark_scene(N_PRIMS),
         CHECK_W, CHECK_H, CHECK_BOUNCES, GRID),
        (f"RELAX omega {OMEGA} {CHECK_W}x{CHECK_H}", benchmark_scene(N_PRIMS),
         CHECK_W, CHECK_H, CHECK_BOUNCES, dict(MARCH, omega=OMEGA))]


def _band_checks(mk, dev):
    """Each of ``_band_cases`` through a RenderSession rendering whole
    frames and one rendering PARALLEL_BANDS bands (``_band_fn``), two frames
    each (the second a running mean): bit for bit; and debug 4 at
    MAIN_W x MAIN_H as PARALLEL_BANDS even bands, bit for bit the whole
    frame's statistics."""
    import torch

    from compute_path_tracer_tpu_torch.app.config import Settings
    from compute_path_tracer_tpu_torch.render.session import RenderSession

    for label, scene, w, h, bounces, mode in _band_cases():
        before = dict(mk.LAUNCHES)
        imgs = []
        for frame_fn in (partial(mk.render_frame_megakernel, **mode),
                         _band_fn(mk, mode, PARALLEL_BANDS)):
            sess = RenderSession(scene, w, h, Settings(debug=0, bounces=bounces),
                                 frame_fn=frame_fn, device=dev)
            sess.step()
            imgs.append(sess.step())
        torch.cuda.synchronize()
        launched = sum(mk.LAUNCHES[k] - before[k] for k in before)
        if launched != 2 * (1 + PARALLEL_BANDS):
            raise AssertionError(f"{label}: {launched} kernel launches")
        equal = bool(torch.equal(*imgs))
        print(f"check {label} as {PARALLEL_BANDS} bands of "
              f"{-(-h // PARALLEL_BANDS)} rows, 2 frames through the session: "
              f"{'bit-equal' if equal else 'DIFFERENT'}", flush=True)
        if not equal:
            raise AssertionError(f"{label}: the bands are not the frame")
    spec, sp = _scene("bench", dev)
    kw = dict(width=MAIN_W, height=MAIN_H, bounces=BOUNCES, debug=4, **MARCH)
    whole = mk.render_frame_megakernel(spec, sp, **kw)
    bands = _band_fn(mk, {}, PARALLEL_BANDS)(spec, sp, **kw)
    torch.cuda.synchronize()
    equal = bool(torch.equal(whole, bands))
    print(f"check K2 debug 4 {MAIN_W}x{MAIN_H} as {PARALLEL_BANDS} bands: "
          f"{'bit-equal' if equal else 'DIFFERENT'}", flush=True)
    if not equal:
        raise AssertionError("debug 4's bands are not the frame's statistics")


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _job_parallel(dev):
    """parallel/: the band checks (``_band_checks``), then the four sharded
    functions through a one-rank NCCL group on the card as a main path
    (every kernel count set to 0 just before, read just after; K1, K2, K3
    and K4 must each launch): ``render_frame_sharded`` under K2 and K1 at
    MAIN_W x MAIN_H bit for bit the single-device frames,
    ``render_samples_sharded`` (2 frames) bit for bit
    ``render_accumulated_megakernel``, and at CHECK_W x CHECK_H
    ``make_sharded_train_step`` (TRAIN: the march through K3) against
    ``make_loss``'s gradient and ``make_fused_sharded_train_step`` (K4 with
    edge_grad) against ``make_fused_value_and_grad``'s: the fused loss
    equal, the autograd one and both gradients under the GRAD_* gates (the
    bands' sums and torch's scatter sums reorder the gradient's terms),
    each gradient read back from a step at PARALLEL_LR."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from compute_path_tracer_tpu_torch.diff import make_loss
    from compute_path_tracer_tpu_torch.kernels import march as km
    from compute_path_tracer_tpu_torch.kernels import megakernel as mk
    from compute_path_tracer_tpu_torch.kernels import train as tm
    from compute_path_tracer_tpu_torch.parallel import (
        make_fused_sharded_train_step, make_mesh, make_sharded_train_step,
        render_frame_sharded, render_samples_sharded)

    _band_checks(mk, dev)
    spec, sp = _scene("bench", dev)
    gen = torch.Generator(device="cpu").manual_seed(5)
    target = (torch.rand((CHECK_H, CHECK_W, 3), generator=gen) * 0.3).to(dev)
    main = dict(width=MAIN_W, height=MAIN_H, bounces=BOUNCES)
    check = dict(width=CHECK_W, height=CHECK_H, bounces=GRAD_BOUNCES)
    fused = dict(edge_grad=True)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0,
                            timeout=timedelta(seconds=300))
    try:
        mesh = make_mesh(1)
        counts = (mk.LAUNCHES, km.LAUNCHES, tm.LAUNCHES)
        for c in counts:
            for k in c:
                c[k] = 0
        t0 = time.perf_counter()
        frames = [render_frame_sharded(spec, sp, mesh, **main, **mode)
                  for mode in (MARCH, ANALYTIC)]
        samples = render_samples_sharded(spec, sp, mesh, 2, backend="kernel",
                                         **main)
        new, loss = make_sharded_train_step(
            spec, mesh, learning_rate=PARALLEL_LR, **TRAIN, **check)(
                sp, target, 0)
        fnew, floss = make_fused_sharded_train_step(
            spec, mesh, learning_rate=PARALLEL_LR, **fused, **check)(
                sp, target, 0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {k: v for c in counts for k, v in c.items()}
    finally:
        dist.destroy_process_group()
    print(f"main path parallel/ over a one-rank NCCL group: "
          f"render_frame_sharded (K2, K1) and render_samples_sharded (2 "
          f"frames) at {MAIN_W}x{MAIN_H}, the sharded and fused sharded "
          f"steps at {CHECK_W}x{CHECK_H}: {dt:.2f} s, launches {launches}",
          flush=True)
    for k in ("megakernel_march", "megakernel_analytic", "march_rays",
              "train_fused"):
        if not launches.get(k):
            raise AssertionError(f"parallel/'s main path did not launch {k}")
    for label, got, want in (
            ("render_frame_sharded K2", frames[0],
             mk.render_frame_megakernel(spec, sp, **main, **MARCH)),
            ("render_frame_sharded K1", frames[1],
             mk.render_frame_megakernel(spec, sp, **main, **ANALYTIC)),
            ("render_samples_sharded", samples,
             mk.render_accumulated_megakernel(spec, sp, 2, geometry="baked",
                                              t_cull=True, **main))):
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, want))
        print(f"check {label} over one NCCL rank, {MAIN_W}x{MAIN_H}: "
              f"{'bit-equal' if equal else 'DIFFERENT'} to the single-device "
              f"frame", flush=True)
        if not equal:
            raise AssertionError(f"{label} differs from the single device")
    single = _grad(spec, sp, target, **TRAIN)
    _grad_compare(f"make_sharded_train_step (one NCCL rank) vs make_loss, "
                  f"{CHECK_W}x{CHECK_H}", (float(loss), (sp - new) / PARALLEL_LR),
                  single,
                  GRAD_LOSS_REL, GRAD_TOP_REL, GRAD_COS)
    floss1, fgrad1 = tm.make_fused_value_and_grad(spec, target, **fused,
                                                  **check)(sp)
    fgrad = (sp - fnew) / PARALLEL_LR
    same = bool(torch.equal(fnew, sp - PARALLEL_LR * fgrad1))
    print(f"check make_fused_sharded_train_step (one NCCL rank) vs "
          f"make_fused_value_and_grad: loss {float(floss):.8e} vs "
          f"{float(floss1):.8e}, update "
          f"{'bit-equal' if same else 'different'}", flush=True)
    if float(floss) != float(floss1):
        raise AssertionError("the fused sharded loss differs")
    _grad_compare(f"make_fused_sharded_train_step vs "
                  f"make_fused_value_and_grad, {CHECK_W}x{CHECK_H}",
                  (float(floss), fgrad), (float(floss1), fgrad1),
                  GRAD_LOSS_REL, GRAD_TOP_REL, GRAD_COS)
    return {"launches": launches, "seconds": dt}


def _cli(args, timeout=300):
    """``python -m compute_path_tracer_tpu_torch ARGS`` in a process of its
    own: (exit code, output, errors)."""
    run = subprocess.run(
        [sys.executable, "-m", "compute_path_tracer_tpu_torch", *args],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=timeout)
    return run.returncode, run.stdout, run.stderr


def _cli_resume(dev, tmp):
    """``render --checkpoint`` after 2 frames, then ``render --resume`` for
    2 more in a new process, against 4 frames in one run, under each mode
    of RESUME_MODES at CHECK_W x CHECK_H: the accumulators bit for bit.
    The uninterrupted and the interrupted run are in this process, so the
    kernel's launches are counted.  Returns the runs' (label, exit code,
    output, errors)."""
    import numpy as np

    from compute_path_tracer_tpu_torch.app.cli import main as cli_main
    from compute_path_tracer_tpu_torch.io import load_checkpoint
    from compute_path_tracer_tpu_torch.kernels import megakernel as mk

    runs = []
    for mode, kernel in RESUME_MODES:
        ck = {k: os.path.join(tmp, f"{mode}_{k}") for k in ("full", "half",
                                                            "resumed")}
        base = ["render", "--device", str(dev), "--mode", mode, "--scene",
                "benchmark_scene", "--width", str(CHECK_W), "--height",
                str(CHECK_H), "--bounces", str(CHECK_BOUNCES), "--out",
                os.path.join(tmp, f"{mode}.png")]
        before = mk.LAUNCHES[kernel]
        for frames, key in ((4, "full"), (2, "half")):
            if cli_main(base + ["--frames", str(frames), "--checkpoint",
                                ck[key]]) != 0:
                raise AssertionError(f"render --mode {mode} failed")
        if mk.LAUNCHES[kernel] - before != 6:
            raise AssertionError(f"render --mode {mode} launched "
                                 f"{dict(mk.LAUNCHES)}")
        rc, out, err = _cli(base + ["--frames", "2", "--resume", ck["half"],
                                    "--checkpoint", ck["resumed"]])
        full, resumed = load_checkpoint(ck["full"]), load_checkpoint(
            ck["resumed"])
        equal = (rc == 0 and np.array_equal(full["accum"], resumed["accum"])
                 and (resumed["frame"], resumed["last_clear"]) == (4, 4))
        out += (f"resume: 2 + 2 frames {'bit-equal' if equal else 'DIFFERENT'}"
                f" to 4 frames ({kernel})\n")
        runs.append((f"cli render --mode {mode} --checkpoint, then --resume "
                     f"in a new process", 0 if equal else 1, out, err))
    return runs


def _cli_demo(dev, tmp):
    """``demo --max-events 2`` in a process of its own over a temporary
    scene JSON, edited once by value (the ball's size) and once by
    structure (a cube added) once the demo has reported each step; returns
    (label, exit code, output, errors)."""
    from compute_path_tracer_tpu_torch.scene import sphere_and_plane
    from compute_path_tracer_tpu_torch.scene.io import load_scene, save_scene
    from compute_path_tracer_tpu_torch.scene.model import KIND_CUBE, Shape

    path = os.path.join(tmp, "live.json")
    save_scene(sphere_and_plane(), path)

    def edit(change, bump):
        """One change, seen by the demo's poll as one new mtime: the file
        is written aside with its mtime set, then moved into place."""
        scene = load_scene(path)
        change(scene)
        aside = path + ".new"
        save_scene(scene, aside)
        mtime = os.stat(path).st_mtime + bump
        os.utime(aside, (mtime, mtime))
        os.replace(aside, path)

    demo = subprocess.Popen(
        [sys.executable, "-u", "-m", "compute_path_tracer_tpu_torch", "demo",
         "--device", str(dev), "--scene", path, "--width", "160", "--height",
         "90", "--frames", "2", "--bounces", "2",
         "--max-events", "2", "--out", os.path.join(tmp, "live.png")],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    lines = []
    steps = (("initial render", lambda s: s.roots[0].children_shapes[0]
              .size.set(1.2), 1),
             ("[value edit]", lambda s: s.roots[0].add_shape(
                 Shape(KIND_CUBE, name="New")), 2),
             ("[structure edit]", None, 0))
    try:
        for marker, change, bump in steps:
            while not any(marker in line for line in lines):
                line = demo.stdout.readline()
                if not line:
                    break
                lines.append(line)
            if change is not None:
                edit(change, bump)
        rc = demo.wait(timeout=120)
    finally:
        if demo.poll() is None:
            demo.kill()
    return ("cli demo --max-events 2 (a value edit, then a structure edit)",
            rc, "".join(lines), demo.stderr.read())


def _tui_check(dev):
    """A TuiController over a card session (K2, 64x64): one frame, a
    nudge of a position (a refresh: the same spec object), an AABB toggle
    (a recompile: a new spec), one frame after each; returns the status
    lines."""
    from compute_path_tracer_tpu_torch.app.config import Settings
    from compute_path_tracer_tpu_torch.app.tui import TuiController
    from compute_path_tracer_tpu_torch.kernels import megakernel as mk
    from compute_path_tracer_tpu_torch.render.session import RenderSession
    from compute_path_tracer_tpu_torch.scene import csg_demo

    before = mk.LAUNCHES["megakernel_march"]
    ctl = TuiController(RenderSession(csg_demo(), 64, 64, Settings(
        debug=0, bounces=2), device=dev))
    ctl.render_ascii(32, 8)
    spec = ctl.session.compiled.spec
    ctl.sel = next(i for i, r in enumerate(ctl.rows)
                   if r.kind == "param" and r.label == "pos.x")
    kinds = [ctl.nudge(+1)[0]]
    same = ctl.session.compiled.spec is spec
    ctl.render_ascii(32, 8)
    ctl.sel = next(i for i, r in enumerate(ctl.rows) if r.kind == "flag")
    kinds.append(ctl.toggle()[0])
    lines = ctl.render_ascii(32, 8)
    launched = mk.LAUNCHES["megakernel_march"] - before
    ok = (kinds == ["refresh", "recompile"] and same and launched == 3
          and ctl.session.compiled.spec is not spec
          and any(c != " " for line in lines for c in line))
    return ("tui: nudge then AABB toggle on a card session",
            0 if ok else 1, f"{kinds}, spec kept on the nudge {same}, K2 "
            f"launches {launched}, status {ctl.status}\n", "")


def _job_cli(dev):
    """The CLI's ``optimize`` (plain, with ``--fused --edge-grad``, and with
    ``--edge-grad --edge-secondary`` on the autograd path), ``render
    --checkpoint`` and ``--resume`` (``_cli_resume``) and ``demo``
    (``_cli_demo``), each CLI run in a process of its own, and the TUI's
    controller over a card session (``_tui_check``); returns (label, exit
    code, output, errors, the text its output must hold) of each."""
    runs = []
    for label, args, expect in (
            ("cli optimize --steps 10", ["--steps", "10"], "final loss"),
            ("cli optimize --fused --edge-grad --perturb-what position",
             ["--fused", "--edge-grad", "--perturb-what", "position",
              "--scene", "edge_demo", "--bounces", "0", "--perturb", "0.3",
              "--steps", "40", "--width", "48", "--height", "48"],
             "recovered"),
            ("cli optimize --edge-grad --edge-secondary (autograd path)",
             ["--edge-grad", "--edge-secondary", "--steps", "3", "--width",
              "48", "--height", "48"], "final loss")):
        runs.append((label, *_cli(["optimize", *args]), expect))
    with tempfile.TemporaryDirectory() as tmp:
        runs += [(*r, "bit-equal") for r in _cli_resume(dev, tmp)]
        runs.append((*_cli_demo(dev, tmp), "[structure edit]"))
    runs.append((*_tui_check(dev), "recompile"))
    return {"runs": runs}


def _job_k4(dev):
    """``_k4_check_cases``' march and analytic_all cases."""
    return {"k4_err": _k4_check_cases(dev, unboxed=False)}


def _job_k4b(dev):
    """``_k4_check_cases``' analytic_unboxed cases and the band check."""
    return {"k4b_err": _k4_check_cases(dev, unboxed=True)}


def _job_d4(dev):
    """``_d4_check_cases``."""
    return {"d4_err": _d4_check_cases(dev)}


JOBS = {"k2 even": partial(_job_k2, part=0),
        "k2 odd": partial(_job_k2, part=1),
        "k2b": _job_k2b, "k5": _job_k5, "k6": _job_k6, "k3": _job_k3,
        "gradients through k3": _job_grad, "k4": _job_k4, "k4b": _job_k4b,
        "debug 4": _job_d4, "k2 1080p": _job_k2_main,
        "k2 exact and refresh 1080p": _job_k2x_main,
        "k2b 1080p": _job_k2b_main, "k6 1080p": _job_k6_main,
        "k4b 1080p": _job_k4b_main, "wavefront": _job_wavefront,
        "cli": _job_cli, "edge": _job_edge, "parallel": _job_parallel}
# The kernel-vs-plain checks run in CHECK_WORKERS processes of this script
# (CHECK_WORKER), one a group, all started after the build and joined before
# the first timed phase, so no timing overlaps them: they are host-bound
# plain passes (the card is mostly idle under each), and one after another
# they took most of the script's time.  The groups balance the jobs' times
# on the card (each job prints its own).
CHECK_WORKER = "--check-worker"
CHECK_WORKERS = (("k6",), ("k2b", "k5"), ("debug 4", "parallel"),
                 ("k4b", "k4b 1080p"), ("k4", "k6 1080p"), ("k2 odd", "k3"),
                 ("wavefront", "gradients through k3"),
                 ("k2 even", "k2 exact and refresh 1080p", "k2b 1080p"),
                 ("cli", "edge", "k2 1080p"))


def _to_host(obj):
    """``obj`` with every tensor in it moved to the host, for the pickle."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.cpu()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _check_worker(out, names) -> int:
    """CHECK_WORKER's process: the jobs ``names`` on the card one after
    another, each one's time printed, their results pickled to ``out``."""
    import pickle

    import torch

    dev = torch.device("cuda")
    results = {}
    for name in names:
        t0 = time.perf_counter()
        results[name] = _to_host(JOBS[name](dev))
        torch.cuda.synchronize()
        print(f"[job {name}: {time.perf_counter() - t0:.1f} s, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB]",
              flush=True)
        torch.cuda.empty_cache()
    with open(out, "wb") as f:
        pickle.dump(results, f)
    return 0


def _start_workers():
    """Starts one CHECK_WORKER process a group of CHECK_WORKERS, its output
    to a temporary file; each is killed at exit if it still runs."""
    import atexit

    tmp = tempfile.TemporaryDirectory()
    atexit.register(tmp.cleanup)
    workers = []
    for i, names in enumerate(CHECK_WORKERS):
        log = tempfile.TemporaryFile(mode="w+")
        out = os.path.join(tmp.name, f"worker{i}.pickle")
        child = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), CHECK_WORKER, out,
             *names], stdout=log, stderr=subprocess.STDOUT, text=True,
            env=dict(os.environ, OMP_NUM_THREADS="1"))
        atexit.register(lambda c=child: c.poll() is None and c.kill())
        workers.append((names, child, log, out))
    return workers


def _join_workers(workers):
    """Waits for every worker, prints its output and returns the jobs'
    results by name; raises if one failed (the others are killed at
    exit)."""
    import pickle

    results = {}
    for names, child, log, out in workers:
        rc = child.wait()
        log.seek(0)
        print(f"-- check worker {', '.join(names)} (exit {rc}):", flush=True)
        print(log.read(), end="", flush=True)
        log.close()
        if rc != 0:
            raise AssertionError(f"the check worker {names} failed ({rc})")
        with open(out, "rb") as f:
            results.update(pickle.load(f))
    return results


def _edge_cull_count(spec, params, dev):
    """Primary rays at CHECK_W x CHECK_H whose closest approach (d_min,
    t_min, i_min) differs between the exact march K4's edge term takes and
    K2's per-thread t-culled march, with the plain versions.  Returns
    (rays, differing, differing ids, near misses, differing near misses)."""
    import torch

    from compute_path_tracer_tpu_torch.constants import BIG, FP, MHD, STEPS
    from compute_path_tracer_tpu_torch.render.program import (
        _on_device, build_program, make_map_program, program_bounds,
        program_table)
    from compute_path_tracer_tpu_torch.render.reference import (
        camera_rays, cast_ray, take_lanes)
    from compute_path_tracer_tpu_torch.vecmath import Vec3

    prog = build_program(spec, "baked")
    table = program_table(prog, params, True)
    mf = make_map_program(prog, table.tolist())
    ys, xs = torch.meshgrid(
        torch.arange(CHECK_H, dtype=torch.int32, device=dev),
        torch.arange(CHECK_W, dtype=torch.int32, device=dev), indexing="ij")
    _, ro, rd = camera_rays(xs, ys, 0, 1.0, CHECK_W / CHECK_H, width=CHECK_W,
                            height=CHECK_H)
    checks, _ = program_bounds(prog, table, ro, rd, True)
    _, _, da, ta = cast_ray(lambda q, c: mf(q, c[0]), ro, rd, checks[:1],
                            closest=True)
    cull = _on_device(prog, dev).cull
    n = ro.x.shape[0]
    db, tb = torch.full((n,), BIG, device=dev), torch.zeros(n, device=dev)
    live, lt = torch.arange(n, device=dev), torch.zeros(n, device=dev)
    r, d_, ck = ro, rd, checks
    for _ in range(STEPS):
        if live.numel() == 0:
            break
        chk, lo, hi = ck
        tt = lt[:, None]
        act = chk & (~cull | ((lo <= tt) & (hi >= tt)))
        m = torch.where(chk & cull & (lo > tt), lo,
                        torch.full_like(lo, BIG)).amin(1)
        d, _ = mf(r + d_ * lt, act)
        better = d < db[live]
        db[live] = torch.where(better, d, db[live])
        tb[live] = torch.where(better, lt, tb[live])
        nt = lt + torch.minimum(d.abs(), torch.clamp(m - lt, min=MHD))
        keep = ~((d.abs() < MHD) | (nt > FP))
        live, lt = live[keep], nt[keep]
        r, d_ = (Vec3(v.x[keep], v.y[keep], v.z[keep]) for v in (r, d_))
        ck = take_lanes(ck, keep)
    ia, ib = mf(ro + rd * ta, checks[0])[1], mf(ro + rd * tb, checks[0])[1]
    ia = torch.where(da < 0.5 * BIG, ia, -1)
    ib = torch.where(db < 0.5 * BIG, ib, -1)
    diff = (da != db) | (ta != tb) | (ia != ib)
    near = (da > MHD) & (da < 0.2)
    return (n, int(diff.sum()), int((ia != ib).sum()), int(near.sum()),
            int((diff & near).sum()))


def _drive_fused(tm, others, spec, params, gpu, label, kw):
    """A fused configuration at 1080p: one warm-up step and TIMED_STEPS
    timed ones, every kernel count set to 0 just before and read just
    after; each step must launch K4 once and no other kernel.  Returns (K4
    launches, K4 ms per launch, ms per step, peak bytes)."""
    import torch

    step = tm.make_fused_value_and_grad(
        spec, torch.zeros((MAIN_H, MAIN_W, 3), device=params.device),
        width=MAIN_W, height=MAIN_H, bounces=BOUNCES, **kw)
    events = []

    def timed(orig, *a, **k):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig(*a, **k)
        end.record()
        events.append((start, end))
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for counts in (tm.LAUNCHES, *others):
        for k in counts:
            counts[k] = 0
    losses = [float(step(params)[0])]
    torch.cuda.synchronize()
    with _k4_swapped(tm, timed):
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            loss, grad = step(params)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    losses.append(float(loss))
    launches = tm.LAUNCHES["train_fused"]
    if launches != TIMED_STEPS + 1 or any(v for c in others for v in c.values()):
        raise AssertionError(f"fused steps launched {dict(tm.LAUNCHES)} and "
                             f"{[dict(c) for c in others]}")
    if not bool(torch.isfinite(grad).all()) or float(grad.abs().max()) == 0:
        raise AssertionError(f"{label}: the gradient is not finite and non-zero")
    k4_ms = sum(a.elapsed_time(b) for a, b in events) / TIMED_STEPS
    step_ms = dt / TIMED_STEPS * 1e3
    peak = torch.cuda.max_memory_allocated()
    print(f"main path fused step, {label}: {MAIN_W}x{MAIN_H}, {N_PRIMS} prims, "
          f"{BOUNCES} bounces: {step_ms:.3f} ms/step, "
          f"{MAIN_W * MAIN_H * (BOUNCES + 1) / (dt / TIMED_STEPS):.4e} rays/s, "
          f"K4 {launches / (TIMED_STEPS + 1):.2f} launches/step, "
          f"{k4_ms:.3f} ms/launch, peak memory {peak / 2**30:.3f} GiB, "
          f"losses {losses}, gradient finite [{gpu}]")
    return launches, k4_ms, step_ms, peak


def main() -> int:
    start = time.perf_counter()
    import torch

    if sys.argv[1:2] == [CHECK_WORKER]:
        return _check_worker(sys.argv[2], sys.argv[3:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; run this on an NVIDIA GPU",
              file=sys.stderr)
        return 1

    import numpy as np

    from compute_path_tracer_tpu_torch.app import profiling as pf
    from compute_path_tracer_tpu_torch.app.config import Settings
    from compute_path_tracer_tpu_torch.benchmarks import (
        analytic_probe, bf16_probe, dense_probe, frozen_wavefront,
        gather_probe, ilp_probe, mxu_transform_probe, probe_fused_bwd,
        probe_inkernel_segsum, vpu_peak)
    from compute_path_tracer_tpu_torch.benchmarks.common import (
        cuda_ms, probe_rays)
    from compute_path_tracer_tpu_torch.constants import DEFAULT_FOV
    from compute_path_tracer_tpu_torch.diff import (
        optimize_to_target, render_image_diff)
    from compute_path_tracer_tpu_torch.io.png import load_png_rgba
    from compute_path_tracer_tpu_torch.kernels import build
    from compute_path_tracer_tpu_torch.kernels import grad_probes as gp
    from compute_path_tracer_tpu_torch.kernels import hw_probes as hp
    from compute_path_tracer_tpu_torch.kernels import march as km
    from compute_path_tracer_tpu_torch.kernels import megakernel as mk
    from compute_path_tracer_tpu_torch.kernels import probes as pr
    from compute_path_tracer_tpu_torch.kernels import train as tm
    from compute_path_tracer_tpu_torch.kernels import wavefront as wf
    from compute_path_tracer_tpu_torch.render.reference import camera_rays
    from compute_path_tracer_tpu_torch.render.baked import bake
    from compute_path_tracer_tpu_torch.render.distgrid import make_dist_grid
    from compute_path_tracer_tpu_torch.render.program import (
        build_program, program_table)
    from compute_path_tracer_tpu_torch.render.session import RenderSession
    from compute_path_tracer_tpu_torch.render import soa as ts
    from compute_path_tracer_tpu_torch.render.soa import (
        build_soa_smem_layout, pack_soa_smem)
    from compute_path_tracer_tpu_torch.scene import (
        benchmark_scene, compile_scene, params_from_numpy)

    gpu = pf.gpu_line()
    dev = torch.device("cuda")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    print(f"gpu: {gpu}; compute mode {pf.gpu_line('compute_mode')}")

    # -- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = build.build(verbose=True)
    mk.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib_path}")
    workers = _start_workers()
    walk_ptxas = _ptxas_walk(build)
    k1_ptxas = _ptxas_k1(build)
    probe_ptxas = _ptxas_probes(build)
    sass = build.sass()
    bf16_sass = _bf16_sass(sass)
    mxu_sass = _mxu_sass(sass)
    gather_sass = _gather_sass(sass)
    seg_sass = _segsum_sass(sass)

    bench = _scene("bench", dev)
    spec = bench[0]
    glass, clobber = _scene("glass", dev), _scene("clobber", dev)
    prior = _prior(dev)

    _stamp(start, "K1 quotient")
    quotient = _quotient_phase(mk, ts, dev)

    _stamp(start, "K1 checks")
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
    # The persistent schedule's edge tiles: a frame that is not a multiple
    # of the 16x2 tile in either direction.
    rw, rh = K1_RAGGED
    before = mk.LAUNCHES["megakernel_analytic"]
    k = mk.render_frame_megakernel(*bench, width=rw, height=rh, **b8)
    p = mk.render_frame_megakernel_plain(*bench, width=rw, height=rh, **b8)
    torch.cuda.synchronize()
    if mk.LAUNCHES["megakernel_analytic"] - before != 1:
        raise AssertionError("the ragged K1 check did not launch K1")
    k1_err = max(k1_err, _compare(f"K1 {rw}x{rh}, ragged tiles", k, p,
                                  exact=True)[1])
    del k, p

    _stamp(start, "joining the check workers")
    checks = _join_workers(workers)
    k2_err = max(checks[k]["k2_err"] for k in ("k2 even", "k2 odd"))
    k2b_err, k5_err = checks["k2b"]["k2b_err"], checks["k5"]["k5_err"]
    k6_err, d4_err = checks["k6"]["k6_err"], checks["debug 4"]["d4_err"]
    csg, cube = _scene("csg", dev), _scene("cube", dev)
    sap = _scene("sap", dev)

    _stamp(start, "png export")
    _png_export_phase(mk.render_frame_megakernel(
        *bench, width=MAIN_W, height=MAIN_H, bounces=BOUNCES,
        **MARCH).cpu().numpy(), gpu)

    _stamp(start, "K1 main path")
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
        bake_ms = cuda_ms(bake_pack, 20)
        soa_f, soa_i = bake_pack()
    scratch = sess.accum.clone()
    k1_ms = cuda_ms(lambda: mk.launch_megakernel(
        layout, soa_f, soa_i, scratch, frame=1, last_clear=1, bounces=BOUNCES,
        fov=sess.settings.fov, aspect=sess.aspect, debug=0), 5)
    k1_count = {}
    k1_share, k1_main_err, k1_plain_ms = _main_shape_check(
        mk, "megakernel_analytic", spec, sp, ANALYTIC, count=k1_count)
    k1_err = max(k1_err, k1_main_err)
    print(f"K1 layers at {MAIN_W}x{MAIN_H}: bake+pack {bake_ms:.3f} ms, kernel "
          f"{k1_ms:.3f} ms, plain torch frame {k1_plain_ms:.3f} ms while "
          f"counting [{gpu}]")
    k1_lanes = _lane_stats(mk, pf, ts, spec, sp, ANALYTIC, "K1", gpu)

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

    _stamp(start, "K2 main path")
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
        table_ms = cuda_ms(lambda: program_table(prog, sp, True), 20)
        table = program_table(prog, sp, True)
    scratch = sess.accum.clone()
    run = dict(frame=1, last_clear=1, bounces=BOUNCES, fov=sess.settings.fov,
               aspect=sess.aspect, t_cull=True)
    k2_ms = cuda_ms(lambda: mk.launch_march(prog, table, scratch, debug=0,
                                             **run), 5)
    d4_ms = cuda_ms(lambda: mk.launch_march(prog, table, scratch, debug=4,
                                             **run), 5)
    # One plain pass gives K2's frame, its work count and debug 4's
    # statistics: debug 4 traces debug 0's paths (a check worker's job).
    k2m = checks["k2 1080p"]
    k2_count, k2_share, k2_plain_ms = k2m["count"], k2m["share"], k2m["plain_ms"]
    k2_err = max(k2_err, k2m["err"])
    # The same frame's per-warp lists: the kernel's summed lengths and list
    # counts per bounce against the plain pass's model of them.
    walk = torch.zeros(2 * (BOUNCES + 1), dtype=torch.int64, device=dev)
    mk.launch_march(prog, table, torch.zeros_like(scratch), frame=0,
                    last_clear=0, bounces=BOUNCES, fov=DEFAULT_FOV,
                    aspect=MAIN_W / MAIN_H, debug=0, t_cull=True,
                    walk_stats=walk)
    walk_k = walk.view(BOUNCES + 1, 2).tolist()
    walk_p = k2m["walk"]
    walk_p += [[0, 0]] * (BOUNCES + 1 - len(walk_p))
    walk_mean = _walk_means(walk_k)
    print(f"K2 per-warp lists at {MAIN_W}x{MAIN_H}, frame 0, per bounce "
          f"(summed length, lists): kernel {walk_k}, plain model {walk_p}; "
          f"mean list length "
          + ", ".join(f"{m:.2f}" for m in walk_mean)
          + f" of {prog.ops.shape[0]} records [{gpu}]")
    if walk_k != walk_p:
        raise AssertionError("K2's per-warp lists differ from the plain model")
    print(f"K2 layers at {MAIN_W}x{MAIN_H}: program table {table_ms:.3f} ms, "
          f"kernel {k2_ms:.3f} ms, plain torch frame {k2_plain_ms:.3f} ms "
          f"while counting and taking debug 4's statistics [{gpu}]")
    # Debug 4 at 1080p against the plain pass's statistics (the same job).
    d4_share, d4_err = k2m["d4_share"], max(d4_err, k2m["d4_err"])
    warps = k2m["warps"]
    lane_steps, lane_shapes, lane_aux = k2m["lanes"]
    simt = lane_shapes / (32 * warps[:, 1].sum())
    print(f"K2 debug 4 at {MAIN_W}x{MAIN_H}: kernel {d4_ms:.3f} ms against "
          f"debug 0's {k2_ms:.3f} ms in this call (x{d4_ms / k2_ms:.3f}); "
          f"{warps.shape[0]} warps, steps per warp mean "
          f"{warps[:, 0].mean():.1f} max {warps[:, 0].max():.0f}; warp SIMT "
          f"share of the march's guarded-leaf slots {simt:.4f} ({lane_shapes} "
          f"lane evaluations of {32 * warps[:, 1].sum():.0f}), of its "
          f"iterations {lane_steps / (32 * warps[:, 0].sum()):.4f}, of the "
          f"normal taps' slots {lane_aux / (32 * warps[:, 2].sum()):.4f} "
          f"[{gpu}]")
    # Debug 4's main path: the measured work of a frame (app/profiling.py).
    for k in mk.LAUNCHES:
        mk.LAUNCHES[k] = 0
    cost = pf.measured_frame_cost(spec, sp, width=MAIN_W, height=MAIN_H,
                                  bounces=BOUNCES)
    torch.cuda.synchronize()
    d4_launches = mk.LAUNCHES["megakernel_march"]
    if dict(mk.LAUNCHES) != {"megakernel_analytic": 0, "megakernel_march": 1}:
        raise AssertionError(f"measured_frame_cost launched "
                             f"{dict(mk.LAUNCHES)}")
    if not cost["march_steps_total"] > 0 or not cost["aux_evals"] > 0:
        raise AssertionError(f"measured_frame_cost: {cost}")
    print(f"main path debug 4, measured_frame_cost at {MAIN_W}x{MAIN_H}, "
          f"{BOUNCES} bounces: {cost} [{gpu}]")

    # -- work counts and bounds of K1 and K2 per main-path frame -----------
    peak = pf.fp32_peak()
    frame_bytes = MAIN_H * MAIN_W * 3 * 4 * 2  # the accumulator, read and written
    k1_bound, k1_by = pf.bound_ms(frame_bytes + 4 * layout.f_len,
                                  pf.analytic_ops(k1_count["segments"], prog),
                                  peak)
    k2_bound, k2_by = pf.bound_ms(frame_bytes + 4 * prog.f_len,
                                  pf.march_ops(k2_count, prog), peak)
    # Debug 4 does debug 0's work and writes the accumulator once.
    d4_bound, d4_by = pf.bound_ms(frame_bytes // 2 + 4 * prog.f_len,
                                  pf.march_ops(k2_count, prog), peak)
    print(f"work per {MAIN_W}x{MAIN_H} frame: K1 {k1_count['segments']} ray "
          f"segments, bound {k1_bound:.4f} ms ({k1_by}); K2 "
          f"{k2_count['segments']} segments, {k2_count['taps']} map taps, "
          f"leaves by kind { {k: int(v) for k, v in k2_count.items() if isinstance(k, int)} }, "
          f"bound {k2_bound:.4f} ms ({k2_by}); FP32 peak {peak / 1e12:.2f} "
          f"TFLOP/s [{gpu}]")
    k2_omega_ms = cuda_ms(lambda: mk.launch_march(
        prog, table, scratch, debug=0, omega=OMEGA, **run), 5)
    print(f"K2 with omega {OMEGA} at {MAIN_W}x{MAIN_H}: kernel "
          f"{k2_omega_ms:.3f} ms [{gpu}]")
    del sess, scratch

    _stamp(start, "K2 exact normals and refresh_every")
    # -- K2's normals="autodiff" and refresh_every: main paths, A B B A -----
    with torch.no_grad():
        grid16 = make_dist_grid(spec, bake(spec, sp))
    xr_rows = _exact_refresh_phase(mk, pf, spec, sp, prog, table, grid16,
                                   peak, frame_bytes, checks, gpu)
    del grid16

    _stamp(start, "band split")
    # -- K1 and K2 as PARALLEL_BANDS band launches (parallel/'s bands) -------
    band_split = _band_split(mk, cuda_ms, spec, sp, gpu)
    print(f"parallel/ main path (the check worker's one-rank NCCL group): "
          f"{checks['parallel']['seconds']:.2f} s, launches "
          f"{checks['parallel']['launches']}")

    _stamp(start, "K2b main path")
    # -- K2b main path: RenderSession at 1080p, analytic_unboxed ------------
    sess = RenderSession(benchmark_scene(N_PRIMS), MAIN_W, MAIN_H,
                         Settings(debug=0, bounces=BOUNCES),
                         frame_fn=partial(mk.render_frame_megakernel, **UNBOXED),
                         device=dev)
    k2b_launches = _drive_session(mk, "megakernel_march", sess,
                                  "K2b analytic_unboxed (baked, t_cull)", gpu)
    sp = sess.params
    uprog = build_program(spec, "baked", True)
    with torch.no_grad():
        utable = program_table(uprog, sp, True)
    scratch = sess.accum.clone()
    run = dict(frame=1, last_clear=1, bounces=BOUNCES, fov=sess.settings.fov,
               aspect=sess.aspect, debug=0, t_cull=True)
    k2b_ms = cuda_ms(lambda: mk.launch_march(uprog, utable, scratch, **run), 5)
    k2_same_call_ms = cuda_ms(lambda: mk.launch_march(prog, table, scratch,
                                                       **run), 5)
    # Its 1080p plain pass, held to the kernel, counts its work (a check
    # worker's job).
    k2bm = checks["k2b 1080p"]
    k2b_count, k2b_share, k2b_plain_ms = (k2bm["count"], k2bm["share"],
                                          k2bm["plain_ms"])
    k2b_err = max(k2b_err, k2bm["err"])
    k2b_bound, k2b_by = pf.bound_ms(frame_bytes + 4 * uprog.f_len,
                                    pf.march_ops(k2b_count, uprog)
                                    + pf.cap_ops(k2b_count, uprog), peak)
    print(f"K2b layers at {MAIN_W}x{MAIN_H}: kernel {k2b_ms:.3f} ms (the "
          f"t-culled K2 {k2_same_call_ms:.3f} ms in this call), plain torch "
          f"frame {k2b_plain_ms:.3f} ms while counting; work "
          f"{k2b_count['segments']} segments, {k2b_count['taps']} map taps, "
          f"leaves by kind { {k: int(v) for k, v in k2b_count.items() if isinstance(k, int)} }, "
          f"{k2b_count['cap_segments']} capped segments of {uprog.caps.shape[0]}"
          f" shapes; bound {k2b_bound:.4f} ms ({k2b_by}) [{gpu}]")
    del sess, scratch

    _stamp(start, "K5 main paths")
    # -- K5 main path: RenderSession at 1080p, analytic_soa ----------------
    k5 = {}
    for n in SOA_PRIMS:
        sess = RenderSession(benchmark_scene(n), MAIN_W, MAIN_H,
                             Settings(debug=0, bounces=BOUNCES),
                             frame_fn=partial(mk.render_frame_megakernel, **SOA),
                             device=dev)
        launches = _drive_session(mk, "megakernel_analytic", sess,
                                  "K5 analytic_soa", gpu, prims=n)
        nspec, nparams = sess.compiled.spec, sess.params
        nlayout = build_soa_smem_layout(nspec)
        with torch.no_grad():
            nf, ni = pack_soa_smem(nlayout, bake(nspec, nparams), nparams)
        scratch = sess.accum.clone()
        ms = cuda_ms(lambda: mk.launch_megakernel(
            nlayout, nf, ni, scratch, frame=1, last_clear=1, bounces=BOUNCES,
            fov=sess.settings.fov, aspect=sess.aspect, debug=0), 5)
        count = {}
        share, main_err, plain_ms = _main_shape_check(
            mk, "megakernel_analytic", nspec, nparams, SOA,
            f"K5 analytic_soa, {n} prims", count)
        k5_err[n] = max(k5_err[n], main_err)
        bound, by = pf.bound_ms(frame_bytes + 4 * nlayout.f_len,
                                pf.soa_ops(count["segments"], nlayout), peak)
        k5[n] = (launches, ms, plain_ms, bound, by, share,
                 _lane_stats(mk, pf, ts, nspec, nparams, SOA,
                             f"K5 {n} prims", gpu))
        print(f"K5 layers at {MAIN_W}x{MAIN_H}, {n} prims: kernel {ms:.3f} ms, "
              f"plain torch frame {plain_ms:.3f} ms while counting; "
              f"{count['segments']} segments, tables {4 * nlayout.f_len} + "
              f"{4 * nlayout.i_len} bytes; bound {bound:.4f} ms ({by}) [{gpu}]")
        del sess, scratch

    _stamp(start, "K6 main path")
    # -- K6 main path: RenderSession at 1080p, the march on the grid --------
    sess = RenderSession(benchmark_scene(N_PRIMS), MAIN_W, MAIN_H,
                         Settings(debug=0, bounces=BOUNCES),
                         frame_fn=partial(mk.render_frame_megakernel, **GRID),
                         device=dev)
    k6_launches = _drive_session(mk, "megakernel_march", sess,
                                 "K6 dist_grid (baked, t_cull)", gpu)
    sp = sess.params
    with torch.no_grad():
        bv = bake(spec, sp)
        table = program_table(prog, sp, True, bv)
        utable = program_table(uprog, sp, True, bv)
        grid_ms = cuda_ms(lambda: make_dist_grid(spec, bake(spec, sp)), 20)
    scratch = sess.accum.clone()
    run = dict(frame=1, last_clear=1, bounces=BOUNCES, fov=sess.settings.fov,
               aspect=sess.aspect, debug=0, t_cull=True)
    rows = {"K2 (t_cull)": cuda_ms(lambda: mk.launch_march(
                prog, table, scratch, **run), 5),
            "K2b (analytic_unboxed)": cuda_ms(lambda: mk.launch_march(
                uprog, utable, scratch, **run), 5)}
    for r in GRID_RES:
        grid = make_dist_grid(spec, bv, (r, r, r))
        rows[f"K6 {r}^3"] = cuda_ms(lambda: mk.launch_march(
            prog, table, scratch, grid=grid, **run), 5)
    grid = make_dist_grid(spec, bv, (16, 16, 16), GRID_TAU_WIDE)
    rows[f"K6 16^3, grid_tau {GRID_TAU_WIDE}"] = cuda_ms(
        lambda: mk.launch_march(prog, table, scratch, grid=grid, **run), 5)
    grid = make_dist_grid(spec, bv)
    rows["K6 16^3 + analytic_unboxed"] = cuda_ms(lambda: mk.launch_march(
        uprog, utable, scratch, grid=grid, **run), 5)
    k6_ms = rows["K6 16^3"]
    print(f"K6 kernel-only times at {MAIN_W}x{MAIN_H}, {BOUNCES} bounces, "
          f"CUDA events over 5 launches, one call: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in rows.items())
          + f"; grid bake {grid_ms:.3f} ms [{gpu}]")
    stats = torch.zeros(5, dtype=torch.int64, device=dev)
    mk.launch_march(prog, table, scratch, grid=grid, grid_stats=stats, **run)
    w_it, w_ex, w_mix, l_ex, l_ch = stats.tolist()
    print(f"K6 warp statistics at 16^3 (one frame): {w_it} warp-iterations, "
          f"{w_ex} with an exact tap ({w_mix} of them mixed with cheap "
          f"steps); lane steps {l_ex} exact, {l_ch} cheap; exact taps fill "
          f"{l_ex / max(32 * w_ex, 1):.4f} of their warps' lanes [{gpu}]")
    # Its 1080p plain pass, held to the kernel, counts its work and models
    # the per-warp lists (a check worker's job).
    k6m = checks["k6 1080p"]
    k6_count, k6_share, k6_plain_ms = k6m["count"], k6m["share"], k6m["plain_ms"]
    k6_err = max(k6_err, k6m["err"])
    # The same frame's per-warp lists, against the plain pass's model.
    walk = torch.zeros(2 * (BOUNCES + 1), dtype=torch.int64, device=dev)
    mk.launch_march(prog, table, torch.zeros_like(scratch), frame=0,
                    last_clear=0, bounces=BOUNCES, fov=DEFAULT_FOV,
                    aspect=MAIN_W / MAIN_H, debug=0, t_cull=True, grid=grid,
                    walk_stats=walk)
    walk_k = walk.view(BOUNCES + 1, 2).tolist()
    walk_p = k6m["walk"]
    walk_p += [[0, 0]] * (BOUNCES + 1 - len(walk_p))
    k6_walk_mean = _walk_means(walk_k)
    print(f"K6 per-warp lists at {MAIN_W}x{MAIN_H}, frame 0, per bounce "
          f"(summed length, lists): kernel {walk_k}, plain model {walk_p}; "
          f"mean list length "
          + ", ".join(f"{m:.2f}" for m in k6_walk_mean)
          + f" of {prog.ops.shape[0]} records [{gpu}]")
    if walk_k != walk_p:
        raise AssertionError("K6's per-warp lists differ from the plain model")
    gcells = 16 ** 3
    k6_bound, k6_by = pf.bound_ms(
        frame_bytes + 4 * (prog.f_len + 9 + gcells),
        pf.march_ops(k6_count, prog) + pf.grid_ops(k6_count, spec), peak)
    print(f"K6 layers at {MAIN_W}x{MAIN_H}: kernel {k6_ms:.3f} ms, plain "
          f"torch frame {k6_plain_ms:.3f} ms while counting; work "
          f"{k6_count['segments']} segments, {int(k6_count['grid_taps'])} "
          f"grid taps ({int(k6_count['grid_outside'])} outside the box, "
          f"{int(k6_count['grid_cheap'])} cheap steps), {k6_count['taps']} "
          f"map taps, leaves by kind "
          f"{ {k: int(v) for k, v in k6_count.items() if isinstance(k, int)} }"
          f"; bound {k6_bound:.4f} ms ({k6_by}) [{gpu}]")
    del sess, scratch

    _stamp(start, "K3 checks")
    # -- K3 against its plain version, on the card (the scattered rays' cases
    # ran in a check worker) ----------------------------------------------
    k3_err = checks["k3"]["k3_err"]
    with torch.no_grad():
        ys, xs = torch.meshgrid(
            torch.arange(MAIN_H, dtype=torch.int32, device=dev),
            torch.arange(MAIN_W, dtype=torch.int32, device=dev), indexing="ij")
        _, pro, prd = camera_rays(xs, ys, 0, 1.0, MAIN_W / MAIN_H,
                                  width=MAIN_W, height=MAIN_H)
        table = program_table(prog, sp, True)
    k3_share, k3_main_err, k3_primary_ms, k3_primary_plain_ms = _k3_check(
        km, f"K3 {MAIN_W}x{MAIN_H} primary rays, baked t_cull normal", prog,
        table, pro, prd, True, True)
    k3_err = max(k3_err, k3_main_err)
    print(f"K3 on the {MAIN_W * MAIN_H} primary rays: kernel "
          f"{k3_primary_ms:.3f} ms, plain {k3_primary_plain_ms:.3f} ms "
          f"(host clock, one call each) [{gpu}]")
    del pro, prd

    _stamp(start, "march probes")
    # -- the march probes (dense, capped, ILP seq and fused) against their
    # plain versions and K3's exact march, on the card, bit for bit ---------
    def ray_diff(pairs):
        """(max |kernel - plain| of the hit t, share of rays not bit-equal)
        over the (kernel, plain) pairs of flat per-ray outputs; a ray is off
        when any of its outputs is (t or idx), and equal t (inf included)
        count 0."""
        err, off = 0.0, None
        for k, p in pairs:
            if k.is_floating_point():
                d = torch.where(k == p, 0.0, (k.double() - p.double()).abs())
                err = max(err, float(d.max()))
            off = (k != p) if off is None else off | (k != p)
        return err, float(off.float().mean())

    def probe_checks(label, sspec, sparams, ro, rd, rejects=False,
                     count_exact=None, count_capped=None):
        """Returns the plain versions' host ms (exact march, capped) and
        each probe's ``ray_diff`` against its plain version."""
        sprog = build_program(sspec, "baked")
        stable = program_table(sprog, sparams, True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pt, pi = pr.march_dense_plain(sprog, stable, ro, rd, count_exact)
        torch.cuda.synchronize()
        exact_ms = (time.perf_counter() - t0) * 1e3
        before = dict(pr.LAUNCHES)
        kt, ki = pr.march_dense(sprog, stable, ro, rd)
        seq = pr.march_ilp(sprog, stable, ro, rd)
        fused = pr.march_ilp(sprog, stable, ro, rd, interleave=True)
        k3t, k3i = km.march_rays(sprog, stable, ro, rd, t_cull=False,
                                 with_normal=False)
        eq = torch.equal
        ok = {"dense": eq(kt, pt) and eq(ki, pi),
              "dense = K3 exact": eq(kt, k3t) and eq(ki, k3i),
              "ilp seq": eq(seq, pt), "ilp fused": eq(fused, pt),
              "ilp = K3 exact": eq(seq, k3t) and eq(fused, k3t)}
        diffs = {"dense_probe": ray_diff([(kt, pt), (ki, pi)]),
                 "ilp_probe": ray_diff([(seq, pt), (fused, pt)])}
        capped_ms = None
        if rejects:
            try:
                pr.capped_program(sspec)
                ok["capped rejects a guard-less cube"] = False
            except ValueError:
                ok["capped rejects a guard-less cube"] = True
        else:
            cprog = pr.capped_program(sspec)
            ctable = program_table(cprog, sparams, True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pc = pr.march_capped_plain(cprog, ctable, ro, rd, count_capped)
            torch.cuda.synchronize()
            capped_ms = (time.perf_counter() - t0) * 1e3
            walk = torch.zeros(2, dtype=torch.int64, device=dev)
            kc = pr.march_capped(cprog, ctable, ro, rd, walk_stats=walk)
            ok["capped"] = eq(kc, pc)
            lengths = pr.capped_list_lengths(cprog, ctable, ro, rd)
            ok["capped lists = model"] = walk.tolist() == [
                int(lengths.sum()), lengths.numel()]
            diffs["analytic_probe"] = ray_diff([(kc, pc)])
        torch.cuda.synchronize()
        launched = {k: pr.LAUNCHES[k] - before[k] for k in before}
        ok["one launch each"] = launched == {
            "march_dense": 1, "march_capped": 0 if rejects else 1,
            "march_ilp_seq": 1, "march_ilp_fused": 1}
        print(f"check probes, {label}: "
              + ", ".join(f"{k} {'yes' if v else 'NO'}" for k, v in ok.items())
              + f"; hits {float((pt <= 100.0).float().mean()):.4f}")
        if not all(ok.values()):
            raise AssertionError(f"probes, {label}: {ok}")
        return exact_ms, capped_ms, diffs

    cro, crd = probe_rays(CHECK_W, CHECK_H, dev)
    for name, (sspec, sparams), rejects in (
            (f"benchmark_scene({N_PRIMS})", bench, False),
            ("csg_demo, subtraction", csg, False),
            ("guard-less cube", cube, True),
            ("sphere_and_plane", sap, False)):
        probe_checks(f"{name} {CHECK_W}x{CHECK_H}", sspec, sparams, cro, crd,
                     rejects)
    # The ILP probe on an odd ray count: the last block's second rays fall
    # past n, and its lanes take part in the lists as not live.
    n_odd = CHECK_W * CHECK_H - 37
    oro, ord_ = (type(v)(*(c[:n_odd].contiguous() for c in v))
                 for v in (cro, crd))
    oprog = build_program(spec, "baked")
    otable = program_table(oprog, sp, False)
    pt = pr.march_ilp_plain(oprog, otable, oro, ord_)
    k3t = km.march_rays(oprog, otable, oro, ord_, t_cull=False,
                        with_normal=False)[0]
    ok = {f"ilp {'fused' if i else 'seq'}": torch.equal(
        pr.march_ilp(oprog, otable, oro, ord_, interleave=i), pt)
        for i in (False, True)}
    ok["plain = K3 exact"] = torch.equal(pt, k3t)
    print(f"check ILP probe on {n_odd} rays (odd), benchmark_scene({N_PRIMS}): "
          + ", ".join(f"{k} {'yes' if v else 'NO'}" for k, v in ok.items())
          + "; mean list " + json.dumps(
              pr.ilp_list_lengths(oprog, otable, oro, ord_)))
    if not all(ok.values()):
        raise AssertionError(f"ILP probe on an odd ray count: {ok}")
    del oro, ord_
    n_main = MAIN_W * MAIN_H
    pro, prd = probe_rays(MAIN_W, MAIN_H, dev)
    exact_count, capped_count = {"segments": n_main}, {"segments": n_main}
    exact_plain_ms, capped_plain_ms, probe_diffs = probe_checks(
        f"benchmark_scene({N_PRIMS}) {MAIN_W}x{MAIN_H}", spec, sp, pro, prd,
        count_exact=exact_count, count_capped=capped_count)
    del pro, prd, cro, crd
    cprog = pr.capped_program(spec)
    ray_bytes = n_main * (24 + 4)
    # dense returns the exact march's (t, idx), so its bound is the exact
    # march's guarded work; evaluating every leaf is the probe's method,
    # printed below as the work it does.
    probe_bounds = {
        "dense_probe": pf.bound_ms(ray_bytes + 4 * n_main + 4 * prog.f_len,
                                   pf.march_ops(exact_count, prog), peak),
        "analytic_probe": pf.bound_ms(
            ray_bytes + 4 * cprog.f_len,
            pf.march_ops(capped_count, cprog)
            + pf.cap_ops(capped_count, cprog),
            peak),
        "ilp_probe": pf.bound_ms(ray_bytes + 4 * prog.f_len,
                                 pf.march_ops(exact_count, prog), peak)}
    dense_done = pf.dense_ops(exact_count, prog)
    print(f"probe work on the {n_main} primary rays: exact march "
          f"{int(exact_count['taps'])} taps (plain {exact_plain_ms:.1f} ms "
          f"while counting), capped {int(capped_count['taps'])} taps (plain "
          f"{capped_plain_ms:.1f} ms); dense evaluates every leaf on every "
          f"tap: {dense_done:.4e} FP32 ops, "
          f"{dense_done / pf.march_ops(exact_count, prog):.2f}x the guarded "
          f"march's; bounds "
          + ", ".join(f"{k} {v[0]:.4f} ms ({v[1]})"
                      for k, v in probe_bounds.items()) + f" [{gpu}]")
    # The probes' main paths: each script's measurement at 1080p, every
    # kernel count set to 0 just before and read just after.
    probe_runs = {}
    for mod, keys in ((dense_probe, ("march_dense",)),
                      (analytic_probe, ("march_capped",)),
                      (ilp_probe, ("march_ilp_seq", "march_ilp_fused"))):
        name = mod.__name__.rsplit(".", 1)[1]
        for counts in (pr.LAUNCHES, km.LAUNCHES, mk.LAUNCHES):
            for k in counts:
                counts[k] = 0
        out = mod.measure()
        torch.cuda.synchronize()
        launches = {k: pr.LAUNCHES[k] for k in keys}
        others = [k for k, v in pr.LAUNCHES.items() if v and k not in keys]
        if not all(launches.values()) or others or any(mk.LAUNCHES.values()):
            raise AssertionError(f"{name} launched {dict(pr.LAUNCHES)}, "
                                 f"{dict(mk.LAUNCHES)}")
        probe_runs[name] = (launches, out)
        print(f"main path {name}, {MAIN_W}x{MAIN_H} primary rays, "
              f"{N_PRIMS} prims, CUDA events: "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in out["rows"].items())
              + f"; {out['summary']}; launches {launches}, K3 "
              f"{km.LAUNCHES['march_rays']} [{gpu}]")

    _stamp(start, "hardware probes")
    # -- the hardware-primitive probes (vpu_peak, gather, bf16, mxu) against
    # their plain versions, and their measurement scripts as main paths -----
    hw_mods = {"vpu_peak": vpu_peak, "gather_probe": gather_probe,
               "bf16_probe": bf16_probe,
               "mxu_transform_probe": mxu_transform_probe}
    hw_checks = _hw_probe_checks(hp, hw_mods)
    hw_runs = _hw_probe_main(hp, hw_mods, (pr.LAUNCHES, km.LAUNCHES,
                                           mk.LAUNCHES, tm.LAUNCHES), gpu)
    hw_rows = _hw_probe_rows(
        hp, pf, hw_mods, hw_checks, hw_runs, peak,
        {"sass": gather_sass},
        {"sass": bf16_sass,
         "ptxas": {k: v for k, v in probe_ptxas.items()
                   if k.startswith("bf16_march")}},
        {"state": "redesigned, PR 17 (tensor: wgmma m64n48k8 3xTF32, the "
                  "rays' fragments in registers, the fold from the "
                  "accumulators; scalar: two rays a thread, 12-float "
                  "records by 16-byte loads; both: the branch-free "
                  "reciprocal)",
         "rcp_mismatches": hw_checks["mxu_transform_probe"]["rcp_mismatches"],
         "ptxas": {k: probe_ptxas[k] for k in ("mxu_scalar", "mxu_tensor")},
         "sass": mxu_sass})
    # The dense probe's own work, every leaf on every tap, at the FP32 rate
    # vpu_peak attained in this run: the probe cannot come near its bound
    # (the exact march's guarded work) by design.
    attained = hw_runs["vpu_peak"][1]["summary"]["attainable_tflops"] * 1e12
    dense_extra = {"state": "redesigned: the program staged in shared "
                            "memory, walked densely",
                   "dense_ops": dense_done,
                   "dense_work_ms": dense_done / attained * 1e3,
                   "dense_work_tflops": attained / 1e12,
                   "ratio_dense_over_cull": probe_runs["dense_probe"][1][
                       "summary"]["ratio_dense_over_cull"],
                   "k3_rows_ms": {k: v for k, v in probe_runs["dense_probe"][
                       1]["rows"].items() if k != "dense plain-map"},
                   "ptxas": probe_ptxas["march_dense"]}
    print(f"dense probe: its own work {dense_done:.4e} FP32 ops takes "
          f"{dense_extra['dense_work_ms']:.4f} ms at the {attained / 1e12:.2f} "
          f"TFLOP/s vpu_peak attained [{gpu}]")
    print("hardware probe rows: " + json.dumps(hw_rows))

    _stamp(start, "wavefront and gradient probes")
    # -- the wavefront bounce, fused_bwd and segsum against their plain
    # versions, and their measurement scripts as main paths ----------------
    all_counts = (pr.LAUNCHES, km.LAUNCHES, mk.LAUNCHES, tm.LAUNCHES,
                  hp.LAUNCHES, wf.LAUNCHES, gp.LAUNCHES)
    wave_row = _wavefront_phase(frozen_wavefront, wf, pf, spec, sp,
                                checks["wavefront"], all_counts, peak, gpu,
                                probe_ptxas)
    grad_rows = _grad_probe_phase(gp, pf, probe_fused_bwd,
                                  probe_inkernel_segsum, spec, sp, all_counts,
                                  peak, gpu, probe_ptxas, seg_sass)
    print("wavefront and gradient probe rows: "
          + json.dumps([wave_row] + grad_rows))

    _stamp(start, "gradients through K3")
    # -- gradients through K3 (the CHECK_W x CHECK_H checks ran in a check
    # worker): the implicit backward timed at 1080p ----------------------
    with torch.no_grad():
        ys, xs = torch.meshgrid(
            torch.arange(MAIN_H, dtype=torch.int32, device=dev),
            torch.arange(MAIN_W, dtype=torch.int32, device=dev), indexing="ij")
        _, pro, prd = camera_rays(xs, ys, 0, 1.0, MAIN_W / MAIN_H,
                                  width=MAIN_W, height=MAIN_H)
    torch.cuda.reset_peak_memory_stats()
    _hit_t_grad(km, spec, sp, pro, prd)
    (_, g), bwd_ms = _hit_t_grad(km, spec, sp, pro, prd)
    if not bool(torch.isfinite(g).all()):
        raise AssertionError("the implicit gradient at 1080p is not finite")
    print(f"implicit backward (one map vjp) on the {MAIN_W * MAIN_H} primary "
          f"rays: {bwd_ms:.3f} ms, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB [{gpu}]")
    del pro, prd, g

    _stamp(start, "K3 main path")
    # -- K3 main path: three training steps at 1080p ------------------------
    k3_launches, k3_ms, kept = _drive_training(km, mk, spec, sp, gpu)
    k3_plain_ms, k3_ops, k3_bytes = 0.0, 0.0, 0
    for kprog, ktable, kro, krd, kw in kept:
        count = {"segments": kro.x.shape[0]}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        km.march_rays_plain(kprog, ktable, kro, krd, count=count, **kw)
        torch.cuda.synchronize()
        k3_plain_ms += (time.perf_counter() - t0) * 1e3
        k3_ops += pf.march_ops(count, kprog)
        k3_bytes += kro.x.shape[0] * (24 + 8 + (12 if kw["with_normal"] else 0))
    k3_bound, k3_by = pf.bound_ms(k3_bytes, k3_ops, peak)
    print(f"K3 per training step: kernel {k3_ms:.3f} ms, plain {k3_plain_ms:.3f} "
          f"ms over the same {len(kept)} launches' rays while counting, bound {k3_bound:.4f} "
          f"ms ({k3_by}: {k3_ops:.4e} FP32 ops, {k3_bytes} bytes) [{gpu}]")
    del kept

    _stamp(start, "edge step")
    # -- the autograd path's edge estimators: one timed 1080p step ---------
    edge_step = _drive_edge_step(km, mk, spec, sp, gpu)

    _stamp(start, "K4 checks")
    # -- K4 against its plain version, on the card (the CHECK_W x CHECK_H
    # cases ran in check workers) -----------------------------------------
    k4_err, k4b_err = checks["k4"]["k4_err"], checks["k4b"]["k4b_err"]

    n, nd, nid, nnear, ndnear = _edge_cull_count(spec, sp, dev)
    print(f"K4 edge term, {CHECK_W}x{CHECK_H} primary rays: {nd} of {n} would "
          f"track another (d_min, t_min, i_min) under K2's per-thread t-cull "
          f"({nid} another shape; {ndnear} of the {nnear} near misses within "
          f"0.2), so its marches do not cull")

    # K4's image is K1's frame (analytic_all) and K2's baked t-culled frame.
    zero_t = torch.zeros((CHECK_H, CHECK_W, 3), device=dev)
    for name, fkw, rmode in (("K1 analytic_all", FUSED_MAIN, ANALYTIC),
                             ("K2 baked t_cull", {}, MARCH),
                             ("K2b analytic_unboxed", FUSED_UNBOXED, UNBOXED)):
        _, _, img = _fused_step(tm, spec, sp, zero_t, CHECK_W, CHECK_H,
                                BOUNCES, **fkw)
        frame = mk.render_frame_megakernel(spec, sp, None, 0, 0,
                                           width=CHECK_W, height=CHECK_H,
                                           bounces=BOUNCES, **rmode)
        torch.cuda.synchronize()
        equal = bool(torch.equal(img, frame))
        print(f"check K4 image against the {name} frame, {CHECK_W}x{CHECK_H}: "
              f"{'bit-equal' if equal else 'DIFFERENT'}")
        if not equal:
            raise AssertionError(f"K4's image is not the {name} frame")

    # The main configuration at 1080p against its plain version (one step
    # each), and the plain version's count of the work for the bound.
    target0 = torch.zeros((MAIN_H, MAIN_W, 3), device=dev)
    k4_share, main_err, k4_plain_ms, k4_count = _k4_main_check(
        tm, spec, sp, target0, "main configuration", FUSED_MAIN)
    k4_err = max(k4_err, main_err)

    # Do K4's in-kernel sums repeat bit for bit?  And the whole gradient?
    mode = tm.FusedMode(BOUNCES, True, edge_grad=True, analytic_all=True)
    tables = tm.fused_tables(spec, sp, True)
    tplanes = target0.permute(2, 0, 1).contiguous()
    runs = [tm.launch_train_fused(tables, tplanes, 0, 1.0, MAIN_W / MAIN_H, 0,
                                  width=MAIN_W, height=MAIN_H, mode=mode)
            for _ in range(2)]
    grads = [_fused_step(tm, spec, sp, target0, MAIN_W, MAIN_H, BOUNCES,
                         **FUSED_MAIN)[1] for _ in range(2)]
    torch.cuda.synchronize()
    sums_equal = all(torch.equal(getattr(runs[0], f), getattr(runs[1], f))
                     for f in ("col", "mat_acc", "geom_acc"))
    grad_equal = bool(torch.equal(grads[0], grads[1]))
    print(f"K4 repeatability at {MAIN_W}x{MAIN_H}: image and (shape, channel) "
          f"sums {'bit-equal' if sums_equal else 'DIFFERENT'} over two "
          f"launches; the step's gradient "
          f"{'bit-equal' if grad_equal else 'different'} over two steps")
    if not sums_equal:
        raise AssertionError("K4's sums do not repeat")
    del runs, grads, tables

    _stamp(start, "K4 main paths")
    # -- K4 main path: three timed 1080p steps per configuration ------------
    fused = {}
    for label, fkw in FUSED_CONFIGS:
        fused[label] = _drive_fused(tm, (mk.LAUNCHES, km.LAUNCHES), spec, sp,
                                    gpu, label, fkw)
    k4_launches, k4_ms = fused[FUSED_CONFIGS[0][0]][:2]
    layout = build_soa_smem_layout(spec)
    k4_bytes = MAIN_W * MAIN_H * 3 * 4 * 2 + 4 * (prog.f_len + layout.f_len)
    k4_ops = pf.fused_ops(k4_count, prog, True)
    k4_bound, k4_by = pf.bound_ms(k4_bytes, k4_ops, peak)
    print(f"K4 per main-configuration step: kernel {k4_ms:.3f} ms, plain "
          f"{k4_plain_ms:.1f} ms, bound {k4_bound:.4f} ms ({k4_by}: "
          f"{k4_ops:.4e} FP32 ops, {k4_bytes} bytes; work "
          f"{ {str(k): int(v) for k, v in k4_count.items()} }) [{gpu}]")

    # K4's analytic_unboxed mode (bench.py:442), beside the same march
    # without it, and its plain step at 1080p for the work count.
    fused["march"] = _drive_fused(tm, (mk.LAUNCHES, km.LAUNCHES), spec, sp,
                                  gpu, "march, no edge", {})
    fused["analytic_unboxed"] = _drive_fused(
        tm, (mk.LAUNCHES, km.LAUNCHES), spec, sp, gpu, "analytic_unboxed",
        FUSED_UNBOXED)
    k4b_launches, k4b_ms = fused["analytic_unboxed"][:2]
    # K4's per-warp lists at 1080p, frame 0, per configuration and bounce:
    # phase 1's march, the edge term (bounce 0) and the secondary rows'
    # slope taps (bounces 1+), the exclusion march (bounces 1+).
    k4_walk = {}
    for label, fkw in FUSED_CONFIGS + (("march", {}),
                                        ("analytic_unboxed", FUSED_UNBOXED)):
        mode = tm.FusedMode(
            BOUNCES, True, fkw.get("edge_grad", False),
            fkw.get("edge_secondary", False), fkw.get("analytic_all", False),
            analytic_unboxed=fkw.get("analytic_unboxed", False))
        tables = tm.fused_tables(spec, sp, mode.analytic_all,
                                 mode.analytic_unboxed)
        ws = torch.zeros(6 * (BOUNCES + 1), dtype=torch.int64, device=dev)
        tm.launch_train_fused(tables, tplanes, 0, DEFAULT_FOV, MAIN_W / MAIN_H,
                              0, width=MAIN_W, height=MAIN_H, mode=mode,
                              walk_stats=ws)
        groups = ws.view(3, BOUNCES + 1, 2).tolist()
        k4_walk[label] = {g: _walk_means(rows) for g, rows in
                          zip(("march", "edge_slope", "exclusion"), groups)}
        print(f"K4 per-warp lists at {MAIN_W}x{MAIN_H}, {label}, mean length "
              f"per bounce: "
              + "; ".join(f"{g} " + ", ".join(f"{m:.2f}" for m in v)
                          for g, v in k4_walk[label].items())
              + f" (of {tables.prog.ops.shape[0]} records, exclusion of "
              f"{spec.n_shapes} shapes) [{gpu}]")
    del tables
    # Its 1080p plain step, held to K4's, counts the work (a check
    # worker's job).
    k4bm = checks["k4b 1080p"]
    k4b_share, k4b_plain_ms, k4b_count = (k4bm["share"], k4bm["plain_ms"],
                                          k4bm["count"])
    k4b_err = max(k4b_err, k4bm["err"])
    k4b_ops = (pf.fused_ops(k4b_count, uprog, False)
               + pf.cap_ops(k4b_count, uprog))
    k4b_bound, k4b_by = pf.bound_ms(
        MAIN_W * MAIN_H * 3 * 4 * 2 + 4 * uprog.f_len, k4b_ops, peak)
    print(f"K4 per analytic_unboxed step: kernel {k4b_ms:.3f} ms, plain "
          f"{k4b_plain_ms:.1f} ms, bound {k4b_bound:.4f} ms ({k4b_by}: "
          f"{k4b_ops:.4e} FP32 ops; work "
          f"{ {str(k): int(v) for k, v in k4b_count.items()} }) [{gpu}]")

    _stamp(start, "entry points")
    # -- the entry points: optimize_to_target and the CLI ------------------
    sp_scene = compile_scene(_sphere_and_plane())
    p_true = params_from_numpy(sp_scene.params, sp_scene.spec, dev)
    with torch.no_grad():
        target = render_image_diff(sp_scene.spec, p_true, width=24, height=24,
                                   bounces=0)
    slot = sp_scene.spec.roots[0].children_shapes[0].material[3]
    init = p_true.clone()
    init[slot] += float(np.random.default_rng(0).uniform(0.15, 0.3))
    mask = torch.zeros_like(init)
    mask[slot] = 1.0
    before = km.LAUNCHES["march_rays"]
    result = optimize_to_target(sp_scene.spec, init, target, width=24,
                                height=24, bounces=0, steps=40,
                                learning_rate=5e-2, param_mask=mask,
                                geometry="baked", march="kernel")
    losses = result.losses.tolist()
    print(f"optimize_to_target (24x24, 40 steps, march=kernel): loss "
          f"{losses[0]:.6e} -> {losses[-1]:.6e}, brightness "
          f"{float(result.params[slot]):.4f} (true "
          f"{float(p_true[slot]):.4f}), K3 launches "
          f"{km.LAUNCHES['march_rays'] - before}")
    if not losses[-1] < 0.2 * losses[0] or km.LAUNCHES["march_rays"] == before:
        raise AssertionError("optimize_to_target did not converge through K3")

    # The fused step's entry points: the flat ball's position back through
    # K4's edge term, and the CLI's optimize --fused --edge-grad.
    fb = compile_scene(_flat_ball())
    p_true = params_from_numpy(fb.params, fb.spec, dev)
    with torch.no_grad():
        target = render_image_diff(fb.spec, p_true, width=48, height=48,
                                   bounces=0)
    sx = fb.spec.roots[0].children_shapes[0].transform.pos[0]
    init = p_true.clone()
    init[sx] += 0.3
    mask = torch.zeros_like(init)
    mask[sx] = 1.0
    before = tm.LAUNCHES["train_fused"]
    result = optimize_to_target(fb.spec, init, target, width=48, height=48,
                                bounces=0, steps=60, learning_rate=2e-2,
                                param_mask=mask, fused=True, edge_grad=True)
    err0, err1 = 0.3, abs(float(result.params[sx]) - float(p_true[sx]))
    launched = tm.LAUNCHES["train_fused"] - before
    print(f"optimize_to_target(fused=True, edge_grad=True), flat ball 48x48, "
          f"60 steps: position error {err0:.4f} -> {err1:.4f}, K4 launches "
          f"{launched}")
    if not err1 < 0.25 * err0 or launched != 60:
        raise AssertionError("the fused edge term did not recover the position")
    # The CLI's optimize (plain, fused, and with the autograd path's edge
    # terms), render --checkpoint / --resume, demo and the TUI ran in a
    # check worker.
    for label, rc, out, err, expect in checks["cli"]["runs"]:
        print(f"{label}: " + " | ".join(out.strip().splitlines()[-4:]))
        if rc != 0 or expect not in out:
            raise AssertionError(f"{label} failed ({rc}): {err[-2000:]}")

    csrc = "compute_path_tracer_tpu_torch/kernels/csrc/"
    replaces = "compute_path_tracer_tpu/kernels/megakernel.py:1546"
    report = {"kernels": [
        {"name": "megakernel_analytic", "route": "cuda",
         "source": csrc + "megakernel_analytic.cu", "replaces": replaces,
         "launches": k1_launches, "max_abs_err": k1_err,
         "main_shape_share_off": k1_share, "ms": k1_ms,
         "plain_ms": k1_plain_ms, "bound_ms": k1_bound, "bound_by": k1_by,
         "library_ms": None,
         "state": "redesigned: staged records, refill, hoisted reciprocal",
         "lanes": k1_lanes, "quotient_triples": quotient,
         "band_split_ms": band_split["K1"], "ptxas": k1_ptxas},
        {"name": "megakernel_march", "route": "cuda",
         "source": csrc + "megakernel_march.cu", "replaces": replaces,
         "launches": k2_launches, "max_abs_err": k2_err,
         "main_shape_share_off": k2_share, "ms": k2_ms,
         "plain_ms": k2_plain_ms, "bound_ms": k2_bound, "bound_by": k2_by,
         "library_ms": None, "state": "redesigned, PR 11",
         "mean_list_per_bounce": walk_mean,
         "band_split_ms": band_split["K2"],
         "ptxas": {k: v for k, v in walk_ptxas.items()
                   if k.startswith("megakernel_walk") and k.endswith(",0,0>")}},
        {**xr_rows["exact"], "route": "cuda",
         "source": csrc + "megakernel_march.cu", "replaces": replaces,
         "state": "ported (the EXACT instantiations: "
                  "csg_program.cuh:grad_exact_walk)",
         "ptxas": {k: v for k, v in walk_ptxas.items()
                   if k.startswith("megakernel_") and k.endswith(",1>")}},
        {**xr_rows["refresh"], "route": "cuda",
         "source": csrc + "megakernel_march.cu", "replaces": replaces,
         "state": "ported (megakernel_walk's kMarchRefresh: "
                  "csg_program.cuh:march_refresh_walk)",
         "ptxas": {k: v for k, v in walk_ptxas.items()
                   if k.startswith("megakernel_walk") and ",2," in k}},
        {"name": "march_rays", "route": "cuda",
         "source": csrc + "march_rays.cu",
         "replaces": "compute_path_tracer_tpu/kernels/march.py:123",
         "launches": k3_launches, "max_abs_err": k3_err,
         "main_shape_share_off": k3_share, "ms": k3_ms,
         "plain_ms": k3_plain_ms, "bound_ms": k3_bound, "bound_by": k3_by,
         "library_ms": None, "state": "redesigned, PR 11",
         "edge_step": edge_step,
         "ptxas": {k: v for k, v in walk_ptxas.items()
                   if k.startswith("march")}},
        {"name": "train_fused", "route": "cuda",
         "source": csrc + "train_fused.cu",
         "replaces": "compute_path_tracer_tpu/kernels/train.py:1018",
         "launches": k4_launches, "max_abs_err": k4_err,
         "main_shape_share_off": k4_share, "ms": k4_ms,
         "plain_ms": k4_plain_ms, "bound_ms": k4_bound, "bound_by": k4_by,
         "library_ms": None, "state": "redesigned: per-warp walk",
         "ms_by_config": {k: v[1] for k, v in fused.items()},
         "mean_list_per_bounce": k4_walk,
         "ptxas": {k: v for k, v in walk_ptxas.items()
                   if k.startswith("train_fused")}},
        {"name": "megakernel_march (K2b: analytic_unboxed, omega)",
         "route": "cuda", "source": csrc + "megakernel_march.cu",
         "replaces": replaces, "launches": k2b_launches,
         "max_abs_err": k2b_err, "main_shape_share_off": k2b_share,
         "ms": k2b_ms, "plain_ms": k2b_plain_ms,
         "bound_ms": k2b_bound, "bound_by": k2b_by, "library_ms": None,
         "state": "redesigned, PR 14 (omega: RELAX on the per-warp walk; "
                  "analytic_unboxed in PR 11)",
         "omega_ms": k2_omega_ms,
         "ptxas": {k: v for k, v in walk_ptxas.items()
                   if k.startswith("megakernel_walk") and k.endswith(",1,0>")}},
        {"name": "train_fused (K2b: analytic_unboxed)", "route": "cuda",
         "source": csrc + "train_fused.cu",
         "replaces": "compute_path_tracer_tpu/kernels/train.py:1018",
         "launches": k4b_launches, "max_abs_err": k4b_err,
         "main_shape_share_off": k4b_share, "ms": k4b_ms,
         "plain_ms": k4b_plain_ms, "bound_ms": k4b_bound, "bound_by": k4b_by,
         "library_ms": None, "state": "redesigned: per-warp walk",
         "mean_list_per_bounce": k4_walk["analytic_unboxed"]},
    ] + [
        {"name": f"megakernel_analytic (K5: analytic_soa, {n} prims)",
         "route": "cuda", "source": csrc + "megakernel_analytic.cu",
         "replaces": replaces, "launches": k5[n][0], "max_abs_err": k5_err[n],
         "main_shape_share_off": k5[n][5], "ms": k5[n][1], "plain_ms": k5[n][2], "bound_ms": k5[n][3],
         "bound_by": k5[n][4], "library_ms": None,
         "state": "redesigned: staged records, refill, hoisted reciprocal",
         "lanes": k5[n][6]} for n in SOA_PRIMS] + [
        {"name": "megakernel_march (K6: dist_grid)", "route": "cuda",
         "source": csrc + "megakernel_march.cu", "replaces": replaces,
         "launches": k6_launches, "max_abs_err": k6_err,
         "main_shape_share_off": k6_share, "ms": k6_ms,
         "plain_ms": k6_plain_ms, "bound_ms": k6_bound, "bound_by": k6_by,
         "library_ms": None, "state": "redesigned: per-warp walk",
         "mean_list_per_bounce": k6_walk_mean,
         "ptxas": {k: v for k, v in walk_ptxas.items()
                   if k.startswith("megakernel_grid") and k.endswith(",0>")}},
        {"name": "debug4", "route": "cuda",
         "source": csrc + "megakernel_march.cu", "replaces": replaces,
         "launches": d4_launches, "max_abs_err": d4_err,
         "main_shape_share_off": d4_share, "ms": d4_ms,
         "plain_ms": k2_plain_ms, "bound_ms": d4_bound, "bound_by": d4_by,
         "library_ms": None, "state": "redesigned, PR 14 (per-warp walk)",
         "ptxas": {k: v for k, v in walk_ptxas.items()
                   if k.startswith("megakernel_stats") and k.endswith(",0>")}}] + [
        {"name": name, "route": "cuda", "source": csrc + "march_probes.cu",
         "replaces": f"benchmarks/{name}.py:{line}",
         "launches": sum(probe_runs[name][0].values()),
         "launches_by_kernel": probe_runs[name][0],
         "max_abs_err": probe_diffs[name][0],
         "main_shape_share_off": probe_diffs[name][1],
         "ms": probe_runs[name][1]["rows"][row],
         "plain_ms": plain, "bound_ms": probe_bounds[name][0],
         "bound_by": probe_bounds[name][1], "library_ms": None, **extra}
        for name, line, row, plain, extra in (
            ("dense_probe", 119, "dense plain-map", exact_plain_ms,
             dense_extra),
            ("analytic_probe", 194, "analytic-capped march", capped_plain_ms,
             {"state": "redesigned, PR 18 (K3's t-culled kernel: its per-warp "
                       "walk of the staged capped program, march_walk with "
                       "the cap)",
              "k3_tcull_ms": probe_runs["analytic_probe"][1]["rows"][
                  "t_cull march (baseline)"],
              "mean_list": probe_runs["analytic_probe"][1]["summary"][
                  "mean_list"],
              "ptxas": probe_ptxas["march_capped"]}),
            ("ilp_probe", 184, "fused interleaved rays", exact_plain_ms,
             {"state": "redesigned, PR 16 (K3's per-warp walk of the staged "
                       "program; fused: one list over both rays' guards)",
              "seq_ms": probe_runs["ilp_probe"][1]["rows"][
                  "sequential rays (dep-chain baseline)"],
              "mean_list": probe_runs["ilp_probe"][1]["summary"]["mean_list"],
              "ptxas": {k: v for k, v in probe_ptxas.items()
                        if k.startswith("march_ilp")}}))] + hw_rows
        + [wave_row] + grad_rows}
    _stamp(start, "report")
    print(f"chip_smoke: {time.perf_counter() - start:.1f} s in all")
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
