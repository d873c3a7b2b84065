"""The gradient probes of the JAX package's ``benchmarks/`` on the card
(``csrc/grad_probes.cu``), and their plain torch versions.

* ``fused_bwd(spec, params, bv, rect)`` (``benchmarks/probe_fused_bwd.py:
  run``): one bounce of the probe's camera (1920x1080, frame 1, fov 1) over
  the pixels ``rect = (x0, y0, width, height)``, the probe's (64, 128) tile
  by default: the baked guards, the exact march, the 6-tap normal, the
  material from ``params`` and ``shade_bounce``.  Returns ``(loss, grad)``:
  the (1,) float32 sum over the hits of emit + thr_factor / ray_prob, and
  its gradient in the baked vector ``bv``, which is identically zero (the
  loss reads the hit mask and the materials only; see the note in
  ``csrc/grad_probes.cu``).  The kernel writes that zero; the plain version
  computes it with autograd, through ``diff/vjp.py:make_implicit_cast``.
  The kernel takes K3's per-warp walk of the program staged in shared
  memory (``walk_smem_bytes``, which raises for a program too large for a
  block); a warp is 32 consecutive pixels of a rectangle row, and
  ``walk_stats`` takes the summed length of the warps' lists and their
  number (on the CPU, the plain model: ``warp_records`` over the same
  warps).
* ``segsum(idx, cot, n_seg)`` (``benchmarks/probe_inkernel_segsum.py:
  main``): ``out[s, c]`` = the sum of ``cot[b, c, i]`` over the ``(b, i)``
  with ``idx[b, i] == s``, ``idx == -1`` dropping out; idx (B, n) int32,
  cot (B, C, n) float32, out (n_seg, C) float32.  Its plain version is the
  fused step's ``index_add_`` per bounce (kernels/train.py).  The kernel
  takes the sum as a one-hot TF32 product on the tensor cores, each
  cotangent split into two TF32 terms, and reduces in a fixed order, so it
  repeats bit for bit and agrees with the plain version to rounding (see
  the note in ``csrc/grad_probes.cu``).  ``segsum_plan`` is the grid it
  launches, ``segsum_tiles`` and ``segsum_lane_slots`` its partition of the
  elements, ``tf32_split`` its split and ``segsum_model`` a plain model of
  the whole sum in its order.

On CUDA tensors each launches its kernel on the current stream without
synchronising and counts the launch in ``LAUNCHES``; on CPU tensors it runs
its plain version; on any other device it raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..constants import FP
from ..diff.vjp import make_implicit_cast
from ..render.baked import baked_layout, make_bounds_baked, make_map_baked
from ..render.program import (
    build_program,
    program_bounds,
    program_code_on,
    program_table,
    walk_smem_bytes,
    warp_records,
)
from ..render.reference import (
    calc_normal,
    camera_rays,
    gather_material,
    shade_bounce,
)
from ..render.scenegen import material_slot_matrix
from ..scene.compile import SceneSpec
from ..vecmath import Vec3, vwhere
from .build import load_library
from .train import _segment_matmul

# Launches per kernel since import (or since a caller reset them).
LAUNCHES = {"fused_bwd": 0, "segsum": 0}

# The probe's camera: frame 1 of the 1920x1080 view, fov 1.
CAMERA_W, CAMERA_H, CAMERA_FRAME, CAMERA_FOV = 1920, 1080, 1, 1.0
CAMERA_ASPECT = float(np.float32(CAMERA_W / CAMERA_H))
TILE_RECT = (0, 0, 128, 64)                  # the probe's (64, 128) tile
FRAME_RECT = (0, 0, CAMERA_W, CAMERA_H)
# The kernel's block: 256 threads, 8 warps of 32 consecutive pixels.
FB_WARPS = 8
# segsum's kernel (csrc/grad_probes.cu): tiles of 256 or 512 lanes of a
# plane, an eighth a warp of 8, one pass per 64 segments and 16 (C <= 16) or
# 32 channels, a ring of 3 staged tiles, at most 2 blocks an SM (1 at C >
# 16) a pass.
SEG_TILES, SEG_WARPS, SEG_GROUP, SEG_STAGES = (256, 512), 8, 64, 3
# The smallest |x| whose rounding to TF32 overflows: (2 - 2^-11) 2^127.
TF32_OVER = float(np.array(0x7F7FF000, np.uint32).view(np.float32))
_SM_COUNT = {}


def _check_rect(rect):
    x0, y0, w, h = (int(v) for v in rect)
    if w < 1 or h < 1 or x0 < 0 or y0 < 0 or x0 + w > CAMERA_W \
            or y0 + h > CAMERA_H:
        raise ValueError(f"rect {rect} is not inside the {CAMERA_W}x"
                         f"{CAMERA_H} camera")
    return x0, y0, w, h


def fused_bwd_rays(rect, device):
    """The probe camera's ``(rng, ro, rd)`` over ``rect``, flat in
    row-major order."""
    x0, y0, w, h = _check_rect(rect)
    ys, xs = torch.meshgrid(
        torch.arange(y0, y0 + h, dtype=torch.int32, device=device),
        torch.arange(x0, x0 + w, dtype=torch.int32, device=device),
        indexing="ij")
    return camera_rays(xs, ys, CAMERA_FRAME, CAMERA_FOV, CAMERA_ASPECT,
                       width=CAMERA_W, height=CAMERA_H)


def fused_bwd_plain(spec: SceneSpec, params, bv, rect=TILE_RECT,
                    walk_stats=None):
    """The probe's bounce loss over ``rect`` and its autograd gradient in
    ``bv``: the march is ``make_implicit_cast`` over the baked map (its
    backward the implicit gradient), the normal the 6-tap ``calc_normal``
    (checkpointed: its tape would hold the map six times over, and no
    cotangent reaches it), the guards boolean, so taken without a tape.
    ``walk_stats``, a (2,) int64 tensor, takes :func:`fused_bwd_walk_stats`
    of the rectangle."""
    map_fn, bounds = make_map_baked(spec), make_bounds_baked(spec)
    slots = torch.as_tensor(material_slot_matrix(spec), dtype=torch.int64,
                            device=params.device)
    mats = params.detach()[slots]
    gv = bv.detach().requires_grad_()
    rng, ro, rd = fused_bwd_rays(rect, params.device)
    if walk_stats is not None:
        walk_stats += fused_bwd_walk_stats(*fused_bwd_tables(spec, params, bv),
                                           ro, rd)
    with torch.no_grad():
        checks, _ = bounds(ro, rd, gv)
    with torch.enable_grad():
        t, idx = make_implicit_cast(map_fn, gv)(ro, rd, checks)
        hit = ro + rd * t

        def normal(x, y, z, g):
            return tuple(calc_normal(lambda p, c: map_fn(p, g, c),
                                     Vec3(x, y, z), checks))

        n = Vec3(*checkpoint(normal, *hit, gv, use_reentrant=False))
        _, _, _, emit, thr_f, ray_p = shade_bounce(
            rng, rd, hit, n, gather_material(mats, idx))
        col = vwhere(t <= FP, emit + thr_f / ray_p, Vec3.splat(t * 0.0))
        loss = torch.sum(col.x + col.y + col.z)
        (grad,) = torch.autograd.grad(loss, gv)
    return loss.detach().reshape(1), grad


def fused_bwd_tables(spec: SceneSpec, params, bv):
    """The kernel's program (baked) and its table over ``bv``."""
    prog = build_program(spec, "baked")
    with torch.no_grad():
        return prog, program_table(prog, params, False, bv)


def fused_bwd_warps(n: int, device=None):
    """The kernel's warp of each of ``n`` pixels of a rectangle, in its
    row-major order: 32 consecutive pixels a warp (a rectangle row of the
    probe's tile or frame holds whole warps)."""
    return torch.arange(n, device=device) // 32


def fused_bwd_walk_stats(prog, table, ro, rd):
    """The kernel's per-warp list figures over the flat rays ``(ro, rd)`` of
    a rectangle: (the summed length of the warps' lists, their number),
    ``warp_records`` over the baked guards; an int64 (2,) tensor."""
    n = ro.x.shape[0]
    with torch.no_grad():
        checks, _ = program_bounds(prog, table, ro, rd, False)
        lists = warp_records(prog, checks[0], fused_bwd_warps(n, ro.x.device))
    return torch.tensor([int(lists.sum()), lists.shape[0]], dtype=torch.int64,
                        device=ro.x.device)


def launch_fused_bwd(prog, table, rect, n_grad: int, walk_stats=None):
    """One launch of the fused_bwd kernel on a program and its table
    (``fused_bwd_tables``); returns ``(loss, grad)`` as :func:`fused_bwd`.
    ``walk_stats``, a zeroed (2,) int64 tensor on the table's device, takes
    the summed length of the warps' lists and their number."""
    x0, y0, w, h = _check_rect(rect)
    smem = walk_smem_bytes(prog, FB_WARPS)
    device = table.device
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    if table.dtype != torch.float32 or table.shape != (prog.f_len,) \
            or not table.is_contiguous():
        raise ValueError(f"table must be contiguous float32 ({prog.f_len},)")
    if walk_stats is not None and (
            walk_stats.device != device or walk_stats.dtype != torch.int64
            or tuple(walk_stats.shape) != (2,)):
        raise ValueError(f"walk_stats must be int64 (2,) on {device}")
    acc = torch.zeros(1, dtype=torch.float64, device=device)
    grad = torch.empty(n_grad, dtype=torch.float32, device=device)
    code = program_code_on(prog, device)
    with torch.cuda.device(device):
        err = load_library().cpt_fused_bwd(
            code.data_ptr(), prog.ops.shape[0], table.data_ptr(),
            prog.n_boxed, prog.f_box, prog.f_mat, x0, y0, w, h, CAMERA_W,
            CAMERA_H, CAMERA_FRAME, CAMERA_FOV, CAMERA_ASPECT,
            acc.data_ptr(), grad.data_ptr(), n_grad,
            None if walk_stats is None else walk_stats.data_ptr(), smem,
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_bwd launch failed: CUDA error {err}")
    LAUNCHES["fused_bwd"] += 1
    return acc.to(torch.float32), grad


def fused_bwd(spec: SceneSpec, params, bv, rect=TILE_RECT, walk_stats=None):
    """The probe's ``(loss, grad)`` over ``rect`` (see the module note);
    ``walk_stats``, a zeroed (2,) int64 tensor on ``params``' device, takes
    the kernel's list figures (its plain model on the CPU)."""
    if params.device.type == "cpu":
        return fused_bwd_plain(spec, params, bv, rect, walk_stats)
    if params.device.type != "cuda":
        raise ValueError(f"no kernel for device {params.device}")
    if bv.shape != (baked_layout(spec).n_slots,):
        raise ValueError(f"bv must be the baked vector of "
                         f"{baked_layout(spec).n_slots} slots")
    prog, table = fused_bwd_tables(spec, params, bv)
    return launch_fused_bwd(prog, table, rect, bv.shape[0], walk_stats)


def segsum_plain(idx, cot, n_seg: int):
    """The segment sum in torch, in ``cot``'s dtype: one ``index_add_`` of
    the kept lanes per b (kernels/train.py:_segment_matmul)."""
    return _segment_matmul(idx, cot, n_seg)


class SegsumPlan(NamedTuple):
    """The segsum kernel's launch for (B, n) ids and C channels."""

    m_tiles: int         # 16-channel tiles a warp holds: 1 (C <= 16) or 2
    seg_groups: int      # passes along the segments, 64 each
    ch_groups: int       # passes along the channels, 16 m_tiles each
    tile: int            # lanes of a tile
    tiles_per_plane: int
    tiles: int
    blocks: int          # a pass's blocks

    @property
    def cp(self) -> int:
        return 16 * self.m_tiles

    @property
    def passes(self) -> int:
        return self.seg_groups * self.ch_groups


def segsum_plan(n_b: int, n: int, n_seg: int, n_ch: int,
                n_sm: int = 132) -> SegsumPlan:
    """The grid of the segsum kernel on a card of ``n_sm`` SMs: its passes;
    the tiles of each plane, 512 lanes where that leaves a tile for every
    block that fits, else 256 (a tile's fixed cost, its barrier and the
    flush of its products, then weighs half as much); and the blocks of a
    pass, as many as fit the SMs over the passes (2 an SM at C <= 16, else
    1) but no more than the tiles."""
    mt = 1 if n_ch <= 16 else 2
    cp = 16 * mt
    seg_groups, ch_groups = -(-n_seg // SEG_GROUP), -(-n_ch // cp)
    fit = -(-(3 - mt) * n_sm // (seg_groups * ch_groups))
    tile = SEG_TILES[1] if n_b * -(-n // SEG_TILES[1]) >= fit else SEG_TILES[0]
    tpp = -(-n // tile)
    return SegsumPlan(mt, seg_groups, ch_groups, tile, tpp, n_b * tpp,
                      max(1, min(n_b * tpp, fit)))


def segsum_smem_bytes(plan: SegsumPlan, n_ch: int) -> int:
    """The kernel's dynamic shared memory: the ring of staged tiles (ids and
    up to cp channel rows, tile + 16 floats apart) or, after the tiles, the
    warps' sums (rows of cp + 4), whichever is larger, then the block's
    scalar sums."""
    stage = plan.tile + min(plan.cp, n_ch) * (plan.tile + 16)
    return 4 * (max(SEG_STAGES * stage, SEG_WARPS * SEG_GROUP * (plan.cp + 4))
                + SEG_GROUP * plan.cp)


def segsum_tiles(plan: SegsumPlan):
    """(block, step) of each tile of a pass, tile q = b tiles_per_plane + j
    covering lanes tile j ... of plane b: block q mod blocks takes its tiles
    in order, tile q at step q // blocks; int64 (tiles,) each."""
    q = torch.arange(plan.tiles)
    return q % plan.blocks, q // plan.blocks


def segsum_lane_slots(lanes: int):
    """Where each of a warp's ``lanes`` lanes of a tile (an eighth of it)
    enters the products: its (pair step, chunk, column) int64 (lanes,)
    each.  Pair step p takes lanes 16 p + 4 t + r (t the lane's place in a
    quad, r < 4) in one 16-byte load; component r is chunk r // 2, column t
    + 4 (r % 2) of the m16n8k8 product's depth."""
    lane = torch.arange(lanes)
    t, r = (lane % 16) // 4, lane % 4
    return lane // 16, r // 2, t + 4 * (r % 2)


def tf32_split(x):
    """``(hi, lo)``: x rounded to TF32 (to nearest, ties away from zero, by
    integer bit operations as the kernel rounds) and x - hi so rounded.  For
    |x| < TF32_OVER, |x - hi - lo| <= 2^-23 |x|, or half TF32's subnormal
    spacing (2^-137) where that is larger (|x| < 2^-114).  The kernel takes
    larger and non-finite cotangents on its scalar path."""
    def rna(v):
        return ((v.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(
            torch.float32)

    hi = rna(x)
    return hi, rna(x - hi)


def sm_count(device) -> int:
    """The SMs of CUDA device ``device``, asked once."""
    if device not in _SM_COUNT:
        _SM_COUNT[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SM_COUNT[device]


def segsum_model(idx, cot, n_seg: int, n_sm: int = 132):
    """A plain model of the kernel's sum, in its order: for each pass and
    each warp's eighth of a tile, the one-hot product of the TF32 split
    (hi + lo, taken exactly and rounded once to float32: the tensor cores'
    own rounding is not modelled); added in float32 to the warp's sums tile
    after tile; the warps' sums in warp order, then the block's scalar sums
    (a kept lane's cotangent at or above TF32_OVER in magnitude, or not
    finite, added alone to its own entry; zero in the product, as are the
    dropped lanes'); the blocks' partials in the reduce's order.  idx (B,
    n) int32, cot (B, C, n) float32 on the CPU; (n_seg, C) float32."""
    n_b, n_ch, n = cot.shape
    plan = segsum_plan(n_b, n, n_seg, n_ch, n_sm)
    lanes = plan.tiles_per_plane * plan.tile
    ids = torch.full((n_b, lanes), -1, dtype=torch.int64)
    ids[:, :n] = idx
    x = torch.zeros((n_b, n_ch, lanes), dtype=torch.float32)
    x[:, :, :n] = torch.where(idx[:, None, :] >= 0, cot, 0.0)
    # (tile, warp, lane) with tile q = b tiles_per_plane + j.
    w_lanes = plan.tile // SEG_WARPS
    ids = ids.reshape(plan.tiles, SEG_WARPS, w_lanes)
    x = x.reshape(n_b, n_ch, plan.tiles_per_plane, SEG_WARPS, w_lanes).permute(
        0, 2, 3, 4, 1).reshape(plan.tiles, SEG_WARPS, w_lanes, n_ch)
    small = x.abs() < TF32_OVER
    hi, lo = tf32_split(torch.where(small, x, 0.0))
    term = hi.double() + lo.double()
    block, step = segsum_tiles(plan)
    steps = int(step.max()) + 1
    out = torch.zeros((n_seg, n_ch), dtype=torch.float32)
    for sg in range(plan.seg_groups):
        s0 = SEG_GROUP * sg
        seg = ids - s0
        keep = (seg >= 0) & (seg < SEG_GROUP)
        slot = ((torch.arange(plan.tiles)[:, None, None] * SEG_WARPS
                 + torch.arange(SEG_WARPS)[:, None]) * SEG_GROUP + seg)[keep]
        prod = torch.zeros((plan.tiles * SEG_WARPS * SEG_GROUP, n_ch),
                           dtype=torch.float64)
        prod.index_add_(0, slot, term[keep])
        prod = prod.float().reshape(plan.tiles, SEG_WARPS, SEG_GROUP, n_ch)
        scalar = torch.zeros((plan.blocks, SEG_GROUP, n_ch))
        big = keep[..., None] & ~small
        where = big.nonzero(as_tuple=True)
        scalar.index_put_((block[where[0]], seg[where[:3]], where[3]), x[big],
                          accumulate=True)
        sums = torch.zeros((plan.blocks, SEG_WARPS, SEG_GROUP, n_ch))
        for k in range(steps):
            at = step == k
            sums[block[at]] += prod[at]
        part = sums[:, 0]
        for w in range(1, SEG_WARPS):
            part = part + sums[:, w]
        part = part + scalar
        red = []
        for w in range(SEG_WARPS):
            v = torch.zeros((SEG_GROUP, n_ch))
            for b in range(w, plan.blocks, SEG_WARPS):
                v = v + part[b]
            red.append(v)
        total = red[0]
        for w in range(1, SEG_WARPS):
            total = total + red[w]
        out[s0:s0 + SEG_GROUP] = total[:n_seg - s0]
    return out


def _check_segsum(idx, cot):
    if idx.dim() != 2 or cot.dim() != 3 or idx.dtype != torch.int32 \
            or cot.dtype != torch.float32 or cot.shape[0] != idx.shape[0] \
            or cot.shape[2] != idx.shape[1] or cot.device != idx.device:
        raise ValueError(f"idx must be (B, n) int32 and cot (B, C, n) float32 "
                         f"on one device, got {idx.dtype} {tuple(idx.shape)}, "
                         f"{cot.dtype} {tuple(cot.shape)}")


def segsum(idx, cot, n_seg: int):
    """(n_seg, C) float32 segment sums of ``cot`` by ``idx`` (see the module
    note)."""
    _check_segsum(idx, cot)
    if idx.device.type == "cpu":
        return segsum_plain(idx, cot, n_seg)
    if idx.device.type != "cuda":
        raise ValueError(f"no kernel for device {idx.device}")
    n_b, n_ch, n = cot.shape
    if n_b * n * n_seg * n_ch == 0:
        return torch.zeros((n_seg, n_ch), dtype=torch.float32,
                           device=idx.device)
    idx, cot = idx.contiguous(), cot.contiguous()
    plan = segsum_plan(n_b, n, n_seg, n_ch, sm_count(idx.device))
    vec = 4 if n % 4 == 0 and idx.data_ptr() % 16 == 0 \
        and cot.data_ptr() % 16 == 0 else 1
    part = torch.empty(plan.passes * plan.blocks * SEG_GROUP * plan.cp,
                       dtype=torch.float32, device=idx.device)
    out = torch.empty((n_seg, n_ch), dtype=torch.float32, device=idx.device)
    with torch.cuda.device(idx.device):
        err = load_library().cpt_segsum(
            idx.data_ptr(), cot.data_ptr(), n_b, n, n_seg, n_ch,
            part.data_ptr(), out.data_ptr(), plan.tile, plan.blocks, vec,
            torch.cuda.current_stream(idx.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"segsum launch failed: CUDA error {err}")
    LAUNCHES["segsum"] += 1
    return out
