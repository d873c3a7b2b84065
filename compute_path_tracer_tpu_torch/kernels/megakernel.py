"""One progressive frame through the CUDA megakernels, and their plain torch
versions.

``render_frame_megakernel`` keeps the signature and the defaults of the JAX
package's ``render_frame_pallas`` and dispatches on its mode:

* ``analytic_all=True`` or ``analytic_soa=True`` (with
  ``geometry="baked"``, union-only trees, debug 0 or 3): bake the params
  (render/baked.py), pack the shape tables (render/soa.py), and one launch
  of ``csrc/megakernel_analytic.cu`` (K1) renders the frame with
  closed-form hits.  JAX's ``analytic_soa`` (K5) is its ``analytic_all``
  walked over the same packed tables at run time, bit-exact with it, which
  is what K1 does at any primitive count;
* otherwise the marching modes: fill the CSG program's table
  (render/program.py) for ``geometry`` "faithful" or "baked", and one
  launch of ``csrc/megakernel_march.cu`` (K2) sphere-marches the frame,
  with per-thread t-interval culling when ``t_cull``, in debug 0-4 (debug
  4: the march statistics per warp, ``MarchStats``).  With
  ``t_cull``, ``analytic_unboxed`` (baked, debug 0 or 3) intersects the
  guard-less shapes of ``analytic_eligible_ids`` in closed form and caps the
  march of the remaining program with them (``make_analytic_unboxed``), and
  ``omega`` != 1 over-relaxes the march; as in JAX, ``omega`` is ignored
  outside the t-culled march of debug 0 and 3.  ``dist_grid`` (baked,
  t_cull, debug 0 or 3; K6) bakes the frame's distance grid
  (render/distgrid.py, ``grid_res``) from the same baked vector as the
  table, and the march steps by its bound wherever that is at least
  ``grid_tau``, taking exact map taps only nearer to a surface; it composes
  with ``analytic_unboxed`` and, as in JAX, ignores ``omega``.
  ``normals="autodiff"`` takes every normal of K2 and K6 as the exact
  gradient of the map at the hit (the EXACT instantiations, one
  forward-mode walk; plain version ``render/program.py:make_grad_program``)
  in place of the 6-tap central difference; ``refresh_every`` freezes the
  t-culled march's activation window for that many steps (debug 0 and 3;
  ignored where JAX ignores it, as ``omega`` is).

``render_accumulated_megakernel`` renders ``n_frames`` progressive frames
into one accumulator on the device (JAX ``render_accumulated_pallas``).

Either kernel updates the (H, W, 3) float32 accumulator in place, or a
(crop_h, W, 3) band of the frame's rows from ``row_offset`` on (JAX's row
offset, which parallel/mesh.py gives each shard), bit for bit those rows
of the whole frame.  On a CPU tensor the same call runs
``render_frame_megakernel_plain``: the frame in vectorized torch, which is
also the reference the kernels are held to.  The
per-frame table work runs on the params' device with cached index tensors,
so a frame issues no host round trip.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..constants import BIG, DEFAULT_BOUNCES, DEFAULT_FOV, FP, MAT_SIZE, STEPS
from ..render.baked import (
    GEOM_SLOTS,
    analytic_eligible_ids,
    bake,
    baked_layout,
    baked_shapes_in_order,
)
from ..render.distgrid import (
    DEFAULT_RES as GRID_DEFAULT_RES,
    GRID_TAU,
    DistGrid,
    grid_code_on,
    grid_eligible,
    make_dist_grid,
    make_grid_tap,
)
from ..render.program import (
    OPC_SHAPE,
    Program,
    build_program,
    cast_grid,
    cast_tcull,
    make_grad_program,
    make_map_program,
    program_bounds,
    program_code_on,
    program_table,
    walk_smem_bytes,
    warp_records,
)
from ..render.reference import (
    calc_normal,
    cast_ray,
    gather_material,
    running_mean,
    take_lanes,
    trace_pixels,
)
from ..render.soa import (
    SoaSmemLayout,
    _kind_normal,
    _kind_t,
    analytic_smem_bytes,
    build_soa_smem_layout,
    build_staged_layout,
    make_cast_soa,
    make_normal_soa,
    material_table,
    pack_soa_smem,
    recip_in_range,
    recip_quotient_plain,
    staged_src_on,
)
from ..scene.compile import SceneSpec
from ..scene.model import KIND_SPHERE
from ..vecmath import Vec3, sqrt_rn, vwhere
from .build import load_library

# Launches per kernel since import (or since a caller reset them): the counts
# a run reads to show that its path went through the kernels.
LAUNCHES = {"megakernel_analytic": 0, "megakernel_march": 0}


def _kernel_for(spec: SceneSpec, geometry: str, debug: int, normals: str,
                t_cull: bool, omega: float, analytic_unboxed: bool,
                refresh_every: int, dist_grid: bool, analytic_all: bool,
                analytic_soa: bool) -> str:
    """"analytic" (K1) or "march" (K2, and K6 with ``dist_grid``) for a
    mode of render_frame_pallas.  Raises the JAX package's ``ValueError``s
    where it raises them (megakernel.py:1220-1272 and, for
    ``refresh_every``, :693-700 in the t-culled march of debug 0 and 3; its
    ``tile_w == 128`` check of ``dist_grid`` has no counterpart: the port
    takes no tile), and ``ValueError`` for a ``normals`` other than
    "central" and "autodiff" (JAX takes any other value as "central") and a
    ``refresh_every`` below 1."""
    if geometry not in ("faithful", "baked"):
        raise ValueError("geometry must be 'faithful' or 'baked'")
    baked = geometry == "baked"
    if analytic_soa:
        if not baked:
            raise ValueError("analytic_soa requires geometry='baked'")
        if analytic_all or analytic_unboxed or dist_grid:
            raise ValueError("analytic_soa is its own full-analytic mode; "
                             "enable only one")
        if debug not in (0, 3):
            raise ValueError(
                "analytic_soa supports the path-traced modes (debug 0/3)")
    if analytic_all:
        if not baked:
            raise ValueError("analytic_all requires geometry='baked'")
        if analytic_unboxed or dist_grid:
            raise ValueError("analytic_all subsumes analytic_unboxed and "
                             "dist_grid; enable only one")
        if debug not in (0, 3):
            raise ValueError("analytic_all renders the path-traced modes "
                             "(debug 0/3)")
    if dist_grid:
        if not (baked and t_cull):
            raise ValueError(
                "dist_grid requires geometry='baked' and t_cull=True")
        if debug not in (0, 3):
            raise ValueError(
                "dist_grid supports the path-traced modes (debug 0/3); the "
                "id-march and stats diagnostics stay faithful")
        if not grid_eligible(spec):
            raise ValueError("dist_grid requires at least one bounded leaf")
    if analytic_unboxed:
        if not (baked and t_cull):
            raise ValueError("analytic_unboxed requires geometry='baked' and "
                             "t_cull=True")
        if debug in (1, 2):
            raise ValueError("analytic_unboxed supports the path-traced "
                             "modes (debug 0/3/4)")
    _exact(normals)
    if debug not in (0, 1, 2, 3, 4):
        raise ValueError(f"debug must be in 0..=4, not {debug}")
    kernel = "analytic" if analytic_all or analytic_soa else "march"
    # K1 and K5 take no window: only K >= 1 is checked for them.
    _march_refresh(refresh_every, t_cull and kernel == "march", debug,
                   dist_grid, omega)
    return kernel


def _layout_for(spec: SceneSpec, mode: str = "analytic_all") -> SoaSmemLayout:
    layout = build_soa_smem_layout(spec)
    if layout is None:
        raise ValueError(f"{mode} requires a union-only tree")
    return layout


def make_analytic_unboxed(spec: SceneSpec):
    """The closed form of ``analytic_unboxed`` (JAX
    ``_make_analytic_unboxed``) over the shapes of ``analytic_eligible_ids``
    in walk order, reading their baked rows from ``bv``; the leaf closed
    forms are K1's (render/soa.py).  Returns ``(cap_fn, normal_fn,
    closest_fn)``:

    * ``cap_fn(ro, rd, bv) -> (t_cap, cap_idx)``: each ray's nearest hit of
      these shapes (BIG and -1 when none); a strict < keeps the earlier
      shape on an equal t;
    * ``normal_fn(p, cap_idx, bv) -> Vec3``: the capped shape's exact
      normal (zero where ``cap_idx`` names none of them);
    * ``closest_fn(ro, rd, bv) -> (d_ca, t_ca, idx_ca)``: the signed closest
      approach of the ray to the eligible spheres (planes and cubes are
      skipped, as in JAX), for the fused step's edge term."""
    eligible = analytic_eligible_ids(spec)
    shapes = [(bs.kind, bs.off, bs.shape_id)
              for bs in baked_shapes_in_order(spec) if bs.shape_id in eligible]

    def rows(bv, kind, off):
        return bv[off:off + GEOM_SLOTS[kind]]

    def cap_fn(ro: Vec3, rd: Vec3, bv):
        t_cap = torch.full_like(ro.x, BIG)
        cap_idx = torch.full_like(ro.x, -1, dtype=torch.int32)
        for kind, off, sid in shapes:
            t = _kind_t(kind, rows(bv, kind, off)[None, :], ro, rd)[0]
            closer = t < t_cap
            t_cap = torch.where(closer, t, t_cap)
            cap_idx = torch.where(closer, torch.full_like(cap_idx, sid),
                                  cap_idx)
        return t_cap, cap_idx

    def normal_fn(p: Vec3, cap_idx, bv) -> Vec3:
        zero = torch.zeros_like(p.x)
        n = Vec3(zero, zero, zero)
        for kind, off, sid in shapes:
            g = rows(bv, kind, off)[None, :].expand(p.x.shape[0], -1)
            n = vwhere(cap_idx == sid, _kind_normal(kind, g, p), n)
        return n

    def closest_fn(ro: Vec3, rd: Vec3, bv):
        d_ca = torch.full_like(ro.x, BIG)
        t_ca = torch.zeros_like(ro.x)
        i_ca = torch.full_like(ro.x, -1, dtype=torch.int32)
        for kind, off, sid in shapes:
            if kind != KIND_SPHERE:
                continue
            g = rows(bv, kind, off)
            oc = Vec3(ro.x - g[0], ro.y - g[1], ro.z - g[2])
            b = oc.x * rd.x + oc.y * rd.y + oc.z * rd.z
            oo = oc.x * oc.x + oc.y * oc.y + oc.z * oc.z
            d = sqrt_rn(torch.clamp(oo - b * b, min=0.0)) - g[3]
            # A closest point behind the origin: the origin's distance.
            d = torch.where(-b > 0.0, d, sqrt_rn(oo) - g[3])
            t = torch.clamp(-b, min=0.0)
            closer = d < d_ca
            d_ca = torch.where(closer, d, d_ca)
            t_ca = torch.where(closer, t, t_ca)
            i_ca = torch.where(closer, torch.full_like(i_ca, sid), i_ca)
        return d_ca, t_ca, i_ca

    return cap_fn, normal_fn, closest_fn


def capped_winners(t, t_cap, idx, cap_idx, hp: Vec3, normal_fn, bv, scale,
                   tap_fn):
    """The ``analytic_unboxed`` winner of each hit: a hit at ``t >= t_cap``
    is capped and takes ``cap_idx`` and ``scale`` times its exact normal
    (``make_analytic_unboxed``'s ``normal_fn``); every other hit keeps its
    id and ``tap_fn(tapped)``, the 6-tap vector of the program at those of
    its hit points.  ``hp`` holds the hit points in lane order, ``tapped``
    indexes them.  Returns (idx over all lanes, vector over the hits)."""
    hit = ~(t > FP)
    capped = hit & (t >= t_cap)
    idx = torch.where(capped, cap_idx, idx)
    ch = capped[hit]
    v = normal_fn(hp, torch.where(ch, idx[hit], -1), bv) * scale
    tapped = torch.nonzero(~ch).flatten()
    v_tap = tap_fn(tapped)
    return idx, Vec3(*(a.index_put((tapped,), b) for a, b in zip(v, v_tap)))


def _band(height: int, row_offset: int, crop_h, debug: int) -> int:
    """The rows of a band ``[row_offset, row_offset + crop_h)`` of a frame
    ``height`` rows high (``crop_h`` None: the rows from ``row_offset`` to
    the end); raises ``ValueError`` for a band outside the frame and, in
    debug 4, for one whose warps would not be the frame's."""
    row_offset = int(row_offset)
    crop_h = height - row_offset if crop_h is None else int(crop_h)
    rows = f"[{row_offset}, {row_offset + crop_h})"
    if row_offset < 0 or crop_h < 1 or row_offset + crop_h > height:
        raise ValueError(f"the band's rows {rows} are not rows of a frame "
                         f"{height} high")
    ends = row_offset + crop_h == height
    if debug == 4 and (row_offset % 2 or (crop_h % 2 and not ends)):
        raise ValueError(
            f"debug 4 counts per {WARP[0]}x{WARP[1]} warp: a band must start "
            f"on an even row and hold an even number of rows unless it ends "
            f"the frame, not rows {rows}")
    return crop_h


def _accum_for(accum, height: int, width: int, device) -> torch.Tensor:
    if accum is None:
        return torch.zeros((height, width, 3), dtype=torch.float32,
                           device=device)
    if accum.shape != (height, width, 3) or accum.dtype != torch.float32:
        raise ValueError(
            f"accum must be ({height}, {width}, 3) float32, got "
            f"{tuple(accum.shape)} {accum.dtype}")
    if accum.device != device or not accum.is_contiguous():
        raise ValueError("accum must be contiguous on the params' device")
    return accum


def _pixels(height: int, width: int, device, row_offset: int = 0):
    """The pixels of ``height`` rows from ``row_offset`` on: (xs, ys)."""
    ys, xs = torch.meshgrid(
        torch.arange(row_offset, row_offset + height, dtype=torch.int32,
                     device=device),
        torch.arange(width, dtype=torch.int32, device=device),
        indexing="ij")
    return xs, ys


# The pixels of one warp of K2 (megakernel_march.cu: 16x16 blocks, thread
# tx + 16 ty, warp = thread / 32), as (rows, columns), and the warps of a
# block, each with its own list of the program in shared memory.
WARP = (2, 16)
WARPS = 8


def warp_ids(xs, ys, width: int, group=WARP) -> torch.Tensor:
    """The group of each pixel ``(xs, ys)`` of a frame ``width`` wide, as
    flat int64: the warps of K2 for ``WARP`` (a 2x16 tile of pixels)."""
    gh, gw = group
    return ((ys // gh) * -(-width // gw) + xs // gw).reshape(-1).long()


class MarchStats:
    """Debug 4's statistics of a marching frame per group of pixels: JAX's
    per tile (megakernel.py:1390-1406), the port's per warp of K2 (``WARP``),
    its lockstep unit.  Per group, summed over the bounce loop:

    * ``x``: the march iterations it executed, one for each step at which
      at least one of its rays marches;
    * ``y``: over those iterations, the guarded shapes at least one of its
      marching rays evaluated (guard passed and, for a shape the t-culled
      march may drop, its interval held t);
    * ``z``: six times the shapes at least one of its rays evaluated in the
      normal taps (a guard-less shape counts 1; a capped hit takes no taps).

    x and y stay 0 without t_cull, as in JAX.  ``group=(1, 1)`` gives each
    pixel's own numbers, a JAX tile shape JAX's grouping.  Per bounce it
    also takes the length of each group's list of the program
    (render/program.py:warp_records), the list K2's plain march walks:
    ``walk_lists()``.

    The plain frame fills it (``render_frame_megakernel_plain(...,
    stats=)``): ``start``, then per bounce ``bounce`` with its lanes
    (``path_trace``'s ``on_bounce``), ``march`` per step (``cast_tcull``'s
    ``record``) and ``taps`` for the rays that take the normal taps.
    ``image()`` is debug 4's (H, W, 3) float32 frame: every pixel holds its
    group's (x, y, z), exact below 2^24.  ``lanes_xyz`` holds the same
    three sums over the rays themselves (the work the lanes needed: their
    march taps, guarded-leaf evaluations and normal-tap shapes), int64 on
    the device."""

    def __init__(self, group=WARP):
        self.group = (int(group[0]), int(group[1]))

    def start(self, prog: Program, height: int, width: int, device) -> None:
        xs, ys = _pixels(height, width, device)
        self.shape = (height, width)
        self.gid = warp_ids(xs, ys, width, self.group)
        self.xyz = torch.zeros((3, int(self.gid.max()) + 1), dtype=torch.int64,
                               device=device)
        self.lanes_xyz = torch.zeros(3, dtype=torch.int64, device=device)
        self.n_free = int(((prog.ops[:, 0] == OPC_SHAPE)
                           & (prog.ops[:, 3] < 0)).sum())
        self.lanes = None
        self.prog = prog
        self.walk = []

    def bounce(self, lanes) -> None:
        self.lanes = lanes

    def _union(self, sel, mask):
        """The groups of the bounce's rays ``sel`` and, per group, the
        columns of ``mask`` set for at least one of its rays."""
        gid = self.gid[self.lanes[sel]]
        groups, inv = torch.unique(gid, return_inverse=True)
        any_ = torch.zeros((groups.shape[0], mask.shape[1]), dtype=torch.int32,
                           device=gid.device).index_add_(0, inv, mask.int())
        return groups, (any_ > 0).sum(1)

    def march(self, live, active) -> None:
        groups, n = self._union(live, active)
        self.xyz[0].index_add_(0, groups, torch.ones_like(groups))
        self.xyz[1].index_add_(0, groups, n)
        self.lanes_xyz[0] += active.shape[0]
        self.lanes_xyz[1] += active.sum()

    def lists(self, check) -> None:
        """The bounce's guard bits (n, n_boxed) of all its rays: adds the
        summed length of its groups' lists and the number of lists."""
        groups, inv = torch.unique(self.gid[self.lanes], return_inverse=True)
        n = warp_records(self.prog, check, inv, groups.shape[0]).sum()
        self.walk.append(torch.stack([n, n.new_tensor(groups.shape[0])]))

    def walk_lists(self) -> torch.Tensor:
        """(bounces cast, 2) int64: per bounce, the summed list length and
        the number of lists (K2's ``walk_stats``)."""
        return torch.stack(self.walk) if self.walk else torch.zeros(
            (0, 2), dtype=torch.int64)

    def taps(self, sel, guard) -> None:
        groups, n = self._union(sel, guard)
        self.xyz[2].index_add_(0, groups, 6 * (n + self.n_free))
        self.lanes_xyz[2] += 6 * (guard.sum() + self.n_free * guard.shape[0])

    def image(self) -> torch.Tensor:
        img = self.xyz[:, self.gid].T.reshape(*self.shape, 3)
        return img.to(torch.float32)


def _count_segments(count, bounds):
    """``bounds`` that adds the rays it is called on to ``count["segments"]``
    (the ray segments of a frame: one per live path per bounce)."""
    if count is None:
        return bounds

    def counted(ro, rd):
        count["segments"] = count.get("segments", 0) + ro.x.shape[0]
        return bounds(ro, rd)

    return counted


def _analytic_plain(spec, params, xs, ys, frame, bounces, fov, aspect,
                    count=None, mode="analytic_all", **kw):
    """K1's frame: closed-form hits over the packed tables.  ``count``
    accumulates its ray segments."""
    layout = _layout_for(spec, mode)
    soa_f, soa_i = pack_soa_smem(layout, bake(spec, params), params)
    cast, normal = make_cast_soa(layout), make_normal_soa(layout)
    mats = material_table(layout, soa_f)
    return trace_pixels(
        _count_segments(count, lambda ro, rd: ((), None)),
        lambda ro, rd, _c: cast(ro, rd, soa_f, soa_i),
        lambda p, idx, _c: normal(p, idx, soa_f, soa_i),
        lambda idx: gather_material(mats, idx),
        xs, ys, frame, bounces, fov, aspect, **kw)


def _march_plain(prog: Program, table, t_cull, xs, ys, frame, bounces, fov,
                 aspect, count=None, omega=1.0, grid: DistGrid = None,
                 stats: MarchStats = None, exact: bool = False,
                 refresh_every: int = 1, **kw):
    """K2's frame: the CSG program interpreted per tap, the exact or the
    per-thread t-culled march, 6-tap normals under the bounce's guards or,
    with ``exact`` (``normals="autodiff"``), the exact gradient of the same
    map (``make_grad_program``, of the whole program with its caps).
    A program with ``caps`` (``analytic_unboxed``) caps the t-culled march
    with their closed form; a capped hit takes the capped shape's id and
    exact normal.  ``omega`` over-relaxes the t-culled march and
    ``refresh_every`` freezes its activation window (``cast_tcull``);
    ``grid`` (K6) replaces it with the distance-grid march (``cast_grid``).
    ``count`` accumulates its ray segments, map work (``make_map_program``;
    with ``exact`` the gradient's, ``make_grad_program``), grid taps and,
    as ``"cap_segments"``, the segments the cap is computed for.  ``stats``
    (a started :class:`MarchStats`) records the march steps (not with
    ``grid``), the normal taps (six map taps' worth, whatever the normal)
    and the per-warp lists of the frame's rays."""
    vals = table.tolist()
    map_fn = make_map_program(prog, vals, count)
    record = (stats.march if stats is not None and t_cull and grid is None
              else None)

    def map_checked(p, checks):
        return map_fn(p, checks[0])

    if exact:
        grad_fn = make_grad_program(prog, vals, count)

        def normal(p, _idx, c):
            return grad_fn(p, c[0])[1].normalize_safe()
    else:
        def normal(p, _idx, c):
            return calc_normal(map_checked, p, c[:1])

    def taps(sel, c):
        """The rays ``sel`` of the bounce take the 6 normal taps."""
        if stats is not None:
            stats.taps(sel, c[0][sel])

    if grid is not None:
        tap = make_grid_tap(prog.spec, grid, vals)

        def march(ro, rd, c, t_cap=None):
            return cast_grid(prog, map_fn, ro, rd, c, tap, grid.tau, t_cap,
                             count)
    else:
        def march(ro, rd, c, t_cap=None):
            return cast_tcull(prog, map_fn, ro, rd, c, t_cap, omega, record,
                              refresh_every)

    if prog.caps.shape[0]:
        cap_fn, cap_normal, _ = make_analytic_unboxed(prog.spec)
        bv = table[:baked_layout(prog.spec).n_slots]

        def cast(ro, rd, c):
            if count is not None:
                count["cap_segments"] = (count.get("cap_segments", 0)
                                         + ro.x.shape[0])
            t_cap, cap_idx = cap_fn(ro, rd, bv)
            t, idx = march(ro, rd, c, t_cap)
            lanes = torch.nonzero(~(t > FP)).flatten()
            hp = Vec3(*(v[lanes] for v in ro + rd * t))

            def tap(tp):
                taps(lanes[tp], c)
                return normal(Vec3(*(v[tp] for v in hp)), None,
                              take_lanes(c, lanes[tp]))

            idx, n_h = capped_winners(t, t_cap, idx, cap_idx, hp, cap_normal,
                                      bv, 1.0, tap)
            zero = torch.zeros_like(t)
            return t, idx, Vec3(*(zero.index_put((lanes,), v) for v in n_h))
    else:
        def cast(ro, rd, c):
            t, idx = (march(ro, rd, c) if t_cull
                      else cast_ray(map_checked, ro, rd, c))
            taps(~(t > FP), c)
            return t, idx

    def bounds(ro, rd):
        out = program_bounds(prog, table, ro, rd, t_cull)
        if stats is not None:
            stats.lists(out[0][0])
        return out

    mats = table[prog.f_mat:].view(prog.n_shapes, MAT_SIZE)
    return trace_pixels(
        _count_segments(count, bounds),
        cast, normal,
        lambda idx: gather_material(mats, idx),
        xs, ys, frame, bounces, fov, aspect,
        on_bounce=None if stats is None else stats.bounce, **kw)


def _march_tables(spec: SceneSpec, params, geometry, t_cull,
                  analytic_unboxed, dist_grid, grid_res, grid_tau):
    """The march's program, its table and, for ``dist_grid``, the frame's
    grid, from one bake of the params."""
    prog = build_program(spec, geometry, analytic_unboxed)
    bv = bake(spec, params) if geometry == "baked" or t_cull else None
    table = program_table(prog, params, t_cull, bv)
    grid = make_dist_grid(spec, bv, grid_res, grid_tau) if dist_grid else None
    return prog, table, grid


def render_frame_megakernel_plain(
    spec: SceneSpec,
    params: torch.Tensor,
    accum=None,
    frame: int = 0,
    last_clear: int = 0,
    *,
    width: int = 256,
    height: int = 256,
    debug: int = 0,
    bounces: int = DEFAULT_BOUNCES,
    fov: float = DEFAULT_FOV,
    aspect: float = None,
    geometry: str = "faithful",
    normals: str = "central",
    t_cull: bool = False,
    omega: float = 1.0,
    analytic_unboxed: bool = False,
    refresh_every: int = 1,
    dist_grid: bool = False,
    grid_res=GRID_DEFAULT_RES,
    grid_tau: float = GRID_TAU,
    analytic_all: bool = False,
    analytic_soa: bool = False,
    count: dict = None,
    stats: MarchStats = None,
    row_offset: int = 0,
    crop_h: int = None,
) -> torch.Tensor:
    """The kernels' frame in vectorized torch, on ``params``' device.
    ``row_offset`` and ``crop_h`` render the band of rows ``[row_offset,
    row_offset + crop_h)`` of the (height, width) frame into a (crop_h,
    width, 3) accumulator, bit for bit those rows of the frame (``crop_h``
    None: to the frame's end).
    ``count``, a dict, accumulates the work the kernel does for the frame:
    its ``"segments"`` (ray segments, one per live path per bounce) and, for
    the march, its map work (``render/program.py:make_map_program``), its
    grid taps and the segments that compute the ``analytic_unboxed`` cap.

    ``debug=4`` returns :class:`MarchStats`' image of the frame's paths,
    per ``WARP`` unless ``stats`` brings another group.  ``stats`` in debug 0
    or 3 (the march) is filled as well: one pass then gives the frame and
    its debug-4 statistics (with ``dist_grid``, its per-warp lists and
    normal taps only: x and y stay 0)."""
    kernel = _kernel_for(spec, geometry, debug, normals, t_cull, omega,
                         analytic_unboxed, refresh_every, dist_grid,
                         analytic_all, analytic_soa)
    if aspect is None:
        aspect = width / height
    device = params.device
    crop_h = _band(height, row_offset, crop_h, debug)
    accum = _accum_for(accum, crop_h, width, device)
    xs, ys = _pixels(crop_h, width, device, int(row_offset))
    if debug == 4 and stats is None:
        stats = MarchStats()
    if stats is not None and (kernel != "march" or debug in (1, 2)):
        raise ValueError("debug 4's statistics take the march of debug 0, 3 "
                         "or 4")
    kw = dict(width=width, height=height, debug=0 if debug == 4 else debug)
    with torch.no_grad():
        if kernel == "analytic":
            col = _analytic_plain(
                spec, params, xs, ys, frame, bounces, fov, aspect, count,
                "analytic_soa" if analytic_soa else "analytic_all", **kw)
        else:
            prog, table, grid = _march_tables(
                spec, params, geometry, t_cull, analytic_unboxed, dist_grid,
                grid_res, grid_tau)
            if stats is not None:
                stats.start(prog, crop_h, width, device)
            col = _march_plain(prog, table, t_cull, xs, ys, frame, bounces,
                               fov, aspect, count,
                               _march_omega(omega, t_cull, debug, dist_grid),
                               grid, stats, normals == "autodiff",
                               _march_refresh(refresh_every, t_cull, debug,
                                              dist_grid), **kw)
        img = stats.image() if debug == 4 else col.stack()
        if debug != 0:
            return accum.copy_(img)
        return accum.copy_(running_mean(accum, img, last_clear))


def _frame_launcher(spec: SceneSpec, params: torch.Tensor, *, width, height,
                    debug, bounces, fov, aspect, geometry, normals, t_cull,
                    omega, analytic_unboxed, refresh_every, dist_grid,
                    grid_res, grid_tau, analytic_all, analytic_soa,
                    row_offset=0, crop_h=None):
    """Checks a mode and makes the frame's tables on the card, once;
    returns ``launch(accum, frame, last_clear)``, which launches the mode's
    kernel on them, over the band ``row_offset``, ``crop_h`` (the whole
    frame by default; ``accum`` holds the band's rows)."""
    if params.device.type != "cuda":
        raise ValueError(f"no kernel for device {params.device}")
    kernel = _kernel_for(spec, geometry, debug, normals, t_cull, omega,
                         analytic_unboxed, refresh_every, dist_grid,
                         analytic_all, analytic_soa)
    if params.dtype != torch.float32 or params.shape != (spec.n_params,):
        raise ValueError(
            f"params must be float32 of shape ({spec.n_params},), got "
            f"{params.dtype} {tuple(params.shape)}")
    if aspect is None:
        aspect = width / height
    _band(height, row_offset, crop_h, debug)
    run = dict(bounces=bounces, fov=fov, aspect=aspect, debug=debug,
               height=height, row_offset=row_offset)
    with torch.no_grad():
        if kernel == "analytic":
            layout = _layout_for(
                spec, "analytic_soa" if analytic_soa else "analytic_all")
            soa_f, soa_i = pack_soa_smem(layout, bake(spec, params), params)

            def launch(accum, frame, last_clear):
                launch_megakernel(layout, soa_f, soa_i, accum, frame=frame,
                                  last_clear=last_clear, **run)
        else:
            prog, table, grid = _march_tables(
                spec, params, geometry, t_cull, analytic_unboxed, dist_grid,
                grid_res, grid_tau)
            om = _march_omega(omega, t_cull, debug, dist_grid)
            k = _march_refresh(refresh_every, t_cull, debug, dist_grid)

            def launch(accum, frame, last_clear):
                launch_march(prog, table, accum, frame=frame,
                             last_clear=last_clear, t_cull=t_cull, omega=om,
                             grid=grid, normals=normals, refresh_every=k,
                             **run)
    return launch


def render_frame_megakernel(
    spec: SceneSpec,
    params: torch.Tensor,
    accum=None,
    frame: int = 0,
    last_clear: int = 0,
    *,
    width: int = 256,
    height: int = 256,
    debug: int = 0,
    bounces: int = DEFAULT_BOUNCES,
    fov: float = DEFAULT_FOV,
    aspect: float = None,
    geometry: str = "faithful",
    normals: str = "central",
    t_cull: bool = False,
    omega: float = 1.0,
    analytic_unboxed: bool = False,
    refresh_every: int = 1,
    dist_grid: bool = False,
    grid_res=GRID_DEFAULT_RES,
    grid_tau: float = GRID_TAU,
    analytic_all: bool = False,
    analytic_soa: bool = False,
    row_offset: int = 0,
    crop_h: int = None,
) -> torch.Tensor:
    """One progressive frame through a CUDA megakernel; returns the (H, W,
    3) float32 accumulator, updated in place (a new zero one when ``accum``
    is None; debug modes overwrite it with their image).  ``row_offset``
    and ``crop_h`` (JAX's row offset, the port's band height) render only
    the rows ``[row_offset, row_offset + crop_h)`` of the frame into a
    (crop_h, W, 3) accumulator, bit for bit those rows of the whole frame;
    debug 4's band must start on an even row and hold an even number of
    rows unless it ends the frame (its statistics are per warp of 2 rows).

    Runs on ``params``' device: a CUDA tensor launches K1
    (``analytic_all=True`` or ``analytic_soa=True``) or K2 (the marching
    modes, ``analytic_unboxed``, ``omega`` and ``dist_grid`` included) on
    the current stream without synchronising, a CPU tensor runs
    :func:`render_frame_megakernel_plain`.  ``debug=4`` gives debug 4's
    statistics per warp of K2 (:class:`MarchStats`).  Every mode of
    ``render_frame_pallas`` runs: ``normals="autodiff"`` takes the exact
    gradient of the map in K2 and K6 (K1 and K5 take their closed-form
    normals either way, as in JAX) and ``refresh_every`` freezes the
    t-culled march's activation window in debug 0 and 3 (ignored where JAX
    ignores it: without ``t_cull``, with ``dist_grid``, in debug 1, 2 and
    4).  The combinations JAX rejects, and ``analytic_all`` /
    ``analytic_soa`` on a tree with a non-union op, raise ``ValueError``.
    """
    mode = dict(geometry=geometry, normals=normals, t_cull=t_cull, omega=omega,
                analytic_unboxed=analytic_unboxed,
                refresh_every=refresh_every, dist_grid=dist_grid,
                grid_res=grid_res, grid_tau=grid_tau,
                analytic_all=analytic_all, analytic_soa=analytic_soa)
    band = dict(row_offset=row_offset, crop_h=crop_h)
    if params.device.type == "cpu":
        return render_frame_megakernel_plain(
            spec, params, accum, frame, last_clear, width=width,
            height=height, debug=debug, bounces=bounces, fov=fov,
            aspect=aspect, **mode, **band)
    launch = _frame_launcher(spec, params, width=width, height=height,
                             debug=debug, bounces=bounces, fov=fov,
                             aspect=aspect, **mode, **band)
    accum = _accum_for(accum, _band(height, row_offset, crop_h, debug), width,
                       params.device)
    launch(accum, frame, last_clear)
    return accum


def render_accumulated_megakernel(
    spec: SceneSpec,
    params: torch.Tensor,
    n_frames: int,
    *,
    width: int = 256,
    height: int = 256,
    bounces: int = DEFAULT_BOUNCES,
    fov: float = DEFAULT_FOV,
    aspect: float = None,
    geometry: str = "faithful",
    normals: str = "central",
    t_cull: bool = False,
    analytic_all: bool = False,
    frame0: int = 0,
) -> torch.Tensor:
    """``n_frames`` progressive frames into one zero (H, W, 3) float32
    accumulator (JAX ``render_accumulated_pallas``): frame k uses RNG
    stream ``frame0 + k`` and running-mean weight 1/(k+1), so frame 0
    overwrites.  On a CUDA tensor the tables are made once and K1
    (``analytic_all``) or K2 runs ``n_frames`` times on the accumulator,
    with no host round trip; on a CPU tensor each frame is
    :func:`render_frame_megakernel_plain`.
    Either way the result is that of ``n_frames`` calls of
    :func:`render_frame_megakernel` bit for bit."""
    mode = dict(width=width, height=height, debug=0, bounces=bounces,
                fov=fov, aspect=aspect, geometry=geometry, normals=normals,
                t_cull=t_cull, omega=1.0, analytic_unboxed=False,
                refresh_every=1, dist_grid=False, grid_res=GRID_DEFAULT_RES,
                grid_tau=GRID_TAU, analytic_all=analytic_all,
                analytic_soa=False)
    accum = torch.zeros((height, width, 3), dtype=torch.float32,
                        device=params.device)
    if params.device.type == "cpu":
        for k in range(int(n_frames)):
            render_frame_megakernel_plain(spec, params, accum, frame0 + k, k,
                                          **mode)
        return accum
    launch = _frame_launcher(spec, params, **mode)
    for k in range(int(n_frames)):
        launch(accum, frame0 + k, k)
    return accum


def _march_omega(omega: float, t_cull: bool, debug: int,
                 dist_grid: bool = False) -> float:
    """The over-relaxation the march applies: JAX takes ``omega`` only in
    the t-culled march of debug 0 and 3 and ignores it elsewhere
    (megakernel.py:1069-1089, :1418-1435), the grid march included
    (``_march_while_grid`` takes none)."""
    return (float(omega) if t_cull and debug in (0, 3) and not dist_grid
            else 1.0)


def _march_refresh(refresh_every: int, t_cull: bool, debug: int,
                   dist_grid: bool = False, omega: float = 1.0) -> int:
    """The activation window the march freezes: JAX takes
    ``refresh_every`` only in the t-culled march of debug 0 and 3, as
    ``omega`` (megakernel.py:1076-1080; debug 4's march and the grid march
    take none).  Raises JAX's ``ValueError``s where the march takes it
    (``omega`` != 1, a K that does not divide STEPS: :693-700) and, where
    JAX does not raise, one for a K below 1."""
    k = int(refresh_every)
    if k < 1:
        raise ValueError(f"refresh_every must be at least 1, not {k}")
    if not (t_cull and debug in (0, 3) and not dist_grid):
        return 1
    if k != 1 and _march_omega(omega, t_cull, debug, dist_grid) != 1.0:
        raise ValueError("refresh_every requires omega=1.0, with_stats=False")
    if STEPS % k:
        raise ValueError(f"STEPS={STEPS} not divisible by refresh_every={k}")
    return k


def _exact(normals: str) -> bool:
    """Whether ``normals`` asks for the exact normal ("autodiff"); raises
    ``ValueError`` for a value other than it and "central" (JAX's
    megakernel takes any other value as "central")."""
    if normals not in ("central", "autodiff"):
        raise ValueError(f"normals must be 'central' or 'autodiff', not "
                         f"{normals!r}")
    return normals == "autodiff"


def _check_accum(accum: torch.Tensor) -> None:
    if (accum.device.type != "cuda" or accum.dtype != torch.float32
            or accum.dim() != 3 or accum.shape[2] != 3
            or not accum.is_contiguous()):
        raise ValueError("accum must be a contiguous CUDA (H, W, 3) float32 "
                         "tensor")


def _check_table(name, t, dtype, n, device) -> None:
    if (t.device != device or t.dtype != dtype or t.shape != (n,)
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be contiguous {dtype} ({n},) on {device}")


@lru_cache(maxsize=32)
def _kernel_meta(layout: SoaSmemLayout, device: torch.device):
    """Per-kind records and the shape id -> (kind, geometry row offset)
    lookup the fused step's cast reads (kernels/train.py), as int32 tensors
    on ``device``."""
    kmeta = np.asarray(
        [[kd.kind, kd.n, kd.w, kd.a, kd.f_geom, kd.f_aabb, kd.f_anc,
          kd.i_sid, kd.i_guard, kd.i_anc_valid] for kd in layout.kinds],
        np.int32)
    sid_lut = np.zeros((layout.n_shapes, 2), np.int32)
    sid_lut[:, 0] = -1
    for kd in layout.kinds:
        sids = layout.i_const[kd.i_sid:kd.i_sid + kd.n]
        sid_lut[sids, 0] = kd.kind
        sid_lut[sids, 1] = kd.f_geom + kd.w * np.arange(kd.n)
    return (torch.as_tensor(kmeta, device=device),
            torch.as_tensor(sid_lut, device=device))


# Fields of K1's lane statistics (launch_megakernel's lane_stats; the
# kernel's ST_* slots): warp casts, lane casts, per warp cast the shapes some
# lane entered, per lane cast the shapes it entered, lane casts that took
# the plain division.
LANE_STATS = ("warp_casts", "lane_casts", "warp_shapes", "lane_shapes",
              "slow_casts")

# The work counter of the persistent kernels (K1's tiles, the wavefront
# bounce's ray chunks), one int32 per (device, stream), made at the first
# launch there: launches on one stream run in order, and each kernel's entry
# point zeroes the counter on the stream before its launch.
_WORK_COUNTER = {}


def work_counter(device: torch.device, stream: int) -> torch.Tensor:
    key = (device, stream)
    if key not in _WORK_COUNTER:
        _WORK_COUNTER[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _WORK_COUNTER[key]


def launch_megakernel(layout: SoaSmemLayout, soa_f: torch.Tensor,
                      soa_i: torch.Tensor, accum: torch.Tensor, *, frame: int,
                      last_clear: int, bounces: int, fov: float, aspect: float,
                      debug: int, lane_stats: torch.Tensor = None,
                      per_tile: bool = False, height: int = None,
                      row_offset: int = 0) -> None:
    """Launch K1 on packed tables (``pack_soa_smem``) and a CUDA (H, W, 3)
    float32 accumulator, on the current stream; counts the launch in
    ``LAUNCHES["megakernel_analytic"]``.  With the frame's ``height`` and a
    ``row_offset``, the accumulator holds the band of its rows from
    ``row_offset`` on (``height`` None: the accumulator is the frame).
    Each block stages the scene in shared memory (``analytic_smem_bytes``,
    which raises for a scene too large).  ``lane_stats``, a zeroed int64 CUDA tensor of
    ``len(LANE_STATS)``, runs the kernel's STATS instantiation, which adds
    the frame's lane statistics; ``per_tile`` takes them under the
    schedule without refill (a warp per 16x2 tile of pixels)."""
    if debug not in (0, 3):
        raise ValueError(f"the kernel renders debug 0 or 3, not {debug}")
    if per_tile and lane_stats is None:
        raise ValueError("per_tile needs lane_stats")
    analytic_smem_bytes(layout)
    _check_accum(accum)
    device = accum.device
    crop_h, width = accum.shape[0], accum.shape[1]
    height = crop_h if height is None else int(height)
    _band(height, row_offset, crop_h, debug)
    _check_table("soa_f", soa_f, torch.float32, layout.f_len, device)
    _check_table("soa_i", soa_i, torch.int32, layout.i_len, device)
    if lane_stats is not None:
        _check_table("lane_stats", lane_stats, torch.int64, len(LANE_STATS),
                     device)
    staged = build_staged_layout(layout)
    src = staged_src_on(layout, device)
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.cpt_megakernel_analytic(
            soa_f.data_ptr(), soa_i.data_ptr(), src.data_ptr(),
            staged.meta.ctypes.data, accum.data_ptr(), width, height,
            int(row_offset), crop_h, int(frame), int(last_clear),
            int(bounces), float(fov), float(aspect), int(debug),
            work_counter(device, stream).data_ptr(),
            None if lane_stats is None else lane_stats.data_ptr(),
            int(bool(per_tile)), stream)
    if err != 0:
        raise RuntimeError(f"megakernel launch failed: CUDA error {err}")
    LAUNCHES["megakernel_analytic"] += 1


def quotient_check(b: torch.Tensor, o: torch.Tensor, d: torch.Tensor):
    """K1's box-test quotient on float32 triples: ``(q_fast, q_div,
    in_range)`` for x = b - o, the quotient with the reciprocal of ``d``
    hoisted (kernels/csrc/analytic_staged.cuh:recip_quotient), the division
    x / d, and whether (b, o, d) lies in the range where the kernel takes
    the hoisted quotient.  On CUDA tensors the kernel's
    ``quotient_check`` computes them (``q_div`` by ``__fdiv_rn``); on CPU
    tensors :func:`render.soa.recip_quotient_plain` and ``/``."""
    if b.device.type == "cpu":
        bn, on, dn = (t.numpy() for t in (b, o, d))
        x = bn - on
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            q_div = x / dn
        return (torch.from_numpy(recip_quotient_plain(x, dn)),
                torch.from_numpy(q_div),
                torch.from_numpy(recip_in_range(bn, on, dn)))
    n = b.shape[0]
    for name, t in (("b", b), ("o", o), ("d", d)):
        _check_table(name, t, torch.float32, n, b.device)
    q_fast, q_div = torch.empty_like(b), torch.empty_like(b)
    in_range = torch.empty(n, dtype=torch.int32, device=b.device)
    lib = load_library()
    with torch.cuda.device(b.device):
        err = lib.cpt_quotient_check(
            b.data_ptr(), o.data_ptr(), d.data_ptr(), n, q_fast.data_ptr(),
            q_div.data_ptr(), in_range.data_ptr(),
            torch.cuda.current_stream(b.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"quotient_check launch failed: CUDA error {err}")
    return q_fast, q_div, in_range.bool()


def launch_march(prog: Program, table: torch.Tensor, accum: torch.Tensor, *,
                 frame: int, last_clear: int, bounces: int, fov: float,
                 aspect: float, debug: int, t_cull: bool,
                 omega: float = 1.0, grid: DistGrid = None,
                 grid_stats: torch.Tensor = None,
                 walk_stats: torch.Tensor = None, height: int = None,
                 row_offset: int = 0, normals: str = "central",
                 refresh_every: int = 1) -> None:
    """Launch K2 on a program's table (``program_table``) and a CUDA (H, W,
    3) float32 accumulator, on the current stream; counts the launch in
    ``LAUNCHES["megakernel_march"]``.  ``normals="autodiff"`` takes each
    normal as the exact gradient of the map (the EXACT instantiations:
    csg_program.cuh:grad_exact_walk, with a program's caps folded in) in
    place of the 6 taps, in every march (debug 0-4, RELAX, the grid march);
    ``refresh_every`` != 1 (t_cull, debug 0 or 3, no grid, omega 1; a
    divisor of STEPS) freezes the march's activation window
    (csg_program.cuh:march_refresh_walk).  With the frame's ``height`` and a
    ``row_offset``, the accumulator holds the band of its rows from
    ``row_offset`` on (``height`` None: the accumulator is the frame).  A
    program with ``caps`` caps the march in closed form (t_cull, debug 0, 3
    or 4), and ``omega`` != 1 over-relaxes it (t_cull, debug 0 or 3).  ``grid`` (K6, baked geometry,
    t_cull, debug 0 or 3, omega 1) marches on the frame's distance grid;
    ``grid_stats``, a zeroed int64 CUDA tensor of 5, then takes the warp
    statistics of the grid march (kernels/csrc/megakernel_march.cu).
    Debug 4 writes :class:`MarchStats`' image per warp, from the kernel's
    STATS instantiation.

    Every march (debug 0-4, the over-relaxed one and the grid march
    included) walks per-warp lists of the program staged in each block's
    shared memory (``walk_smem_bytes``, which raises for a program too
    large); ``walk_stats`` (debug 0 or 3), a zeroed int64 CUDA tensor of
    2 (bounces + 1), then takes per bounce the summed list length and the
    number of lists (:meth:`MarchStats.walk_lists`)."""
    if debug not in (0, 1, 2, 3, 4):
        raise ValueError(f"the kernel renders debug 0-4, not {debug}")
    relax = float(omega) != 1.0
    if prog.caps.shape[0] and not (t_cull and debug in (0, 3, 4)):
        raise ValueError("the closed-form cap needs t_cull and debug 0, 3 "
                         "or 4")
    if relax and not (t_cull and debug in (0, 3)):
        raise ValueError("omega needs t_cull and debug 0 or 3")
    if grid is not None and not (prog.geometry == "baked" and t_cull
                                 and debug in (0, 3) and not relax):
        raise ValueError("the grid march needs baked geometry, t_cull, "
                         "debug 0 or 3 and omega 1")
    if grid_stats is not None and grid is None:
        raise ValueError("grid_stats needs a grid")
    if walk_stats is not None and debug not in (0, 3):
        raise ValueError("walk_stats needs debug 0 or 3")
    exact = _exact(normals)
    refresh = int(refresh_every)
    if refresh != _march_refresh(refresh, t_cull, debug, grid is not None,
                                 omega):
        raise ValueError("refresh_every needs t_cull, debug 0 or 3 and no "
                         "grid")
    smem = walk_smem_bytes(prog, WARPS)
    _check_accum(accum)
    device = accum.device
    crop_h, width = accum.shape[0], accum.shape[1]
    height = crop_h if height is None else int(height)
    _band(height, row_offset, crop_h, debug)
    _check_table("table", table, torch.float32, prog.f_len, device)
    code = program_code_on(prog, device)
    gargs = [None, None, 0, 0, 0, None, 0, 0, 0.0, None]
    if grid is not None:
        gx, gy, gz = grid.res
        _check_table("grid meta", grid.meta, torch.float32, 9, device)
        _check_table("grid cells", grid.cells, torch.float32, gx * gy * gz,
                     device)
        gcode, n_planes, n_k = grid_code_on(prog.spec, device)
        gargs = [grid.meta.data_ptr(), grid.cells.data_ptr(), gx, gy, gz,
                 gcode.data_ptr(), n_planes, n_k, float(grid.tau), None]
        if grid_stats is not None:
            _check_table("grid_stats", grid_stats, torch.int64, 5, device)
            gargs[-1] = grid_stats.data_ptr()
    if walk_stats is not None:
        _check_table("walk_stats", walk_stats, torch.int64,
                     2 * (int(bounces) + 1), device)
    lib = load_library()
    with torch.cuda.device(device):
        err = lib.cpt_megakernel_march(
            code.data_ptr(), prog.ops.shape[0], table.data_ptr(), prog.n_boxed,
            prog.f_box, prog.f_mat, prog.caps.shape[0],
            int(prog.geometry == "baked"), int(bool(t_cull)), float(omega),
            accum.data_ptr(), width, height, int(row_offset), crop_h,
            int(frame), int(last_clear), int(bounces), float(fov),
            float(aspect), int(debug), *gargs, smem,
            None if walk_stats is None else walk_stats.data_ptr(),
            int(exact), refresh,
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"marching kernel launch failed: CUDA error {err}")
    LAUNCHES["megakernel_march"] += 1
