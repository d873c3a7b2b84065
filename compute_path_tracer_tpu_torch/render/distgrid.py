"""The baked lower-bound distance grid of the ``dist_grid`` march (JAX
package: ``render/distgrid.py``).

Per frame a coarse 3D grid over the box of every bounded leaf holds, per
cell, a lower bound of the scene map: the min over all leaves of their
1-Lipschitz distances at the cell's 8 corners, minus half the cell's
diagonal.  Outside the box the bound is the distance to the box, min'ed with
the exact distances of the plane leaves; everywhere, ``k/4`` of every smooth
union is subtracted (the most a smooth union dips below its operands).
The JAX module's docstring holds the safety argument: the bound never
exceeds the map a ray marches on, whatever the guards and the CSG ops, so a
ray may advance by it without an exact map tap (kernels/megakernel.py,
``dist_grid``; render/program.py:cast_grid).

Layout: the grid is flat, ``f32[gz*gy*gx]`` with flat index ``(iz*gy +
iy)*gx + ix``, beside ``meta f32[9]`` (lo, inv_cell, hi).  JAX packs it into
128-lane chunks for Mosaic's lane gather; the port matches its values, not
its chunks.  The bake is a few hundred batched torch ops whatever the leaf
count: each leaf kind's supports and its corner lattice are evaluated over
all leaves of that kind at once.  It runs under ``torch.no_grad()``: the
grid is a bound, and gradients flow through the exact taps it gates.

``make_grid_tap`` gives the per-point bound in plain torch, with the float
order of JAX ``make_grid_tap`` (floor, clip as float, int cast; the plane
rows as ``bv[o]*x + bv[o+1]*y + bv[o+2]*z + bv[o+3]``; one ``g - 0.25*k``
per smooth node in walk order), which the kernel's ``grid_tap``
(kernels/csrc/csg_program.cuh) repeats, so the two agree bit for bit.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..constants import MHD, STEPS
from ..scene.compile import SceneSpec
from ..scene.model import KIND_CUBE, KIND_PLANE, KIND_SPHERE
from ..vecmath import Vec3, div_exact, sqrt_rn
from .baked import GEOM_SLOTS, baked_layout, baked_shapes_in_order, leaf_distance

DEFAULT_RES = (16, 16, 16)
META_SLOTS = 9  # lo.xyz, inv_cell.xyz, hi.xyz
_BBOX_MARGIN = 1e-3
# The march (JAX kernels/megakernel.py:839-840): a point whose bound is
# below GRID_TAU takes an exact map tap; cheap advances are capped
# globally at GRID_EXTRA_ITERS iterations beyond the STEPS exact taps.
GRID_TAU = 4.0 * MHD
GRID_EXTRA_ITERS = 256
GRID_MAX_ITERS = STEPS + GRID_EXTRA_ITERS


@lru_cache(maxsize=None)
def _grid_static(spec: SceneSpec):
    """Static split of the leaf list: (bounded leaves, plane leaves,
    smooth-union k slot offsets in walk order)."""
    shapes = baked_shapes_in_order(spec)
    bounded = tuple(bs for bs in shapes if bs.kind != KIND_PLANE)
    planes = tuple(bs for bs in shapes if bs.kind == KIND_PLANE)
    k_offs = []

    def walk(bu):
        if bu.k_off >= 0:
            k_offs.append(bu.k_off)
        for cu in bu.children_unions:
            walk(cu)

    for root in baked_layout(spec).roots:
        walk(root)
    return bounded, planes, tuple(k_offs)


def grid_eligible(spec: SceneSpec) -> bool:
    """A scene can carry a distance grid iff it has at least one bounded
    leaf (otherwise there is no box to grid)."""
    return len(_grid_static(spec)[0]) > 0


class DistGrid(NamedTuple):
    """One frame's grid: ``meta`` f32[9], ``cells`` f32[gz*gy*gx], the
    resolution ``res`` (gx, gy, gz) and the exact-tap threshold ``tau``."""

    meta: torch.Tensor
    cells: torch.Tensor
    res: tuple
    tau: float


@lru_cache(maxsize=32)
def _kind_rows(spec: SceneSpec, device: torch.device):
    """Per leaf kind, the (n, slots) bv offsets of its leaves, on
    ``device``."""
    out = []
    shapes = baked_shapes_in_order(spec)
    for kind in sorted({bs.kind for bs in shapes}):
        offs = np.asarray([bs.off for bs in shapes if bs.kind == kind])
        rows = offs[:, None] + np.arange(GEOM_SLOTS[kind])
        out.append((kind, torch.as_tensor(rows, dtype=torch.int64,
                                          device=device)))
    return tuple(out)


@lru_cache(maxsize=32)
def _res_on(res, device: torch.device) -> torch.Tensor:
    """The resolution as a float32 tensor on ``device``, made once: a
    per-frame host-to-device copy would wait for the card."""
    return torch.tensor(res, dtype=torch.float32, device=device)


def _leaf_support(kind: int, g):
    """World-space (lo, hi), each (n, 3), of the bounded leaves of one kind
    from their baked rows ``g`` (n, slots).  A cube's or an octahedron's
    frame rows are orthonormal (uniform scales), so its support is the
    centre ``-Mw^T bw`` plus the absolute row sums of ``Mw^T`` times the
    half-sizes (the octahedron's L1 ball lies in the L2 ball of radius s)."""
    if kind == KIND_SPHERE:
        c, r = g[:, 0:3], g[:, 3:4]
        return c - r, c + r
    M = [g[:, i] for i in range(9)]
    bw = [g[:, 9], g[:, 10], g[:, 11]]
    c = torch.stack([-(M[0] * bw[0] + M[3] * bw[1] + M[6] * bw[2]),
                     -(M[1] * bw[0] + M[4] * bw[1] + M[7] * bw[2]),
                     -(M[2] * bw[0] + M[5] * bw[1] + M[8] * bw[2])], 1)
    if kind == KIND_CUBE:
        b = [g[:, 12], g[:, 13], g[:, 14]]
        a = [torch.abs(m) for m in M]
        h = torch.stack([a[0] * b[0] + a[3] * b[1] + a[6] * b[2],
                         a[1] * b[0] + a[4] * b[1] + a[7] * b[2],
                         a[2] * b[0] + a[5] * b[1] + a[8] * b[2]], 1)
    else:
        h = g[:, 12:13].expand(-1, 3)
    return c - h, c + h


def bake_dist_grid(spec: SceneSpec, bv: torch.Tensor, res=DEFAULT_RES):
    """``(meta f32[9], cells f32[gz*gy*gx])`` from the baked geometry
    vector ``bv`` (render/baked.py:bake), on ``bv``'s device, without a
    gradient."""
    if not grid_eligible(spec):
        raise ValueError("dist_grid requires at least one bounded leaf")
    gx, gy, gz = (int(r) for r in res)
    with torch.no_grad():
        bv = bv.detach()
        kinds = [(kind, bv[rows]) for kind, rows in _kind_rows(spec, bv.device)]
        sup = [_leaf_support(kind, g) for kind, g in kinds if kind != KIND_PLANE]
        lo = torch.cat([s[0] for s in sup]).amin(0) - _BBOX_MARGIN
        hi = torch.cat([s[1] for s in sup]).amax(0) + _BBOX_MARGIN
        cell = div_exact(hi - lo, _res_on((gx, gy, gz), bv.device))
        half_diag = 0.5 * sqrt_rn(cell[0] * cell[0] + cell[1] * cell[1]
                                  + cell[2] * cell[2])
        # The corner lattice (gz+1, gy+1, gx+1), flattened, through every
        # leaf of each kind at once (planes included: inside the box their
        # distance is part of the bound).
        axes = [lo[a] + cell[a] * torch.arange(k + 1, dtype=torch.float32,
                                               device=bv.device)
                for a, k in enumerate((gx, gy, gz))]
        pz, py, px = torch.meshgrid(axes[2], axes[1], axes[0], indexing="ij")
        p = Vec3(px.reshape(1, -1), py.reshape(1, -1), pz.reshape(1, -1))
        field = torch.stack([
            leaf_distance(kind, p, [g[:, c:c + 1] for c in range(g.shape[1])])
            .amin(0) for kind, g in kinds]).amin(0)
        # Per cell: the min of its 8 corners, minus the half diagonal.
        m = field.view(gz + 1, gy + 1, gx + 1)
        m = torch.minimum(m[:-1], m[1:])
        m = torch.minimum(m[:, :-1], m[:, 1:])
        m = torch.minimum(m[:, :, :-1], m[:, :, 1:])
        cells = torch.clamp(m - half_diag, min=0.0).reshape(-1)
        meta = torch.cat([lo, 1.0 / cell, hi])
    return meta, cells.contiguous()


def make_dist_grid(spec: SceneSpec, bv: torch.Tensor, res=DEFAULT_RES,
                   tau: float = GRID_TAU) -> DistGrid:
    """The frame's :class:`DistGrid`."""
    res = tuple(int(r) for r in res)
    if len(res) != 3 or min(res) < 1:
        raise ValueError(f"grid_res must be three positive ints, not {res}")
    meta, cells = bake_dist_grid(spec, bv, res)
    return DistGrid(meta, cells, res, float(tau))


@lru_cache(maxsize=32)
def grid_code_on(spec: SceneSpec, device: torch.device):
    """What the kernel's grid tap reads besides the grid: int32 ``[plane
    row offsets in bv..., smooth k offsets in bv...]``, and the two counts."""
    _b, planes, k_offs = _grid_static(spec)
    code = [bs.off for bs in planes] + list(k_offs)
    return (torch.as_tensor(code, dtype=torch.int32, device=device),
            len(planes), len(k_offs))


def make_grid_tap(spec: SceneSpec, grid: DistGrid, bv):
    """``tap(p, count=None, live=None) -> g``, the per-point bound of
    ``grid`` for (n,) points; ``bv`` is the baked vector as Python floats
    (or a tensor).  ``count``, a dict, adds ``"grid_taps"``, the taps of the
    points in ``live`` (a bool mask; all when None), and ``"grid_outside"``,
    those of them outside the box, which take the fallback."""
    gx, gy, gz = grid.res
    _b, planes, k_offs = _grid_static(spec)
    meta = [float(v) for v in grid.meta.tolist()]
    lox, loy, loz, ivx, ivy, ivz, hix, hiy, hiz = meta
    rows = [[float(bv[bs.off + c]) for c in range(4)] for bs in planes]
    ks = [0.25 * float(bv[o]) for o in k_offs]
    cells = grid.cells

    def cell(c, lo, inv, n):
        return torch.clamp(torch.floor((c - lo) * inv), 0.0, n - 1).to(
            torch.int64)

    def tap(p: Vec3, count=None, live=None):
        g = cells[(cell(p.z, loz, ivz, gz) * gy + cell(p.y, loy, ivy, gy)) * gx
                  + cell(p.x, lox, ivx, gx)]
        inside = ((p.x >= lox) & (p.x <= hix) & (p.y >= loy) & (p.y <= hiy)
                  & (p.z >= loz) & (p.z <= hiz))
        # Outside: the distance to the grid box (which holds every bounded
        # leaf), min'ed with the exact plane distances.
        zero = torch.zeros_like(p.x)
        qx = torch.maximum(torch.maximum(lox - p.x, p.x - hix), zero)
        qy = torch.maximum(torch.maximum(loy - p.y, p.y - hiy), zero)
        qz = torch.maximum(torch.maximum(loz - p.z, p.z - hiz), zero)
        db = sqrt_rn(qx * qx + qy * qy + qz * qz)
        for r in rows:
            db = torch.minimum(db, r[0] * p.x + r[1] * p.y + r[2] * p.z + r[3])
        g = torch.where(inside, g, db)
        if count is not None:
            live = torch.ones_like(inside) if live is None else live
            count["grid_taps"] = count.get("grid_taps", 0) + live.sum()
            count["grid_outside"] = (count.get("grid_outside", 0)
                                     + (live & ~inside).sum())
        for k in ks:  # the smooth-union dip, k/4 per smooth node
            g = g - k
        return g

    return tap


def cheap_bound(spec: SceneSpec, bv: torch.Tensor, p: Vec3,
                res=DEFAULT_RES) -> torch.Tensor:
    """The grid bound at the points ``p`` (JAX ``cheap_bound_xla``): bakes
    the grid from ``bv`` and taps it."""
    grid = make_dist_grid(spec, bv, res)
    return make_grid_tap(spec, grid, bv.tolist())(p)
