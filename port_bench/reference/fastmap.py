"""The baked map of a flat union, evaluated for all leaves of a kind at
once: the frozen map (``tracer/render/baked.py:make_map_baked``) makes
some twenty torch calls a leaf, so at 61 leaves a map tap is a thousand
launches and the reference is bound by them.

The same values, bit for bit: each leaf's distance is the frozen
``leaf_distance``, elementwise on (n, leaves) planes; the fold of plain
unions keeps the nearest hit and, on a tie, the later shape
(``op_union``), and a shape whose guard fails leaves the fold as it was.
So the result is the minimum over the union's seed (when its first shape,
which assigns, is guarded out) and the guarded-in leaves, with the last of
equal minima winning, then the scene's union with ``MAX_DIST``.  Only a
scene that is one root union of shapes takes this path
(:func:`make_flat_map` returns None otherwise)."""

from __future__ import annotations

import torch

from .tracer.constants import MAX_DIST
from .tracer.render.baked import GEOM_SLOTS, baked_layout, leaf_distance
from .tracer.scene.compile import OP_UNION
from .tracer.vecmath import Vec3


def make_flat_map(spec, column):
    """``map(p, bv, active) -> (d, idx)`` over ``bv`` ((slots,) or per
    point (slots, n)) with ``active`` the (n, n_boxed) guard, whose column
    of shape ``s`` is ``column[s]``; None unless the tree is one root
    union of shapes."""
    layout = baked_layout(spec)
    if (len(layout.roots) != 1 or layout.roots[0].children_unions
            or layout.roots[0].op != OP_UNION):
        return None
    root = layout.roots[0]
    shapes = root.children_shapes
    kinds = {}
    for pos, bs in enumerate(shapes):
        kinds.setdefault(bs.kind, []).append(pos)
    first = shapes[0]
    ids = [bs.shape_id for bs in shapes]
    boxed = [pos for pos, bs in enumerate(shapes) if bs.aabb]
    box_cols = [column[shapes[pos].shape_id] for pos in boxed]

    def on(device):
        t = lambda v: torch.tensor(v, dtype=torch.int64, device=device)
        offs = {k: t([[shapes[pos].off + s for s in range(GEOM_SLOTS[k])]
                      for pos in poss]) for k, poss in kinds.items()}
        return ({k: t(v) for k, v in kinds.items()}, offs, t(boxed),
                t(box_cols), torch.tensor([-1] + ids, dtype=torch.int32,
                                          device=device))

    cache = {}

    def map_fn(p: Vec3, bv: torch.Tensor, active: torch.Tensor):
        dev = p.x.device
        if dev not in cache:
            cache[dev] = on(dev)
        cols, offs, boxed_t, box_cols_t, id_of = cache[dev]
        n = p.x.shape[0]
        pts = Vec3(p.x[:, None], p.y[:, None], p.z[:, None])
        dist = p.x.new_empty((n, len(shapes)))
        for kind, where in cols.items():
            g = bv[offs[kind]]  # (leaves, slots) or (leaves, slots, n)
            slots = [g[:, s] if g.dim() == 2 else g[:, s].t()
                     for s in range(g.shape[1])]
            dist[:, where] = leaf_distance(kind, pts, slots)
        valid = torch.ones_like(dist, dtype=torch.bool)
        if boxed:
            valid[:, boxed_t] = active[:, box_cols_t]
        inf = torch.full_like(dist, float("inf"))
        seed = (bv[root.init_off] if bv.dim() == 1 else bv[root.init_off])
        seed = (p.x * 0.0 + seed)[:, None]
        cand = torch.cat([torch.where(valid[:, :1], inf[:, :1], seed),
                          torch.where(valid, dist, inf)], 1)
        d = cand.amin(1)
        pos = torch.arange(cand.shape[1], device=dev)
        last = torch.where(cand == d[:, None], pos, -1).amax(1)
        idx = id_of[last]
        far = torch.full_like(d, MAX_DIST) < d
        return (torch.where(far, torch.full_like(d, MAX_DIST), d),
                torch.where(far, torch.full_like(idx, -1), idx))

    return map_fn
