"""The per-ray t-culled march over baked geometry: the semantics of the JAX
package's ``_march_while_tcull`` with its tile reduced to one ray, as the
program's ``render --mode tcull`` runs it, written again over the frozen
renderer (``tracer/``).

Per bounce each boxed leaf gets the ray's interval through a sphere that
bounds it; during the march a cullable leaf is in the map only while that
interval holds the ray's t, and the nearest such interval still ahead
clamps the step to ``max(t_lo - t, MHD)``.  A leaf is cullable when it is
boxed, not a plane, and reaches the scene through plain unions alone
(dropping a subtraction's or smooth union's operand, or a first shape
that clobbers its child unions, would change the fold).  The 6-tap normal
takes the bounce's full guards."""

from __future__ import annotations

import torch

from .tracer.constants import BIG, FP, MHD, STEPS
from .tracer.ops.aabb import aabb_hit, intersect_aabb
from .tracer.precision import quantize
from .tracer.render.baked import GEOM_SLOTS, baked_layout
from .tracer.render.reference import take_lanes
from .tracer.scene.compile import OP_UNION
from .tracer.scene.model import KIND_CUBE, KIND_PLANE, KIND_SPHERE
from .tracer.vecmath import Vec3, sqrt_rn

# A bounding sphere is inflated to cover float rounding and the MHD shell
# in which a hit fires just outside a surface.
SPHERE_SLACK = (1e-5, 2.0 * MHD)


def boxed_leaves(spec):
    """``(shape_id, kind, baked offset, aabb offset, cullable)`` of every
    boxed leaf, in the map's walk order (child unions first, then
    shapes)."""
    out = []

    def walk(us, bu, min_path):
        min_path = min_path and us.op == OP_UNION
        for cu, bcu in zip(us.children_unions, bu.children_unions):
            walk(cu, bcu, min_path)
        for si, bs in enumerate(bu.children_shapes):
            if bs.aabb:
                cull = (min_path and bs.kind != KIND_PLANE
                        and not (si == 0 and us.children_unions))
                out.append((bs.shape_id, bs.kind, bs.off, bs.aabb_off, cull))

    for root, broot in zip(spec.roots, baked_layout(spec).roots):
        walk(root, broot, True)
    return out


def bounding_spheres(leaves, bv: torch.Tensor) -> torch.Tensor:
    """(n_boxed, 4) world-space centre and radius of each cullable leaf,
    from its baked slots (zero rows elsewhere).  A cube's or an
    octahedron's frame rows are orthonormal times one scale, so its centre
    is -M^T b."""
    out = bv.new_zeros((len(leaves), 4))
    for kind in sorted({leaf[1] for leaf in leaves}):
        rows = [j for j, leaf in enumerate(leaves)
                if leaf[1] == kind and leaf[4]]
        if not rows:
            continue
        offs = torch.tensor([[leaves[j][2] + s for s in range(GEOM_SLOTS[kind])]
                             for j in rows], dtype=torch.int64, device=bv.device)
        g = bv[offs]
        if kind == KIND_SPHERE:
            c, r = g[:, :3], g[:, 3]
        else:
            m = g[:, :9].reshape(-1, 3, 3)
            c = -(m.transpose(1, 2) @ g[:, 9:12, None])[..., 0]
            r = (torch.linalg.vector_norm(g[:, 12:15], dim=1)
                 if kind == KIND_CUBE else g[:, 12])
        out[torch.tensor(rows, device=bv.device)] = torch.cat(
            [c, (r * (1.0 + SPHERE_SLACK[0]) + SPHERE_SLACK[1])[:, None]], 1)
    return out


def boxes(leaves, bv: torch.Tensor) -> torch.Tensor:
    """(n_boxed, 6) min and max corner of each boxed leaf's AABB."""
    idx = torch.tensor([[leaf[3] + k for k in range(6)] for leaf in leaves],
                       dtype=torch.int64, device=bv.device)
    return bv[idx]


def bounds(ro: Vec3, rd: Vec3, box: torch.Tensor, sph: torch.Tensor):
    """``(check, t_lo, t_hi)``, each (n, n_boxed): the AABB guard and the
    ray's interval through each leaf's bounding sphere (entry clamped to 0;
    empty as [BIG, -BIG] on a miss).  ``box`` and ``sph`` are (n_boxed, .)
    or per ray (n, n_boxed, .)."""
    ro, rd = (Vec3(*(c[:, None] for c in v)) for v in (ro, rd))
    tn, tf = intersect_aabb(ro, rd, Vec3(*(box[..., k] for k in range(3))),
                            Vec3(*(box[..., k] for k in range(3, 6))))
    hit = aabb_hit(tn, tf)
    oc = ro - Vec3(sph[..., 0], sph[..., 1], sph[..., 2])
    b = oc.dot(rd)
    disc = b * b - (oc.dot(oc) - sph[..., 3] * sph[..., 3])
    ok = disc >= 0.0
    root = sqrt_rn(torch.where(ok, disc, torch.zeros_like(disc)))
    lo = torch.where(ok, torch.clamp(-b - root, min=0.0), torch.full_like(b, BIG))
    hi = torch.where(ok, -b + root, torch.full_like(b, -BIG))
    return hit, lo, hi


def cast(map_fn, ro: Vec3, rd: Vec3, checks, cull: torch.Tensor):
    """The t-culled march of (n,) rays.  ``checks`` is ``(check, t_lo,
    t_hi, *rest)`` from :func:`bounds` plus per-ray extras, compacted with
    the rays; ``map_fn(p, active, rest)`` maps the points with the
    (n, n_boxed) guard ``active``.  Returns ``(t, idx)``, ``idx`` the last
    tap's id (-1 when far)."""
    t = torch.zeros_like(ro.x)
    idx = torch.full_like(ro.x, -1, dtype=torch.int32)
    live = torch.arange(t.shape[0], device=t.device)
    lt = torch.zeros_like(t)
    for _ in range(STEPS):
        if live.numel() == 0:
            break
        chk, lo, hi, *rest = checks
        tt = lt[:, None]
        active = chk & (~cull | ((lo <= tt) & (hi >= tt)))
        if chk.shape[1]:
            m = torch.where(chk & cull & (lo > tt), lo,
                            torch.full_like(lo, BIG)).amin(1)
        else:
            m = torch.full_like(lt, BIG)
        d, mi = map_fn(ro + rd * lt, active, rest)
        d = quantize(d)
        ad = torch.abs(d)
        clamp = torch.clamp(m - lt, min=MHD)
        nt = quantize(lt + torch.minimum(ad, clamp))
        hit = ad < MHD
        far = nt > FP
        t[live] = nt
        idx[live] = torch.where(far, torch.full_like(mi, -1), mi)
        keep = ~(hit | far)
        live, lt = live[keep], nt[keep]
        ro, rd = (Vec3(v.x[keep], v.y[keep], v.z[keep]) for v in (ro, rd))
        checks = take_lanes(checks, keep)
    return t, idx
