"""The sphere march of arbitrary rays through the CUDA kernel K3, its plain
torch version, and the implicit-gradient cast the differentiable renderer
plugs into ``path_trace`` (JAX package: ``kernels/march.py``).

* ``march_rays(prog, table, ro, rd, *, t_cull, with_normal)`` marches flat
  (n,) rays through ``csrc/march_rays.cu`` (K3) on a CUDA tensor, and runs
  ``march_rays_plain`` on a CPU tensor: the CSG program of
  render/program.py interpreted in torch, its guards, the exact or the
  per-thread t-culled march and the 6-tap normal, which is also the
  reference the kernel is held to.
* ``ImplicitCast`` is the ``torch.autograd.Function`` around a march (JAX
  ``_make_cast_custom_vjp``, ``make_implicit_cast``): its forward is any
  march, its backward the O(1)-memory implicit gradient at the hit point,
  one vjp of the differentiable scene map in torch.  The JAX backward is an
  XLA map vjp outside the Pallas kernel, so it has no kernel of its own
  here either.
* ``make_kernel_cast`` (JAX ``make_pallas_cast`` and, with
  ``with_normal``, ``make_pallas_cast_with_normal``) adapts it to
  ``path_trace``'s cast slot with K3 as the forward.
"""

from __future__ import annotations

import torch

from ..constants import FP
from ..render.baked import make_bounds_baked, make_map_baked
from ..render.program import (
    Program,
    build_program,
    cast_tcull,
    make_map_program,
    program_bounds,
    program_code_on,
    program_table,
)
from ..render.reference import calc_normal, cast_ray, take_lanes
from ..render.scenegen import make_bounds, make_map
from ..scene.compile import SceneSpec
from ..vecmath import Vec3
from .build import load_library

# Launches since import (or since a caller reset them).
LAUNCHES = {"march_rays": 0}

# Denominator clamp of the implicit gradient: |f_p . rd| at or below it is a
# grazing hit whose derivative blows up, and gets none (JAX ``_DENOM_EPS``).
DENOM_EPS = 1e-6
# Rays per map vjp in the backward: bounds the transient graph of the map at
# 1080p (about 8 KB of saved tensors per ray on the 64-primitive scene).
BACKWARD_CHUNK = 1 << 20


@torch.no_grad()
def march_rays_plain(prog: Program, table: torch.Tensor, ro: Vec3, rd: Vec3,
                     *, t_cull: bool, with_normal: bool, count=None):
    """K3's march in vectorized torch: the program's guards
    (``program_bounds``), ``cast_tcull`` or ``cast_ray`` over the
    interpreted map, and with ``with_normal`` the 6-tap normal under the
    full guards on the hits (zero where the ray misses).  Returns ``(t,
    idx)`` or ``(t, idx, n)``.  ``count`` accumulates the kernel's work
    (``make_map_program``)."""
    map_fn = make_map_program(prog, table.tolist(), count)

    def map_checked(p, checks):
        return map_fn(p, checks[0])

    checks, _ = program_bounds(prog, table, ro, rd, t_cull)
    if t_cull:
        t, idx = cast_tcull(prog, map_fn, ro, rd, checks)
    else:
        t, idx = cast_ray(map_checked, ro, rd, checks)
    if not with_normal:
        return t, idx
    hit = ~(t > FP)
    p = ro + rd * t
    nh = calc_normal(map_checked, Vec3(*(c[hit] for c in p)),
                     take_lanes(checks[:1], hit))
    n = Vec3(*(torch.zeros_like(t).index_put((hit,), c) for c in nh))
    return t, idx, n


def _check_rays(prog: Program, table: torch.Tensor, ro: Vec3, rd: Vec3) -> int:
    n = ro.x.shape[0]
    device = table.device
    if table.dtype != torch.float32 or table.shape != (prog.f_len,) \
            or not table.is_contiguous():
        raise ValueError(f"table must be contiguous float32 ({prog.f_len},)")
    for c in (*ro, *rd):
        if (c.device != device or c.dtype != torch.float32 or c.shape != (n,)
                or not c.is_contiguous()):
            raise ValueError(f"rays must be six contiguous float32 ({n},) "
                             f"tensors on {device}")
    return n


def march_rays(prog: Program, table: torch.Tensor, ro: Vec3, rd: Vec3, *,
               t_cull: bool, with_normal: bool):
    """March flat (n,) rays through the scene of ``prog`` with its table
    (``program_table``); returns ``(t, idx)`` or, with ``with_normal``,
    ``(t, idx, n)``: t float32 (t > FP is a miss), idx the int32 id of the
    winning shape (-1 when far), n the 6-tap central-difference normal
    (zero on a miss).

    On CUDA tensors this launches K3 on the current stream without
    synchronising and counts the launch in ``LAUNCHES["march_rays"]``; on
    CPU tensors it runs :func:`march_rays_plain`."""
    if table.device.type == "cpu":
        return march_rays_plain(prog, table, ro, rd, t_cull=t_cull,
                                with_normal=with_normal)
    if table.device.type != "cuda":
        raise ValueError(f"no kernel for device {table.device}")
    n = _check_rays(prog, table, ro, rd)
    t = torch.empty_like(ro.x)
    idx = torch.empty(n, dtype=torch.int32, device=table.device)
    nrm = Vec3(*(torch.empty_like(ro.x) for _ in range(3))) if with_normal \
        else None
    if n:
        code = program_code_on(prog, table.device)
        lib = load_library()
        outs = [0, 0, 0] if nrm is None else [c.data_ptr() for c in nrm]
        with torch.cuda.device(table.device):
            err = lib.cpt_march_rays(
                code.data_ptr(), prog.ops.shape[0], table.data_ptr(),
                prog.n_boxed, prog.f_box, int(prog.geometry == "baked"),
                int(bool(t_cull)), int(bool(with_normal)), n,
                *(c.data_ptr() for c in (*ro, *rd)), t.data_ptr(),
                idx.data_ptr(), *outs,
                torch.cuda.current_stream(table.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"march_rays launch failed: CUDA error {err}")
        LAUNCHES["march_rays"] += 1
    return (t, idx) if nrm is None else (t, idx, nrm)


def implicit_grad(map_fn, gv, ro: Vec3, rd: Vec3, t, t_cot, checks):
    """The implicit-function gradient of the hit distance t* (the root of
    f(ro + t rd, gv) = 0) pulled back from ``t_cot``: with f_p the map's
    spatial gradient at the hit, ``scale = -t_cot / (f_p . rd)`` (zero where
    ``|f_p . rd| <= DENOM_EPS``), returns ``(gv_cot, ro_cot, rd_cot)`` =
    ``(f_gv * scale summed over rays, f_p * scale, f_p * scale * t)``.
    ``map_fn(p, gv, checks) -> (d, idx)`` is differentiable in ``p`` and
    ``gv``; only rays with a non-zero ``t_cot`` are evaluated, in chunks of
    ``BACKWARD_CHUNK``."""
    gv_cot = torch.zeros_like(gv)
    ro_cot = Vec3(*(torch.zeros_like(t) for _ in range(3)))
    rd_cot = Vec3(*(torch.zeros_like(t) for _ in range(3)))
    live = torch.nonzero(t_cot != 0).flatten()
    for lo in range(0, live.numel(), BACKWARD_CHUNK):
        sel = live[lo:lo + BACKWARD_CHUNK]
        o, d_, tt, tc = (Vec3(*(c[sel] for c in ro)),
                         Vec3(*(c[sel] for c in rd)), t[sel], t_cot[sel])
        with torch.enable_grad():
            p = [c.detach().requires_grad_() for c in o + d_ * tt]
            g = gv.detach().requires_grad_()
            dist, _ = map_fn(Vec3(*p), g, take_lanes(checks, sel))
            g_p = Vec3(*torch.autograd.grad(dist, p, torch.ones_like(dist),
                                            retain_graph=True))
            denom = g_p.dot(d_)
            safe = torch.abs(denom) > DENOM_EPS
            inv = torch.where(safe, 1.0 / torch.where(safe, denom,
                                                      torch.ones_like(denom)),
                              torch.zeros_like(denom))
            scale = -tc * inv
            gv_cot = gv_cot + torch.autograd.grad(dist, g, scale)[0]
        for acc, v in zip(ro_cot, g_p * scale):
            acc.index_copy_(0, sel, v)
        for acc, v in zip(rd_cot, g_p * (scale * tt)):
            acc.index_copy_(0, sel, v)
    return gv_cot, ro_cot, rd_cot


class ImplicitCast(torch.autograd.Function):
    """``(t, idx[, n]) = march(ro, rd)`` with the implicit gradient
    (:func:`implicit_grad`) for ``t`` and none for ``idx`` or the normal.

    ``apply(march, map_fn, checks_fn, gv, ro.x, ro.y, ro.z, rd.x, rd.y,
    rd.z)``: ``march(ro, rd)`` is the forward, run without autograd;
    ``map_fn(p, gv, checks)`` the differentiable scene map; ``checks_fn(ro,
    rd)`` gives the guards the backward evaluates the map under (recomputed
    there, under no_grad, or returned from the forward's closure)."""

    @staticmethod
    def forward(ctx, march, map_fn, checks_fn, gv, rox, roy, roz, rdx, rdy,
                rdz):
        out = march(Vec3(rox, roy, roz), Vec3(rdx, rdy, rdz))
        t, idx = out[0], out[1]
        ctx.save_for_backward(gv, rox, roy, roz, rdx, rdy, rdz, t)
        ctx.map_fn, ctx.checks_fn = map_fn, checks_fn
        rest = [idx] + (list(out[2]) if len(out) > 2 else [])
        ctx.mark_non_differentiable(*rest)
        return (t, *rest)

    @staticmethod
    def backward(ctx, t_cot, *_):
        gv, rox, roy, roz, rdx, rdy, rdz, t = ctx.saved_tensors
        ro, rd = Vec3(rox, roy, roz), Vec3(rdx, rdy, rdz)
        with torch.no_grad():
            checks = ctx.checks_fn(ro, rd)
        gv_cot, ro_cot, rd_cot = implicit_grad(ctx.map_fn, gv, ro, rd, t,
                                               t_cot, checks)
        return (None, None, None, gv_cot, *ro_cot, *rd_cot)


def cast_outputs(out):
    """``ImplicitCast``'s flat outputs as ``(t, idx)`` or ``(t, idx, n)``."""
    return tuple(out) if len(out) == 2 else (out[0], out[1], Vec3(*out[2:]))


def make_kernel_cast(spec: SceneSpec, params: torch.Tensor, gv: torch.Tensor,
                     *, geometry: str = "baked", with_normal: bool = False):
    """``cast_fn(ro, rd, checks) -> (t, idx)`` for ``path_trace`` (JAX
    ``make_pallas_cast``): the t-culled K3 forward on the program table of
    the detached ``params`` (the kernel computes its own guards, so
    ``checks`` is not read), the implicit gradient backward through the
    differentiable map over ``gv`` (the baked vector for
    ``geometry="baked"``, else ``params``) under the reference's guards.
    With ``with_normal`` (JAX ``make_pallas_cast_with_normal``) the cast
    returns ``(t, idx, n)``: the kernel's 6-tap normal, detached, which
    ``path_trace`` shades with instead of calling its ``normal_fn``."""
    prog = build_program(spec, geometry)
    with torch.no_grad():
        table = program_table(prog, params.detach(), True)
    if geometry == "baked":
        map_fn, bounds = make_map_baked(spec), make_bounds_baked(spec)
    else:
        map_fn, bounds = make_map(spec), make_bounds(spec)
    gv_fixed = gv.detach()

    def march(ro, rd):
        return march_rays(prog, table, ro, rd, t_cull=True,
                          with_normal=with_normal)

    def checks_fn(ro, rd):
        return bounds(ro, rd, gv_fixed)[0]

    def cast_fn(ro, rd, _checks):
        return cast_outputs(ImplicitCast.apply(march, map_fn, checks_fn, gv,
                                               *ro, *rd))

    return cast_fn
