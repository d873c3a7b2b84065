"""One progressive frame through the CUDA megakernels, and their plain torch
versions.

``render_frame_megakernel`` keeps the signature and the defaults of the JAX
package's ``render_frame_pallas`` and dispatches on its mode:

* ``analytic_all=True`` (with ``geometry="baked"``, union-only trees, debug
  0 or 3): bake the params (render/baked.py), pack the shape tables
  (render/soa.py), and one launch of ``csrc/megakernel_analytic.cu`` (K1)
  renders the frame with closed-form hits;
* otherwise the marching modes: fill the CSG program's table
  (render/program.py) for ``geometry`` "faithful" or "baked", and one
  launch of ``csrc/megakernel_march.cu`` (K2) sphere-marches the frame,
  with per-thread t-interval culling when ``t_cull``, in debug 0-3.

Either kernel updates the (H, W, 3) float32 accumulator in place.  On a CPU
tensor the same call runs ``render_frame_megakernel_plain``: the frame in
vectorized torch, which is also the reference the kernels are held to.  The
per-frame table work runs on the params' device with cached index tensors,
so a frame issues no host round trip.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..constants import DEFAULT_BOUNCES, DEFAULT_FOV, MAT_SIZE
from ..render.baked import bake
from ..render.program import (
    Program,
    build_program,
    cast_tcull,
    make_map_program,
    program_bounds,
    program_code_on,
    program_table,
)
from ..render.reference import (
    calc_normal,
    cast_ray,
    gather_material,
    running_mean,
    trace_pixels,
)
from ..render.soa import (
    SoaSmemLayout,
    build_soa_smem_layout,
    make_cast_soa,
    make_normal_soa,
    material_table,
    pack_soa_smem,
)
from ..scene.compile import SceneSpec
from .build import load_library

# Launches per kernel since import (or since a caller reset them): the counts
# a run reads to show that its path went through the kernels.
LAUNCHES = {"megakernel_analytic": 0, "megakernel_march": 0}


def _kernel_for(geometry: str, debug: int, normals: str, t_cull: bool,
                omega: float, analytic_unboxed: bool, refresh_every: int,
                dist_grid: bool, analytic_all: bool,
                analytic_soa: bool) -> str:
    """"analytic" (K1) or "march" (K2) for a mode of render_frame_pallas;
    raises NotImplementedError for the modes not ported yet."""
    not_yet = (
        (debug == 4, "debug=4 (tile statistics)", "queue 1, item 6"),
        (analytic_unboxed, "analytic_unboxed", "queue 1, item 6 (K2b)"),
        (float(omega) != 1.0, "omega != 1", "queue 1, item 6 (K2b)"),
        (dist_grid, "dist_grid", "queue 1, item 11 (K6)"),
        (analytic_soa, "analytic_soa", "queue 1, item 10 (K5)"),
        (normals != "central", f"normals={normals!r}", "queue 1, item 14"),
        (int(refresh_every) != 1, "refresh_every != 1", "queue 1, item 14"),
    )
    for hit, what, item in not_yet:
        if hit:
            raise NotImplementedError(f"{what} is not ported (ROADMAP {item})")
    if debug not in (0, 1, 2, 3):
        raise ValueError(f"debug must be in 0..=3, not {debug}")
    if geometry not in ("faithful", "baked"):
        raise ValueError("geometry must be 'faithful' or 'baked'")
    if analytic_all:
        if geometry != "baked":
            raise ValueError("analytic_all requires geometry='baked'")
        if debug not in (0, 3):
            raise ValueError("analytic_all renders the path-traced modes "
                             "(debug 0/3)")
        return "analytic"
    return "march"


def _layout_for(spec: SceneSpec) -> SoaSmemLayout:
    layout = build_soa_smem_layout(spec)
    if layout is None:
        raise ValueError("analytic_all requires a union-only tree")
    return layout


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


def _pixels(height: int, width: int, device):
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.int32, device=device),
        torch.arange(width, dtype=torch.int32, device=device),
        indexing="ij")
    return xs, ys


def _analytic_plain(spec, params, xs, ys, frame, bounces, fov, aspect, **kw):
    """K1's frame: closed-form hits over the packed tables."""
    layout = _layout_for(spec)
    soa_f, soa_i = pack_soa_smem(layout, bake(spec, params), params)
    cast, normal = make_cast_soa(layout), make_normal_soa(layout)
    mats = material_table(layout, soa_f)
    return trace_pixels(
        lambda ro, rd: ((), None),
        lambda ro, rd, _c: cast(ro, rd, soa_f, soa_i),
        lambda p, idx, _c: normal(p, idx, soa_f, soa_i),
        lambda idx: gather_material(mats, idx),
        xs, ys, frame, bounces, fov, aspect, **kw)


def _march_plain(prog: Program, table, t_cull, xs, ys, frame, bounces, fov,
                 aspect, **kw):
    """K2's frame: the CSG program interpreted per tap, the exact or the
    per-thread t-culled march, 6-tap normals under the bounce's guards."""
    map_fn = make_map_program(prog, table.tolist())

    def map_checked(p, checks):
        return map_fn(p, checks[0])

    if t_cull:
        def cast(ro, rd, c):
            return cast_tcull(prog, map_fn, ro, rd, c)
    else:
        def cast(ro, rd, c):
            return cast_ray(map_checked, ro, rd, c)
    mats = table[prog.f_mat:].view(prog.n_shapes, MAT_SIZE)
    return trace_pixels(
        lambda ro, rd: program_bounds(prog, table, ro, rd, t_cull),
        cast,
        lambda p, _idx, c: calc_normal(map_checked, p, c[:1]),
        lambda idx: gather_material(mats, idx),
        xs, ys, frame, bounces, fov, aspect, **kw)


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
    analytic_all: bool = False,
    analytic_soa: bool = False,
) -> torch.Tensor:
    """The kernels' frame in vectorized torch, on ``params``' device."""
    kernel = _kernel_for(geometry, debug, normals, t_cull, omega,
                         analytic_unboxed, refresh_every, dist_grid,
                         analytic_all, analytic_soa)
    if aspect is None:
        aspect = width / height
    device = params.device
    accum = _accum_for(accum, height, width, device)
    xs, ys = _pixels(height, width, device)
    kw = dict(width=width, height=height, debug=debug)
    with torch.no_grad():
        if kernel == "analytic":
            col = _analytic_plain(spec, params, xs, ys, frame, bounces, fov,
                                  aspect, **kw)
        else:
            prog = build_program(spec, geometry)
            col = _march_plain(prog, program_table(prog, params, t_cull),
                               t_cull, xs, ys, frame, bounces, fov, aspect,
                               **kw)
        img = col.stack()
        if debug != 0:
            return accum.copy_(img)
        return accum.copy_(running_mean(accum, img, last_clear))


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
    analytic_all: bool = False,
    analytic_soa: bool = False,
) -> torch.Tensor:
    """One progressive frame through a CUDA megakernel; returns the (H, W,
    3) float32 accumulator, updated in place (a new zero one when ``accum``
    is None; debug modes overwrite it with their image).

    Runs on ``params``' device: a CUDA tensor launches K1
    (``analytic_all=True``) or K2 (the marching modes) on the current
    stream without synchronising, a CPU tensor runs
    :func:`render_frame_megakernel_plain`.  Modes of ``render_frame_pallas``
    that are not ported raise ``NotImplementedError``; ``analytic_all`` on a
    tree with a non-union op raises ``ValueError``.
    """
    mode = dict(geometry=geometry, normals=normals, t_cull=t_cull, omega=omega,
                analytic_unboxed=analytic_unboxed,
                refresh_every=refresh_every, dist_grid=dist_grid,
                analytic_all=analytic_all, analytic_soa=analytic_soa)
    if params.device.type == "cpu":
        return render_frame_megakernel_plain(
            spec, params, accum, frame, last_clear, width=width,
            height=height, debug=debug, bounces=bounces, fov=fov,
            aspect=aspect, **mode)
    if params.device.type != "cuda":
        raise ValueError(f"no kernel for device {params.device}")
    kernel = _kernel_for(geometry, debug, normals, t_cull, omega,
                         analytic_unboxed, refresh_every, dist_grid,
                         analytic_all, analytic_soa)
    if params.dtype != torch.float32 or params.shape != (spec.n_params,):
        raise ValueError(
            f"params must be float32 of shape ({spec.n_params},), got "
            f"{params.dtype} {tuple(params.shape)}")
    if aspect is None:
        aspect = width / height
    accum = _accum_for(accum, height, width, params.device)
    run = dict(frame=frame, last_clear=last_clear, bounces=bounces, fov=fov,
               aspect=aspect, debug=debug)
    with torch.no_grad():
        if kernel == "analytic":
            layout = _layout_for(spec)
            soa_f, soa_i = pack_soa_smem(layout, bake(spec, params), params)
            launch_megakernel(layout, soa_f, soa_i, accum, **run)
        else:
            prog = build_program(spec, geometry)
            launch_march(prog, program_table(prog, params, t_cull), accum,
                         t_cull=t_cull, **run)
    return accum


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
    lookup the kernel reads, as int32 tensors on ``device``."""
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


def launch_megakernel(layout: SoaSmemLayout, soa_f: torch.Tensor,
                      soa_i: torch.Tensor, accum: torch.Tensor, *, frame: int,
                      last_clear: int, bounces: int, fov: float, aspect: float,
                      debug: int) -> None:
    """Launch K1 on packed tables (``pack_soa_smem``) and a CUDA (H, W, 3)
    float32 accumulator, on the current stream; counts the launch in
    ``LAUNCHES["megakernel_analytic"]``."""
    if debug not in (0, 3):
        raise ValueError(f"the kernel renders debug 0 or 3, not {debug}")
    _check_accum(accum)
    device = accum.device
    height, width = accum.shape[0], accum.shape[1]
    _check_table("soa_f", soa_f, torch.float32, layout.f_len, device)
    _check_table("soa_i", soa_i, torch.int32, layout.i_len, device)
    kmeta, sid_lut = _kernel_meta(layout, device)
    lib = load_library()
    with torch.cuda.device(device):
        err = lib.cpt_megakernel_analytic(
            soa_f.data_ptr(), soa_i.data_ptr(), kmeta.data_ptr(),
            len(layout.kinds), sid_lut.data_ptr(), layout.f_mat,
            accum.data_ptr(), width, height, int(frame), int(last_clear),
            int(bounces), float(fov), float(aspect), int(debug),
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"megakernel launch failed: CUDA error {err}")
    LAUNCHES["megakernel_analytic"] += 1


def launch_march(prog: Program, table: torch.Tensor, accum: torch.Tensor, *,
                 frame: int, last_clear: int, bounces: int, fov: float,
                 aspect: float, debug: int, t_cull: bool) -> None:
    """Launch K2 on a program's table (``program_table``) and a CUDA (H, W,
    3) float32 accumulator, on the current stream; counts the launch in
    ``LAUNCHES["megakernel_march"]``."""
    if debug not in (0, 1, 2, 3):
        raise ValueError(f"the kernel renders debug 0-3, not {debug}")
    _check_accum(accum)
    device = accum.device
    height, width = accum.shape[0], accum.shape[1]
    _check_table("table", table, torch.float32, prog.f_len, device)
    code = program_code_on(prog, device)
    lib = load_library()
    with torch.cuda.device(device):
        err = lib.cpt_megakernel_march(
            code.data_ptr(), prog.ops.shape[0], table.data_ptr(), prog.n_boxed,
            prog.f_box, prog.f_mat, int(prog.geometry == "baked"),
            int(bool(t_cull)), accum.data_ptr(), width, height, int(frame),
            int(last_clear), int(bounces), float(fov), float(aspect),
            int(debug), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"marching kernel launch failed: CUDA error {err}")
    LAUNCHES["megakernel_march"] += 1
