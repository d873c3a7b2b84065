"""One progressive full-analytic frame: the CUDA megakernel and its plain
torch version.

``render_frame_megakernel`` keeps the signature of the JAX package's
``render_frame_pallas`` and runs its ``geometry="baked", analytic_all=True``
mode: bake the params (render/baked.py), pack the scene tables
(render/soa.py), then one launch of ``csrc/megakernel_analytic.cu`` renders
the frame and updates the (H, W, 3) float32 accumulator in place.  On a CPU
tensor it runs ``render_frame_megakernel_plain`` instead: the same frame in
vectorized torch, which is also the reference the kernel is held to.

Bake and pack run per frame on the params' device as a few hundred batched
tensor ops with cached index tensors, so a frame issues no host round trip.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..constants import DEFAULT_BOUNCES, DEFAULT_FOV
from ..ops.camera import calc_uv, primary_ray
from ..ops.rng import gen_rng, random_float01
from ..render.baked import bake
from ..render.reference import gather_material, path_trace
from ..render.soa import (
    SoaSmemLayout,
    build_soa_smem_layout,
    make_cast_soa,
    make_normal_soa,
    material_table,
    pack_soa_smem,
)
from ..scene.compile import SceneSpec
from ..vecmath import Vec3
from .build import load_library

# Kernel launches since import (or since a caller reset it): the count a run
# reads to show that the main path went through the kernel.
LAUNCHES = 0


def _layout_for(spec: SceneSpec, geometry: str, analytic_all: bool,
                debug: int) -> SoaSmemLayout:
    if geometry != "baked" or not analytic_all:
        raise NotImplementedError(
            "only geometry='baked', analytic_all=True is ported; the marching "
            "modes wait for K2 (ROADMAP queue 1, item 6)")
    if debug not in (0, 3):
        raise NotImplementedError(
            f"debug={debug} is a marching diagnostic; it waits for K2 "
            "(ROADMAP queue 1, item 6)")
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


def _running_mean(accum, img, last_clear: int, debug: int):
    """Write the frame into ``accum`` in place: the running mean with weight
    1/(last_clear+1) in float32 (test_compute.glsl:242-245), or the debug
    image itself."""
    if debug != 0:
        return accum.copy_(img)
    w = np.float32(1.0) / np.float32(last_clear + 1)
    return accum.copy_(accum * float(np.float32(1.0) - w) + img * float(w))


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
    geometry: str = "baked",
    analytic_all: bool = True,
) -> torch.Tensor:
    """The kernel's frame in vectorized torch, on ``params``' device."""
    layout = _layout_for(spec, geometry, analytic_all, debug)
    if aspect is None:
        aspect = width / height
    device = params.device
    accum = _accum_for(accum, height, width, device)
    with torch.no_grad():
        bv = bake(spec, params)
        soa_f, soa_i = pack_soa_smem(layout, bv, params)
        cast = make_cast_soa(layout)
        normal = make_normal_soa(layout)
        mats = material_table(layout, soa_f)

        ys, xs = torch.meshgrid(
            torch.arange(height, dtype=torch.int32, device=device),
            torch.arange(width, dtype=torch.int32, device=device),
            indexing="ij")
        rng = gen_rng(xs, ys, frame, width, height)
        rng, jx = random_float01(rng)
        rng, jy = random_float01(rng)
        u, v = calc_uv(xs.to(torch.float32) + (jx - 0.5),
                       ys.to(torch.float32) + (jy - 0.5),
                       width, height, aspect)
        ro, rd = primary_ray(u, v, fov)
        col, i_exit = path_trace(
            lambda ro_, rd_: cast(ro_, rd_, soa_f, soa_i),
            lambda p_, idx_: normal(p_, idx_, soa_f, soa_i),
            lambda idx_: gather_material(mats, idx_),
            ro, rd, rng, bounces)
        if debug == 3:
            col = Vec3.splat(i_exit.to(torch.float32) / float(bounces))
        return _running_mean(accum, col.stack(), last_clear, debug)


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
    geometry: str = "baked",
    analytic_all: bool = True,
) -> torch.Tensor:
    """One progressive frame through the CUDA megakernel; returns the (H, W,
    3) float32 accumulator, updated in place (a new zero one when ``accum``
    is None).

    Runs on ``params``' device: a CUDA tensor launches the kernel on the
    current stream without synchronising, a CPU tensor runs
    :func:`render_frame_megakernel_plain`.  Only the full-analytic mode
    (``geometry="baked"``, ``analytic_all=True``, ``debug`` 0 or 3) is
    ported; a tree with a non-union op raises ``ValueError``.
    """
    kw = dict(width=width, height=height, debug=debug, bounces=bounces,
              fov=fov, aspect=aspect, geometry=geometry,
              analytic_all=analytic_all)
    if params.device.type == "cpu":
        return render_frame_megakernel_plain(spec, params, accum, frame,
                                             last_clear, **kw)
    if params.device.type != "cuda":
        raise ValueError(f"no kernel for device {params.device}")
    layout = _layout_for(spec, geometry, analytic_all, debug)
    if params.dtype != torch.float32 or params.shape != (spec.n_params,):
        raise ValueError(
            f"params must be float32 of shape ({spec.n_params},), got "
            f"{params.dtype} {tuple(params.shape)}")
    if aspect is None:
        aspect = width / height
    accum = _accum_for(accum, height, width, params.device)
    with torch.no_grad():
        bv = bake(spec, params)
        soa_f, soa_i = pack_soa_smem(layout, bv, params)
    launch_megakernel(layout, soa_f, soa_i, accum, frame=frame,
                      last_clear=last_clear, bounces=bounces, fov=fov,
                      aspect=aspect, debug=debug)
    return accum


def launch_megakernel(layout: SoaSmemLayout, soa_f: torch.Tensor,
                      soa_i: torch.Tensor, accum: torch.Tensor, *, frame: int,
                      last_clear: int, bounces: int, fov: float, aspect: float,
                      debug: int) -> None:
    """Launch the kernel on packed tables (``pack_soa_smem``) and a CUDA
    (H, W, 3) float32 accumulator, on the current stream; counts the
    launch in ``LAUNCHES``."""
    global LAUNCHES
    if debug not in (0, 3):
        raise ValueError(f"the kernel renders debug 0 or 3, not {debug}")
    device = accum.device
    height, width = accum.shape[0], accum.shape[1]
    for name, t, dtype, n in (("soa_f", soa_f, torch.float32, layout.f_len),
                              ("soa_i", soa_i, torch.int32, layout.i_len)):
        if (t.device != device or t.dtype != dtype or t.shape != (n,)
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous {dtype} ({n},) on "
                             f"{device}")
    if (device.type != "cuda" or accum.dtype != torch.float32
            or accum.dim() != 3 or accum.shape[2] != 3
            or not accum.is_contiguous()):
        raise ValueError("accum must be a contiguous CUDA (H, W, 3) float32 "
                         "tensor")
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
    LAUNCHES += 1
