"""The march probes of the JAX package's ``benchmarks/`` on the card
(``csrc/march_probes.cu``), and their plain torch versions.

Each takes flat (n,) float32 rays and a baked program's table, as
``march_rays`` (K3) does, and changes one thing of K3's march:

* ``march_dense`` (``benchmarks/dense_probe.py:dense``): the exact march
  with every leaf evaluated at every tap, the guards as selects, over the
  program staged in each block's shared memory; returns ``(t, idx)``.  Its
  plain version is ``march_rays_plain(t_cull=False)``: the values are the
  exact march's, only the work differs.
* ``march_capped`` (``benchmarks/analytic_probe.py:capped``): the t-culled
  march of the program without the guard-less shapes
  (``capped_program``), each ray stopped at their closed-form hit, over
  K3's per-warp lists of the program staged in each block's shared memory;
  returns ``t``.  Its plain version is ``cast_tcull`` under
  ``make_analytic_unboxed``'s cap; ``capped_list_lengths`` gives each
  warp's list length (``warp_records``, the lists' plain model).
* ``march_ilp`` (``benchmarks/ilp_probe.py:run``): the exact march with
  two rays per thread, one after the other (``interleave=False``) or in one
  loop (``interleave=True``), over per-warp lists of the program staged in
  each block's shared memory; returns ``t``, the exact march's.
  ``ilp_warps`` gives the list each ray's march walks, ``ilp_list_lengths``
  their mean length (``warp_records``, the lists' plain model).

On CUDA tensors each launches its kernel on the current stream without
synchronising and counts the launch in ``LAUNCHES``; on CPU tensors it runs
its plain version.  ``benchmarks/`` (of this package) times them.
"""

from __future__ import annotations

import torch

from ..render.baked import baked_layout
from ..render.program import (
    Program,
    build_program,
    cast_tcull,
    make_map_program,
    program_bounds,
    program_code_on,
    walk_smem_bytes,
    warp_records,
)
from ..scene.compile import SceneSpec
from ..scene.model import KIND_PLANE, KIND_SPHERE
from ..vecmath import Vec3
from .build import load_library
from .march import WARPS, _check_rays, march_rays_plain
from .megakernel import make_analytic_unboxed

# Launches per kernel since import (or since a caller reset them).
LAUNCHES = {"march_dense": 0, "march_capped": 0, "march_ilp_seq": 0,
            "march_ilp_fused": 0}


def _baked(prog: Program) -> None:
    if prog.geometry != "baked":
        raise ValueError("the march probes take a baked program")


def _launch(name, fn, prog: Program, table, ro: Vec3, rd: Vec3, outs, *args,
            tail=()):
    """Launch ``lib.<fn>(code, n_ops, table, n_boxed, f_box, *args, n, rays,
    *outs, *tail, stream)`` on CUDA tensors and count it under ``name``."""
    if table.device.type != "cuda":
        raise ValueError(f"no kernel for device {table.device}")
    n = _check_rays(prog, table, ro, rd)
    if n:
        code = program_code_on(prog, table.device)
        with torch.cuda.device(table.device):
            err = getattr(load_library(), fn)(
                code.data_ptr(), prog.ops.shape[0], table.data_ptr(),
                prog.n_boxed, prog.f_box, *args, n,
                *(c.data_ptr() for c in (*ro, *rd)),
                *(o.data_ptr() for o in outs), *tail,
                torch.cuda.current_stream(table.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
        LAUNCHES[name] += 1


def march_dense_plain(prog: Program, table, ro: Vec3, rd: Vec3, count=None):
    """The dense probe's values: K3's exact march, ``(t, idx)``.
    ``count`` takes ``march_rays_plain``'s tally, whose taps the dense
    kernel pays for with every leaf of the program."""
    _baked(prog)
    return march_rays_plain(prog, table, ro, rd, t_cull=False,
                            with_normal=False, count=count)


def march_dense(prog: Program, table, ro: Vec3, rd: Vec3):
    """The dense probe on flat rays: ``(t, idx)`` as K3's exact march.  Its
    blocks hold the program in shared memory (``walk_smem_bytes(prog, 0)``,
    which raises for a program too large)."""
    _baked(prog)
    if table.device.type == "cpu":
        return march_dense_plain(prog, table, ro, rd)
    smem = walk_smem_bytes(prog, 0)
    t = torch.empty_like(ro.x)
    idx = torch.empty(t.shape, dtype=torch.int32, device=t.device)
    _launch("march_dense", "cpt_march_dense", prog, table, ro, rd, (t, idx),
            tail=(smem,))
    return t, idx


def capped_program(spec: SceneSpec) -> Program:
    """The capped probe's program: ``build_program(spec, "baked",
    skip_unboxed=True)``, whose cap list holds the guard-less shapes of
    ``analytic_eligible_ids`` (on the benchmark scene the ground plane and
    the two lamps, the probe's guard-less set).  Raises ``ValueError`` when
    one of them is neither a plane nor a sphere, as the probe asserts
    (analytic_probe.py:62-64)."""
    prog = build_program(spec, "baked", True)
    _check_caps(prog)
    return prog


def _check_caps(prog: Program) -> None:
    _baked(prog)
    if not set(prog.caps[:, 0].tolist()) <= {KIND_PLANE, KIND_SPHERE}:
        raise ValueError("the capped probe caps planes and spheres only")


def march_capped_plain(prog: Program, table, ro: Vec3, rd: Vec3, count=None):
    """The capped probe's t: ``cast_tcull`` over ``prog`` (a
    ``capped_program``) under the closed-form cap of its removed shapes.
    ``count`` takes the map's tally and ``"cap_segments"``."""
    _check_caps(prog)
    with torch.no_grad():
        checks, _ = program_bounds(prog, table, ro, rd, True)
        bv = table[:baked_layout(prog.spec).n_slots]
        t_cap, _ = make_analytic_unboxed(prog.spec)[0](ro, rd, bv)
        if count is not None:
            count["cap_segments"] = (count.get("cap_segments", 0)
                                     + ro.x.shape[0])
        map_fn = make_map_program(prog, table.tolist(), count)
        return cast_tcull(prog, map_fn, ro, rd, checks, t_cap)[0]


def capped_list_lengths(prog: Program, table, ro: Vec3, rd: Vec3):
    """The (n_warps,) int64 lengths of the lists the capped probe's warps
    walk on these rays: K3's warp of 32 consecutive rays, ``warp_records``
    over the capped program's guards."""
    _check_caps(prog)
    with torch.no_grad():
        checks, _ = program_bounds(prog, table, ro, rd, True)
        return warp_records(prog, checks[0],
                            ilp_warps(ro.x.shape[0], False, ro.x.device)
                            ).sum(1)


def march_capped(prog: Program, table, ro: Vec3, rd: Vec3, walk_stats=None):
    """The capped probe on flat rays: ``t``, on ``prog`` (a
    ``capped_program``) and its ``program_table(..., t_cull=True)``.  Its
    blocks hold the program in shared memory (``walk_smem_bytes(prog, 4)``,
    which raises for a program too large).  ``walk_stats``, a zeroed (2,)
    int64 tensor on the table's device, takes the summed length of the
    warps' lists and their number (on the CPU, from
    ``capped_list_lengths``)."""
    _check_caps(prog)
    if walk_stats is not None and (
            walk_stats.device != table.device
            or walk_stats.dtype != torch.int64
            or tuple(walk_stats.shape) != (2,)):
        raise ValueError(f"walk_stats must be int64 (2,) on {table.device}")
    if table.device.type == "cpu":
        if walk_stats is not None:
            lengths = capped_list_lengths(prog, table, ro, rd)
            walk_stats += torch.stack([lengths.sum(),
                                       torch.tensor(lengths.numel())])
        return march_capped_plain(prog, table, ro, rd)
    smem = walk_smem_bytes(prog, WARPS)
    t = torch.empty_like(ro.x)
    _launch("march_capped", "cpt_march_capped", prog, table, ro, rd, (t,),
            prog.caps.shape[0],
            tail=(None if walk_stats is None else walk_stats.data_ptr(),
                  smem))
    return t


def march_ilp_plain(prog: Program, table, ro: Vec3, rd: Vec3, count=None):
    """The ILP probe's t: K3's exact march."""
    return march_dense_plain(prog, table, ro, rd, count)[0]


def ilp_warps(n: int, interleave: bool, device=None) -> torch.Tensor:
    """The (n,) index of the per-warp list each of ``n`` rays is marched
    over.  A block of the probe takes 256 rays; its thread j (4 warps of 32)
    marches rays j and j + 128.  Sequential: a list per 32 consecutive rays,
    K3's warp (``i // 32``); interleaved: one list per warp over both its
    halves, the union of their guards."""
    i = torch.arange(n, device=device)
    if not interleave:
        return i // 32
    return (i // 256) * WARPS + (i % 128) // 32


def ilp_list_lengths(prog: Program, table, ro: Vec3, rd: Vec3) -> dict:
    """The mean length of the lists the ILP probe's warps walk on these
    rays, from the plain model (``warp_records`` over the exact march's
    guards): ``{"seq": ..., "fused": ...}``, of ``prog.ops.shape[0]``
    records."""
    _baked(prog)
    with torch.no_grad():
        checks, _ = program_bounds(prog, table, ro, rd, False)
        n = ro.x.shape[0]
        return {name: float(warp_records(
            prog, checks[0], ilp_warps(n, fused, ro.x.device))
            .sum(1).double().mean())
                for name, fused in (("seq", False), ("fused", True))}


def march_ilp(prog: Program, table, ro: Vec3, rd: Vec3, *,
              interleave: bool = False):
    """The ILP probe on flat rays: ``t`` of the exact march, each thread
    marching rays i and i + 128 of its 256-ray block one after the other
    or, with ``interleave``, in one loop.  Its blocks hold the program in
    shared memory (``walk_smem_bytes(prog, 4)``, which raises for a program
    too large)."""
    _baked(prog)
    if table.device.type == "cpu":
        return march_ilp_plain(prog, table, ro, rd)
    smem = walk_smem_bytes(prog, WARPS)
    t = torch.empty_like(ro.x)
    _launch("march_ilp_fused" if interleave else "march_ilp_seq",
            "cpt_march_ilp", prog, table, ro, rd, (t,), int(bool(interleave)),
            tail=(smem,))
    return t
