"""Port parity: the march probes (kernels/probes.py) against the JAX
package's probe kernels (benchmarks/dense_probe.py, analytic_probe.py,
ilp_probe.py), each run as its probe builds it through
``pl.pallas_call(..., interpret=True)`` on one (64, 128) tile of primary
rays, the probes' own camera at 128x64.

On the CPU each probe runs its plain version; chip_smoke.py holds the CUDA
kernels to them on the card.  Tolerances, with their reasons:

* dense and both ILP kernels march exactly: the ids equal, the same rays
  hit, and t within 1e-5 on the hits that converged (|d| < 2 MHD at the
  final t; tests/test_torch_march_rays.py's exact-march bound: XLA
  contracts multiply-adds, the port rounds each operation).  A ray whose
  80 steps run out short of a surface stops wherever its last step lands,
  after rounding has compounded over the steps: 6 of 4,883 hits on
  benchmark_scene(64), up to 6.8e-3 apart at t = 88, all such;
* capped: at most 0.5 % of rays move t by more than 1e-3.  The port culls
  per ray on bounding spheres where the probe culls per tile on the
  reference boxes, and takes K1's closed forms for the cap, so a hit
  fires elsewhere in the |d| < MHD shell on grazing rays.
"""

import importlib.util
from functools import lru_cache
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from compute_path_tracer_tpu.ops.camera import calc_uv, primary_ray
from compute_path_tracer_tpu.render.baked import bake
from compute_path_tracer_tpu.scene import compile_scene as j_compile
from compute_path_tracer_tpu.scene import library as j_lib
from compute_path_tracer_tpu_torch.constants import FP, MHD
from compute_path_tracer_tpu_torch.kernels import probes as pr
from compute_path_tracer_tpu_torch.render.program import (
    build_program, make_map_program, program_bounds, program_table)
from compute_path_tracer_tpu_torch.scene import compile_scene as t_compile
from compute_path_tracer_tpu_torch.scene import convert_scene
from compute_path_tracer_tpu_torch.vecmath import Vec3 as TVec3

TILE = (64, 128)
BENCH = Path(__file__).resolve().parents[1] / "benchmarks"


def _probe(name):
    spec = importlib.util.spec_from_file_location(name, BENCH / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@lru_cache(maxsize=None)
def scenes(n):
    scene = j_lib.benchmark_scene(n)
    return j_compile(scene), t_compile(convert_scene(scene))


@lru_cache(maxsize=None)
def rays():
    """The probes' primary rays (no jitter) of a 128x64 image, as (6, 64,
    128) float32."""
    h, w = TILE
    xs = jnp.broadcast_to(jnp.arange(w, dtype=jnp.int32)[None, :], (h, w))
    ys = jnp.broadcast_to(jnp.arange(h, dtype=jnp.int32)[:, None], (h, w))
    u, v = calc_uv(xs.astype(jnp.float32), ys.astype(jnp.float32), w, h,
                   jnp.float32(w / h))
    ro, rd = primary_ray(u, v, jnp.float32(1.0))
    return np.stack([np.broadcast_to(np.asarray(c), (h, w))
                     for c in (*ro, *rd)]).astype(np.float32)


@lru_cache(maxsize=None)
def jax_probe(kind, n):
    """The probe kernel's outputs on the tile, flattened."""
    jc, _ = scenes(n)
    if kind == "dense":
        kernel = _probe("dense_probe")._dense_march_kernel(jc.spec)
        outs = 2
    elif kind == "capped":
        kernel = _probe("analytic_probe")._make_capped_kernel(jc.spec)
        outs = 1
    else:
        seq, fused = _probe("ilp_probe")._make_kernels(jc.spec)
        kernel = seq if kind == "seq" else fused
        outs = 1
    tile = pl.BlockSpec(TILE, lambda i, j: (i, j), memory_space=pltpu.VMEM)
    smem = pl.BlockSpec(memory_space=pltpu.SMEM)
    shapes = (jax.ShapeDtypeStruct(TILE, jnp.float32),
              jax.ShapeDtypeStruct(TILE, jnp.int32))[:outs]
    out = pl.pallas_call(
        kernel, grid=(1, 1), in_specs=[smem] + [tile] * 6,
        out_specs=(tile, tile)[:outs] if outs > 1 else tile,
        out_shape=shapes if outs > 1 else shapes[0], interpret=True,
    )(bake(jc.spec, jnp.asarray(jc.params)), *map(jnp.asarray, rays()))
    return tuple(np.asarray(o).ravel() for o in (out if outs > 1 else (out,)))


def port_rays():
    return (TVec3(*(torch.from_numpy(c.ravel().copy()) for c in rays()[:3])),
            TVec3(*(torch.from_numpy(c.ravel().copy()) for c in rays()[3:])))


def port_probe(kind, n):
    _, tc = scenes(n)
    params = torch.from_numpy(tc.params)
    ro, rd = port_rays()
    if kind == "capped":
        prog = pr.capped_program(tc.spec)
        return (pr.march_capped(prog, program_table(prog, params, True), ro,
                                rd).numpy(),)
    prog = build_program(tc.spec, "baked")
    table = program_table(prog, params, False)
    if kind == "dense":
        return tuple(o.numpy() for o in pr.march_dense(prog, table, ro, rd))
    return (pr.march_ilp(prog, table, ro, rd,
                         interleave=kind == "fused").numpy(),)


def check_exact_probe(kind, n):
    """Dense or an ILP kernel against the JAX probe kernel."""
    j = jax_probe(kind, n)
    t = port_probe(kind, n)
    hit = j[0] <= FP
    assert 0.2 < hit.mean() < 0.9
    np.testing.assert_array_equal(t[0] > FP, ~hit)
    _, tc = scenes(n)
    prog = build_program(tc.spec, "baked")
    table = program_table(prog, torch.from_numpy(tc.params), False)
    ro, rd = port_rays()
    guards, _ = program_bounds(prog, table, ro, rd, False)
    d = make_map_program(prog, table.tolist())(
        ro + rd * torch.from_numpy(t[0]), guards[0])[0].abs().numpy()
    conv = hit & (d < 2 * MHD)
    assert conv.sum() > 0.9 * hit.sum()
    np.testing.assert_allclose(t[0][conv], j[0][conv], rtol=0, atol=1e-5)
    if kind == "dense":
        np.testing.assert_array_equal(t[1], j[1])


@pytest.mark.parametrize("kind", ["dense", "seq", "fused"])
def test_exact_probes_match_jax(kind):
    """benchmark_scene(16); test_torch_probes_64.py takes (64)."""
    check_exact_probe(kind, 16)


@pytest.mark.parametrize("n", [16, 64])
def test_capped_probe_matches_jax(n):
    a = np.minimum(jax_probe("capped", n)[0], FP + 1.0)
    b = np.minimum(port_probe("capped", n)[0], FP + 1.0)
    assert (np.abs(a - b) > 1e-3).mean() <= 5e-3


def test_probes_agree_and_launch_nothing_on_cpu():
    """On CPU tensors: ILP's t in both orders and dense's t are K3's exact
    march bit for bit, the capped probe computes its cap once a ray, and no
    kernel is launched."""
    _, tc = scenes(16)
    params = torch.from_numpy(tc.params)
    ro, rd = port_rays()
    prog = build_program(tc.spec, "baked")
    table = program_table(prog, params, False)
    before = dict(pr.LAUNCHES)
    t_dense, _ = pr.march_dense(prog, table, ro, rd)
    for interleave in (False, True):
        assert torch.equal(pr.march_ilp(prog, table, ro, rd,
                                        interleave=interleave), t_dense)
    cprog = pr.capped_program(tc.spec)
    count = {}
    t_cap = pr.march_capped_plain(cprog, program_table(cprog, params, True),
                                  ro, rd, count)
    assert count["cap_segments"] == ro.x.shape[0] and count["taps"] > 0
    assert bool(torch.isfinite(t_cap).all())
    assert pr.LAUNCHES == before


def test_capped_probe_rejects_other_guardless_kinds():
    """A guard-less cube is capped by analytic_unboxed, but the probe caps
    planes and spheres only (analytic_probe.py:62-64)."""
    from compute_path_tracer_tpu_torch.scene import (
        KIND_CUBE, Scene, Shape, Union, compile_scene)

    root = Union(name="Root")
    box = root.add_shape(Shape(KIND_CUBE, name="Box"))
    box.transform.aabb = False
    spec = compile_scene(Scene([root])).spec
    with pytest.raises(ValueError):
        pr.capped_program(spec)


def test_probes_take_baked_programs():
    _, tc = scenes(16)
    prog = build_program(tc.spec, "faithful")
    table = program_table(prog, torch.from_numpy(tc.params), False)
    ro, rd = port_rays()
    for fn in (pr.march_dense, pr.march_ilp):
        with pytest.raises(ValueError):
            fn(prog, table, ro, rd)
