"""Port parity: the fused-bwd probe on K3's per-warp walk of the staged
program (kernels/csrc/grad_probes.cu:fused_bwd: each warp of 32
consecutive pixels of a rectangle row builds the list of the records its
lanes can need after their baked guards, and marches and takes the normal
over it).

On csg_demo (subtraction), blend_demo (smooth union), the first-shape
clobber scene and ``benchmark_scene(64)``, the probe camera's primary rays
over two small rectangles (64x4 at the centre of the 1920x1080 view, all
hits; 40x3 below and left of it, hits and misses, its warps spanning rows
and its last warp partial) are cut into the kernel's warps
(``grad_probes.fused_bwd_warps``), and:

* marched and given their normal through ``make_map_program(records=)``
  over the warp's row of ``warp_records`` (render/program.py), the lists'
  plain model: t, the winner id and the normal equal the full program's
  bit for bit, and so does each pixel's loss term and their sum;
* that loss agrees with ``fused_bwd_plain``'s (autograd through the
  implicit march over the baked map) within chip_smoke.py's FB_LOSS_TOL;
* the map at the hits through those lists agrees with the JAX package's
  baked and faithful maps under the same guards (ids equal, distances to
  1e-5, the contract of tests/test_torch_sdf.py);
* ``walk_stats`` on the CPU (the plain model the kernel's figures are held
  to on the card) equals the lists' summed length and count.

And the block's shared memory (8 warps' lists), with the error an
oversized program raises in the launcher.  The kernel walks the lists on
the card; chip_smoke.py holds its loss and ``walk_stats`` to the plain
version there."""

import dataclasses
from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compute_path_tracer_tpu.vecmath import Vec3 as JVec3
from compute_path_tracer_tpu_torch.constants import FP, MAT_SIZE
from compute_path_tracer_tpu_torch.kernels import grad_probes as gp
from compute_path_tracer_tpu_torch.render import program as tp
from compute_path_tracer_tpu_torch.render.baked import bake
from compute_path_tracer_tpu_torch.render.reference import (
    calc_normal, cast_ray, gather_material, shade_bounce, take_lanes)
from compute_path_tracer_tpu_torch.scene import params_from_numpy
from compute_path_tracer_tpu_torch.vecmath import Vec3
from test_torch_warp_walk import SCENES, _jax_map, _pair, _shape_checks

RECTS = {"centre": (896, 508, 64, 4), "ragged": (700, 600, 40, 3)}
FB_LOSS_TOL = 1e-5     # chip_smoke.py's, the kernel's against the plain


@lru_cache(maxsize=None)
def _scene(name):
    """(spec, params, bv, program, table) of the probe on ``name``."""
    _, tc = _pair(name)
    params = params_from_numpy(tc.params, tc.spec, "cpu")
    with torch.no_grad():
        bv = bake(tc.spec, params)
    return (tc.spec, params, bv, *gp.fused_bwd_tables(tc.spec, params, bv))


def _bounce(prog, table, map_fn, rng, ro, rd, checks):
    """The kernel's bounce over ``map_fn``: (t, idx, normal (3, n), each
    pixel's loss term emit + thr_factor / ray_prob, 0 on a miss)."""
    def mapped(p, c):
        return map_fn(p, c[0])

    t, idx = cast_ray(mapped, ro, rd, checks)
    hit = torch.nonzero(~(t > FP)).flatten()
    p = ro + rd * t
    sub = [Vec3(*(c[hit] for c in v)) for v in (p, rd)]
    nh = calc_normal(mapped, sub[0], take_lanes(checks, hit))
    n = torch.zeros((3, t.shape[0]))
    n[:, hit] = torch.stack(list(nh))
    mats = table[prog.f_mat:].view(prog.n_shapes, MAT_SIZE)
    *_, emit, thr_f, ray_p = shade_bounce(rng[hit], sub[1], sub[0], nh,
                                          gather_material(mats, idx[hit]))
    col = emit + thr_f / ray_p
    term = torch.zeros_like(t)
    term[hit] = (col.x + col.y) + col.z
    return t, idx, n, term


@pytest.mark.parametrize("rect", list(RECTS), ids=list(RECTS))
@pytest.mark.parametrize("name", SCENES)
def test_fused_bwd_through_warp_lists(name, rect):
    spec, params, bv, prog, table = _scene(name)
    rect = RECTS[rect]
    rng, ro, rd = gp.fused_bwd_rays(rect, "cpu")
    n = ro.x.shape[0]
    checks, _ = tp.program_bounds(prog, table, ro, rd, False)
    warp = gp.fused_bwd_warps(n)
    lists = tp.warp_records(prog, checks[0], warp)
    assert lists.shape[0] == -(-n // 32)
    vals = table.tolist()
    want = _bounce(prog, table, tp.make_map_program(prog, vals), rng, ro, rd,
                   checks)
    got = [torch.empty_like(x) for x in want]
    d_walk = torch.empty_like(ro.x)
    i_walk = torch.empty(n, dtype=torch.int32)
    for w in range(lists.shape[0]):
        rows = torch.arange(32 * w, min(32 * w + 32, n))
        walk = tp.make_map_program(prog, vals,
                                   records=torch.nonzero(lists[w]).flatten())
        sub = [Vec3(*(c[rows] for c in v)) for v in (ro, rd)]
        wc = take_lanes(checks, rows)
        for out, x in zip(got, _bounce(prog, table, walk, rng[rows], *sub,
                                       wc)):
            out[..., rows] = x
        d_walk[rows], i_walk[rows] = walk(sub[0] + sub[1] * got[0][rows],
                                          wc[0])
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    loss = float(got[3].double().sum())
    assert loss == float(want[3].double().sum())
    ws = torch.zeros(2, dtype=torch.int64)
    p_loss, p_grad = gp.fused_bwd(spec, params, bv, rect, walk_stats=ws)
    assert ws.tolist() == [int(lists.sum()), lists.shape[0]]
    assert abs(loss - float(p_loss[0])) <= FB_LOSS_TOL * abs(loss)
    assert not bool(p_grad.any())
    hit = torch.nonzero(~(got[0] > FP)).flatten()
    if not hit.numel():
        assert loss == 0.0
        return
    jc, _ = _pair(name)
    p = ro + rd * got[0]
    pj = JVec3(*(jnp.asarray(c[hit].numpy()) for c in p))
    for geometry in ("baked", "faithful"):
        dj, ij = _jax_map(jc, geometry)(pj, _shape_checks(prog, checks[0][hit]))
        np.testing.assert_allclose(d_walk[hit].numpy(), np.asarray(dj),
                                   rtol=0, atol=1e-5)
        assert np.array_equal(i_walk[hit].numpy(), np.asarray(ij))


def test_the_probes_rectangles_hold_whole_warps():
    """A row of the probe's tile (128 pixels) and of the frame (1920) is
    whole warps, so each warp is 32 consecutive pixels of one row; the
    model's list count is the kernel's warp count."""
    for rect in (gp.TILE_RECT, gp.FRAME_RECT):
        assert rect[2] % 32 == 0
    warp = gp.fused_bwd_warps(40 * 3)
    assert warp.tolist() == [i // 32 for i in range(120)]


def test_walk_smem_bytes_and_oversize():
    """The block's shared memory (8 warps' lists) of the baked programs, and
    a program a block cannot hold raising in the launcher, naming the
    sizes, before anything reaches a device."""
    for name in SCENES:
        prog = _scene(name)[3]
        got = tp.walk_smem_bytes(prog, gp.FB_WARPS)
        assert got == (16 * prog.ops.shape[0] * (1 + gp.FB_WARPS)
                       + 16 * -(-(prog.f_box + 3) // 4))
        assert got % 16 == 0 and got <= tp.SMEM_PER_BLOCK
    *_, prog, table = _scene("benchmark_64")
    assert gp.FB_WARPS == 8 and prog.ops.shape[0] == 66
    assert tp.walk_smem_bytes(prog, gp.FB_WARPS) == 9 * 66 * 16 + 221 * 16
    big = dataclasses.replace(prog, ops=np.zeros((3000, tp.OP_WIDTH), np.int32))
    with pytest.raises(ValueError, match="3000 op records.*more than 232448"):
        gp.launch_fused_bwd(big, table.to("meta"), gp.TILE_RECT, 8)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        gp.launch_fused_bwd(prog, table.to("meta"), gp.TILE_RECT, 8)
    with pytest.raises(ValueError, match="not inside"):
        gp.launch_fused_bwd(prog, table, (1900, 0, 128, 64), 8)
