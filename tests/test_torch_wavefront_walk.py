"""Port parity: the wavefront bounce on K2's per-warp walk of the staged
program (kernels/csrc/wavefront.cu: each warp takes 32 consecutive live
rays of the compacted buffer, builds the list of the records they can
need after their guards, and marches and takes the normal over it).

Each bounce of a small plain wavefront frame (24x16, 2 bounces) is
captured, compacted and sorted, on csg_demo (subtraction), blend_demo
(smooth union), the first-shape clobber scene and ``benchmark_scene(64)``.
For each bounce the live rays ``[0, k)`` are cut into 32-ray warps and:

* marched and given their normal through ``make_map_program(records=)``
  over the warp's row of ``warp_records`` (render/program.py), the lists'
  plain model: t, the winner id and the normal equal the full program's
  bit for bit;
* the map at the hits through those lists agrees, in the first bounce a
  test walks, with the JAX package's faithful map under the same guards
  (ids equal, distances to 1e-5, the contract of tests/test_torch_sdf.py);
* ``walk_stats`` (the kernel's summed list length and list count) equals
  the model's, whose mean list length per bounce is the figure the kernel
  must give; a bounce with k = 0 builds no list.

And ``walk_smem_bytes`` of the faithful programs, with the error an
oversized program raises in ``wavefront_bounce``.  The kernel walks the
lists on the card; chip_smoke.py holds its frames and ``walk_stats`` to
the plain version there."""

import dataclasses
from functools import lru_cache

import numpy as np
import pytest
import torch

from compute_path_tracer_tpu_torch.benchmarks import frozen_wavefront as fw
from compute_path_tracer_tpu_torch.constants import DEFAULT_FOV, FP
from compute_path_tracer_tpu_torch.kernels import wavefront as wf
from compute_path_tracer_tpu_torch.render import program as tp
from compute_path_tracer_tpu_torch.render.reference import (
    calc_normal, cast_ray, take_lanes)
from compute_path_tracer_tpu_torch.scene import params_from_numpy
from compute_path_tracer_tpu_torch.vecmath import Vec3
from test_torch_warp_walk import SCENES, _jax_map, _pair, _shape_checks
import jax.numpy as jnp
from compute_path_tracer_tpu.vecmath import Vec3 as JVec3

W, H, BOUNCES = 24, 16, 2


@lru_cache(maxsize=None)
def _bounces(name, sort_rays):
    """(program, table, each bounce's (k, ray, walk_stats)) of a plain
    wavefront frame: the live count and the ray buffer as the bounce gets
    them, and the model's walk_stats it adds."""
    _, tc = _pair(name)
    params = params_from_numpy(tc.params, tc.spec, "cpu")
    prog = tp.build_program(tc.spec, "faithful")
    table = tp.program_table(prog, params)
    rec = []

    def bounce(prog, table, k, ray, rng):
        ws = torch.zeros(2, dtype=torch.int64)
        rec.append((int(k[0]), ray.clone(), ws))
        return wf.wavefront_bounce(prog, table, k, ray, rng, walk_stats=ws)

    fw._wavefront_trace(tc.spec, params, 1, DEFAULT_FOV, W / H, width=W,
                        height=H, bounces=BOUNCES, sort_rays=sort_rays,
                        bounce=bounce)
    return prog, table, rec


def _march(map_fn, ro, rd, checks):
    """The bounce's exact march and 6-tap normal (zero on a miss) over
    ``map_fn``: (t, idx, normal)."""
    def mapped(p, c):
        return map_fn(p, c[0])

    t, idx = cast_ray(mapped, ro, rd, checks)
    hit = torch.nonzero(~(t > FP)).flatten()
    p = ro + rd * t
    nh = calc_normal(mapped, Vec3(*(c[hit] for c in p)),
                     take_lanes(checks, hit))
    n = torch.zeros((3, t.shape[0]))
    n[:, hit] = torch.stack(list(nh))
    return t, idx, n


@pytest.mark.parametrize("sort_rays", [False, True],
                         ids=["compacted", "sorted"])
@pytest.mark.parametrize("name", SCENES)
def test_bounce_through_warp_lists(name, sort_rays):
    prog, table, rec = _bounces(name, sort_rays)
    jc, _ = _pair(name)
    jmap = _jax_map(jc, "faithful")
    vals = table.tolist()
    full = tp.make_map_program(prog, vals)
    for b, (k, ray, ws) in enumerate(rec):
        if k == 0:
            assert ws.tolist() == [0, 0]
            continue
        if sort_rays and b == 0:
            # The first bounce is compacted, not sorted: the compacted
            # order's test holds it.
            first = _bounces(name, False)[2][0]
            assert k == first[0] and torch.equal(ray, first[1])
            continue
        ro, rd = Vec3(*ray[0:3, :k]), Vec3(*ray[3:6, :k])
        checks, _ = tp.program_bounds(prog, table, ro, rd, False)
        lists = tp.warp_records(prog, checks[0], torch.arange(k) // 32)
        assert lists.shape[0] == -(-k // 32)
        assert ws.tolist() == [int(lists.sum()), lists.shape[0]]
        want = _march(full, ro, rd, checks)
        got = [torch.empty_like(x) for x in want]
        d_walk = torch.empty_like(ro.x)
        i_walk = torch.empty(k, dtype=torch.int32)
        for w in range(lists.shape[0]):
            rows = torch.arange(32 * w, min(32 * w + 32, k))
            walk = tp.make_map_program(prog, vals,
                                       records=torch.nonzero(lists[w]).flatten())
            sub = [Vec3(*(c[rows] for c in v)) for v in (ro, rd)]
            wc = take_lanes(checks, rows)
            for out, x in zip(got, _march(walk, *sub, wc)):
                out[..., rows] = x
            hp = sub[0] + sub[1] * got[0][rows]
            d_walk[rows], i_walk[rows] = walk(hp, wc[0])
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        if jmap is None:
            continue
        hit = torch.nonzero(~(got[0] > FP)).flatten()
        pj = JVec3(*(jnp.asarray(c[hit].numpy()) for c in ro + rd * got[0]))
        dj, ij = jmap(pj, _shape_checks(prog, checks[0][hit]))
        np.testing.assert_allclose(d_walk[hit].numpy(), np.asarray(dj),
                                   rtol=0, atol=1e-5)
        assert np.array_equal(i_walk[hit].numpy(), np.asarray(ij))
        jmap = None
    # The last warp of a bounce is partial: the kernel's lanes past k take
    # part in its list as not live.
    assert any(k % 32 for k, _, _ in rec)


def test_empty_bounce_and_the_wrapper():
    """k = 0 shades nothing and builds no list; on CPU tensors the wrapper
    is the plain version, walk_stats included, and launches nothing."""
    prog, table, rec = _bounces("benchmark_64", False)
    k, ray, _ = rec[1]
    n = ray.shape[1]
    rng = torch.arange(n, dtype=torch.int32)
    ws = torch.zeros(2, dtype=torch.int64)
    r = ray.clone()
    add, alive = wf.wavefront_bounce(prog, table,
                                     torch.zeros(1, dtype=torch.int32), r,
                                     rng.clone(), walk_stats=ws)
    assert ws.tolist() == [0, 0] and torch.equal(r, ray)
    assert not bool(add.any()) and not bool(alive.any())
    before = dict(wf.LAUNCHES)
    outs = []
    for fn in (wf.wavefront_bounce, wf.wavefront_bounce_plain):
        ws, r, g = torch.zeros(2, dtype=torch.int64), ray.clone(), rng.clone()
        kk = torch.tensor([k - 5], dtype=torch.int32)
        outs.append((*fn(prog, table, kk, r, g, walk_stats=ws), r, g, ws))
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    assert outs[0][4][1] == -(-(k - 5) // 32) and (k - 5) % 32
    assert wf.LAUNCHES == before


def test_walk_smem_bytes_and_oversize():
    """The block's shared memory (4 warps' lists) of the faithful programs,
    and a program a block cannot hold raising in the wrapper, naming the
    sizes, before anything reaches a device."""
    for name in SCENES:
        prog = tp.build_program(_pair(name)[1].spec, "faithful")
        got = tp.walk_smem_bytes(prog, wf.WARPS)
        assert got == (16 * prog.ops.shape[0] * (1 + wf.WARPS)
                       + 16 * -(-(prog.f_box + 3) // 4))
        assert got % 16 == 0 and got <= tp.SMEM_PER_BLOCK
    prog, table, _ = _bounces("benchmark_64", False)
    assert wf.WARPS == 4 and prog.ops.shape[0] == 66
    big = dataclasses.replace(prog, ops=np.zeros((3000, tp.OP_WIDTH), np.int32))
    meta = dict(device="meta")
    args = (table.to("meta"), torch.zeros(1, dtype=torch.int32, **meta),
            torch.zeros((9, 64), **meta),
            torch.zeros(64, dtype=torch.int32, **meta))
    with pytest.raises(ValueError, match="3000 op records.*more than 232448"):
        wf.wavefront_bounce(big, *args)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        wf.wavefront_bounce(prog, *args)
