"""Port parity: the ILP probe on K3's per-warp walk of the staged program
(kernels/csrc/march_probes.cu: march_ilp_seq, march_ilp_fused).

A block of 128 threads (4 warps) takes 256 rays; thread j marches rays
256 b + j and 256 b + 128 + j.  Seq builds a list for each half of each
warp, 32 consecutive rays: K3's warp (march_rays.cu); fused builds one list
a warp over the union of both halves' guards and walks it for both rays at
once.  On an odd number of rays, so that the last block's second rays fall
past n, on csg_demo (subtraction), blend_demo (smooth union), the
first-shape clobber scene and ``benchmark_scene(64)``:

* the kernel's thread schedule, written out here, gives seq's lists K3's
  warp rows and fused's the union of its two halves
  (``kernels/probes.py:ilp_warps``), and ``ilp_list_lengths`` is their
  mean length;
* a plain model of each walk, the exact march of every ray through
  ``make_map_program(records=)`` over its list's row of ``warp_records``
  (render/program.py) under its own guards, gives ``march_ilp_plain``'s t
  bit for bit;
* the map at the hits through the union lists agrees with the JAX
  package's baked map under the same guards (ids equal, distances to
  1e-5, the contract of tests/test_torch_sdf.py);
* ``walk_smem_bytes`` is the block's shared memory, and an oversized
  program raises in ``march_ilp``.

The kernels walk the lists on the card; chip_smoke.py holds their t to
the plain version and K3's exact march there."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compute_path_tracer_tpu.vecmath import Vec3 as JVec3
from compute_path_tracer_tpu_torch.benchmarks.common import probe_rays
from compute_path_tracer_tpu_torch.constants import FP
from compute_path_tracer_tpu_torch.kernels import march as km
from compute_path_tracer_tpu_torch.kernels import probes as pr
from compute_path_tracer_tpu_torch.render import program as tp
from compute_path_tracer_tpu_torch.render.reference import cast_ray, take_lanes
from compute_path_tracer_tpu_torch.scene import params_from_numpy
from compute_path_tracer_tpu_torch.vecmath import Vec3
from test_torch_warp_walk import SCENES, _jax_map, _pair, _shape_checks

N = 2 * 256 + 171      # odd: 85 second rays of the last block fall past N
BLOCK, HALF = 256, 128


def _setup(name):
    jc, tc = _pair(name)
    params = params_from_numpy(tc.params, tc.spec, "cpu")
    prog = tp.build_program(tc.spec, "baked")
    table = tp.program_table(prog, params, False)
    ro, rd = probe_rays(40, 24, "cpu")
    ro, rd = (Vec3(*(c[:N].contiguous() for c in v)) for v in (ro, rd))
    return jc, prog, table, ro, rd


def _schedule(interleave):
    """The lists of the kernels' threads: {(block, warp, half): rays} for
    seq, {(block, warp): rays} for fused, rays past N dropped."""
    groups = {}
    for b in range(-(-N // BLOCK)):
        for j in range(HALF):
            for h in (0, 1):
                i = BLOCK * b + HALF * h + j
                if i < N:
                    key = (b, j // 32) if interleave else (b, j // 32, h)
                    groups.setdefault(key, []).append(i)
    return list(groups.values())


@pytest.mark.parametrize("interleave", [False, True], ids=["seq", "fused"])
def test_schedule_lists(interleave):
    """Seq's lists are K3's warps (32 consecutive rays); fused's pair the
    two halves of each warp; ilp_warps labels each ray with its list."""
    groups = _schedule(interleave)
    label = pr.ilp_warps(N, interleave)
    for rays in groups:
        assert len(set(label[rays].tolist())) == 1
    assert len(set(label.tolist())) == len(groups)
    if not interleave:
        assert all(rays == list(range(rays[0], rays[0] + len(rays)))
                   and rays[0] % 32 == 0 for rays in groups)
        assert torch.equal(label, torch.arange(N) // 32)
    else:
        last = [r for r in groups if r[0] >= 2 * BLOCK]
        assert sum(len(r) for r in last) == N - 2 * BLOCK
        assert any(len(r) < 64 for r in last)


@pytest.mark.parametrize("name", SCENES)
def test_walks_match_the_plain_march(name):
    jc, prog, table, ro, rd = _setup(name)
    vals = table.tolist()
    checks, _ = tp.program_bounds(prog, table, ro, rd, False)
    want = pr.march_ilp_plain(prog, table, ro, rd)
    lengths = {}
    for inter in (False, True):
        groups = _schedule(inter)
        lists = tp.warp_records(prog, checks[0], pr.ilp_warps(N, inter))
        lengths["fused" if inter else "seq"] = float(
            lists.sum(1).double().mean())
        t = torch.full_like(ro.x, float("nan"))
        d_walk = torch.empty_like(ro.x)
        i_walk = torch.empty(N, dtype=torch.int32)
        for rays in groups:
            rows = torch.tensor(rays)
            rec = torch.nonzero(lists[pr.ilp_warps(N, inter)[rays[0]]]).flatten()
            walk = tp.make_map_program(prog, vals, records=rec)
            sub = [Vec3(*(c[rows] for c in v)) for v in (ro, rd)]
            wc = take_lanes(checks, rows)
            t[rows], _ = cast_ray(lambda p, c: walk(p, c[0]), *sub, wc)
            d_walk[rows], i_walk[rows] = walk(sub[0] + sub[1] * t[rows], wc[0])
        assert torch.equal(t, want)
        if inter:
            hit = torch.nonzero(~(t > FP)).flatten()
            assert 0 < hit.numel() < N
            jmap = _jax_map(jc, "baked")
            pj = JVec3(*(jnp.asarray(c[hit].numpy()) for c in ro + rd * t))
            dj, ij = jmap(pj, _shape_checks(prog, checks[0][hit]))
            np.testing.assert_allclose(d_walk[hit].numpy(), np.asarray(dj),
                                       rtol=0, atol=1e-5)
            assert np.array_equal(i_walk[hit].numpy(), np.asarray(ij))
    assert pr.ilp_list_lengths(prog, table, ro, rd) == lengths
    # A union list holds each of its halves' lists.
    assert lengths["fused"] >= lengths["seq"] > 0
    # On the CPU the probe is its plain version in both orders.
    for inter in (False, True):
        assert torch.equal(pr.march_ilp(prog, table, ro, rd,
                                        interleave=inter), want)


def test_ilp_smem_bytes_and_oversize():
    """The block's shared memory (4 warps' lists: K3's), and a program a
    block cannot hold raising in the wrapper, naming the sizes, before
    anything reaches a device."""
    _, prog, table, ro, rd = _setup("benchmark_64")
    assert tp.walk_smem_bytes(prog, km.WARPS) == 8816   # 5 x 66 x 16 + 221 x 16
    meta = [Vec3(*(c.to("meta") for c in v)) for v in (ro, rd)]
    big = dataclasses.replace(prog, ops=np.zeros((3000, tp.OP_WIDTH), np.int32))
    for inter in (False, True):
        with pytest.raises(ValueError, match="3000 op records.*more than 232448"):
            pr.march_ilp(big, table.to("meta"), *meta, interleave=inter)
        with pytest.raises(ValueError, match="no kernel for device meta"):
            pr.march_ilp(prog, table.to("meta"), *meta, interleave=inter)
