"""Port parity: the dense march probe over the program staged in shared
memory (kernels/csrc/march_probes.cu:march_dense, csg_program.cuh map_walk
in mode DENSE).

Each block of the kernel stages the decoded op records and the leaf table
once (stage_walk, with no per-warp lists), and every map tap walks the
whole staged program: every shape's leaf is evaluated on every lane, and
the lane's guard selects the fold's result or the accumulator.  Its plain
model is ``make_map_program`` over the full record list, a row of
``warp_records`` with every record marked, whose folds are selected by the
guard.  These tests hold, on ``benchmark_scene(64)`` at a small size,
csg_demo (subtraction), a guard-less cube beside a guard-less lamp and
sphere_and_plane, along the probes' primary rays:

* the exact march over that model to ``march_dense_plain`` (K3's exact
  march) bit for bit, t and ids;
* ``walk_smem_bytes(prog, 0)``, the shared memory the wrapper gives a block
  (the records and the leaf table, no lists), and its error for a program a
  block cannot hold, raised by the wrapper before anything reaches a
  device.

tests/test_torch_probes.py holds ``march_dense_plain`` to the JAX package's
dense probe; chip_smoke.py holds the kernel to its plain version and to
K3's exact march on the card."""

import dataclasses

import numpy as np
import pytest
import torch

from compute_path_tracer_tpu_torch.benchmarks.common import probe_rays
from compute_path_tracer_tpu_torch.kernels import probes as pr
from compute_path_tracer_tpu_torch.render import program as tp
from compute_path_tracer_tpu_torch.render.reference import cast_ray
from compute_path_tracer_tpu_torch.scene import (
    KIND_CUBE, KIND_SPHERE, Scene, Shape, Union, benchmark_scene,
    compile_scene, csg_demo, params_from_numpy, sphere_and_plane)
from compute_path_tracer_tpu_torch.vecmath import Vec3

W, H = 48, 24


def _cube_scene():
    """A guard-less rotated cube beside a guard-less lamp: no guarded
    shape, so every lane evaluates every leaf in both walks."""
    root = Union(name="Root")
    box = root.add_shape(Shape(KIND_CUBE, name="Box"))
    box.size3.set(0.5, 0.4, 0.3)
    box.transform.rotation.set(0.3, 0.5, 0.1)
    box.transform.position.set(0.1, -0.1, 0.4)
    box.transform.aabb = False
    lamp = root.add_shape(Shape(KIND_SPHERE, name="Lamp"))
    lamp.size.set(0.6)
    lamp.transform.position.set(1.2, 1.2, -0.8)
    lamp.material.brightness.set(10.0)
    lamp.transform.aabb = False
    return Scene([root])


SCENES = {"benchmark_64": lambda: benchmark_scene(64), "csg_demo": csg_demo,
          "guardless_cube": _cube_scene, "sphere_and_plane": sphere_and_plane}


def _program(name):
    cs = compile_scene(SCENES[name]())
    params = params_from_numpy(cs.params, cs.spec, "cpu")
    prog = tp.build_program(cs.spec, "baked")
    return prog, tp.program_table(prog, params, True)


def _staged_records(prog, n):
    """The kernel's list: a ``warp_records`` row with every record marked
    (every lane of the warp passes every guard), as record indices."""
    check = torch.ones((n, prog.n_boxed), dtype=torch.bool)
    row = tp.warp_records(prog, check, torch.zeros(n, dtype=torch.long), 1)[0]
    assert bool(row.all())
    return torch.nonzero(row).flatten().tolist()


@pytest.mark.parametrize("name", list(SCENES))
def test_dense_walk_over_staged_program_matches_plain(name):
    prog, table = _program(name)
    ro, rd = probe_rays(W, H, "cpu")
    n = ro.x.shape[0]
    records = _staged_records(prog, n)
    assert records == list(range(prog.ops.shape[0]))
    map_fn = tp.make_map_program(prog, table.tolist(), records=records)
    checks, _ = tp.program_bounds(prog, table, ro, rd, False)
    t, idx = cast_ray(lambda p, c: map_fn(p, c[0]), ro, rd, checks)
    want_t, want_idx = pr.march_dense_plain(prog, table, ro, rd)
    assert torch.equal(t.view(torch.int32), want_t.view(torch.int32))
    assert torch.equal(idx, want_idx)
    hits = float((want_t <= 100.0).float().mean())
    assert 0.02 < hits < 1.0
    if prog.n_boxed:
        # The guards reject shapes on some rays: the selects matter.
        assert not bool(checks[0].all())


def test_dense_smem_bytes():
    """The records (16 bytes each) and the leaf table F[0, f_box) with up to
    3 floats of alignment, in 16-byte units: csg_program.cuh's
    walk_smem_bytes(n_ops, f_box, 0)."""
    for n in (64, 259):
        prog = tp.build_program(compile_scene(benchmark_scene(n)).spec,
                                "baked")
        got = tp.walk_smem_bytes(prog, 0)
        assert got == 16 * prog.ops.shape[0] + 16 * ((prog.f_box + 3 + 3) // 4)
        assert got % 16 == 0 and got <= tp.SMEM_PER_BLOCK
    prog, _ = _program("benchmark_64")
    assert tp.walk_smem_bytes(prog, 0) == 4592  # 66 x 16 + 221 x 16


def test_dense_oversize_program_raises():
    """A program a block cannot hold raises in the wrapper, naming the
    sizes, before anything reaches a device; one that fits reaches the
    device check."""
    prog, _ = _program("benchmark_64")
    rays = Vec3(*(torch.zeros(3, device="meta") for _ in range(3)))
    table = torch.zeros(prog.f_len, device="meta")
    big = dataclasses.replace(prog,
                              ops=np.zeros((15000, tp.OP_WIDTH), np.int32))
    with pytest.raises(ValueError, match="15000 op records.*more than 232448"):
        tp.walk_smem_bytes(big, 0)
    with pytest.raises(ValueError, match="15000 op records"):
        pr.march_dense(big, table, rays, rays)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        pr.march_dense(prog, table, rays, rays)
    before = dict(pr.LAUNCHES)
    ro, rd = probe_rays(8, 4, "cpu")
    prog, table = _program("csg_demo")
    got = pr.march_dense(prog, table, ro, rd)
    want = pr.march_dense_plain(prog, table, ro, rd)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert pr.LAUNCHES == before
