"""Port parity: SDFs, the rotation and the CSG combines (ops/sdf.py), the
per-scene map and bounds closures (render/scenegen.py, render/baked.py) and
the packed CSG program the marching kernel interprets (render/program.py),
against the JAX package on points and rays made from numpy seeds.

Tolerances: the elementwise ops agree to 1e-6 (float32 trig and XLA's
contracted multiply-adds move the last bits); scene distances to 1e-5, the
JAX package's own faithful-versus-baked contract (tests/test_baked.py:74);
the program's map is the port oracle's map to float rounding (bit-equal but
for torch's batched cos/sin); AABB checks are equal and the debug tint agrees
to 1e-6."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compute_path_tracer_tpu.ops import sdf as jsdf
from compute_path_tracer_tpu.render import baked as jb
from compute_path_tracer_tpu.render import scenegen as jsg
from compute_path_tracer_tpu.scene import compile_scene as j_compile
from compute_path_tracer_tpu.scene import library as j_lib
from compute_path_tracer_tpu.scene import load_scene as j_load
from compute_path_tracer_tpu.scene.model import KIND_SPHERE as J_SPHERE
from compute_path_tracer_tpu.scene.model import Scene as JScene
from compute_path_tracer_tpu.scene.model import Shape as JShape
from compute_path_tracer_tpu.scene.model import Union as JUnion
from compute_path_tracer_tpu.vecmath import Vec3 as JVec3
from compute_path_tracer_tpu_torch.ops import sdf as tsdf
from compute_path_tracer_tpu_torch.render import baked as tb
from compute_path_tracer_tpu_torch.render import program as tp
from compute_path_tracer_tpu_torch.render import scenegen as tsg
from compute_path_tracer_tpu_torch.scene import compile_scene as t_compile
from compute_path_tracer_tpu_torch.scene import convert_scene
from compute_path_tracer_tpu_torch.scene import load_scene as t_load
from compute_path_tracer_tpu_torch.vecmath import Vec3 as TVec3

MAP_CSG = os.path.join(os.path.dirname(__file__), "..", "data", "maps",
                       "csg_demo.json")
SCENES = ["sphere_and_plane", "csg_demo", "blend_demo", "glass_demo",
          "benchmark_16", "clobber", "map_csg_demo"]


def clobber_scene():
    """A guarded first shape beside a child union: while its AABB check
    passes it clobbers the child union's shapes (containers.rs:244-252)."""
    root = JUnion(name="R")
    child = JUnion(name="C")
    inner = child.add_shape(JShape(J_SPHERE, name="inner"))
    inner.transform.aabb = False
    inner.size.set(0.8)
    root.add_union(child)
    first = root.add_shape(JShape(J_SPHERE, name="first"))
    first.transform.position.set(0.5, 0.0, 0.0)
    return JScene([root])


def pair(name):
    """The scene compiled by both packages (JSON maps loaded by each
    package's scene/io.py; built scenes carried across by JSON)."""
    if name == "map_csg_demo":
        return j_compile(j_load(MAP_CSG)), t_compile(t_load(MAP_CSG))
    if name == "clobber":
        scene = clobber_scene()
    elif name == "benchmark_16":
        scene = j_lib.benchmark_scene(16)
    else:
        scene = getattr(j_lib, name)()
    return j_compile(scene), t_compile(convert_scene(scene))


def _pts(n, seed, lo=-3.0, hi=3.0):
    return np.random.default_rng(seed).uniform(lo, hi, (n, 3)).astype(np.float32)


def _j3(a):
    return JVec3(*(jnp.asarray(a[:, i]) for i in range(3)))


def _t3(a):
    return TVec3(*(torch.from_numpy(np.ascontiguousarray(a[:, i]))
                   for i in range(3)))


def _np(v):
    return np.stack([np.asarray(c) for c in v], axis=-1)


# -- elementwise ops ------------------------------------------------------------

_SIZES = np.random.default_rng(1).uniform(0.2, 1.2, 3).astype(np.float32)


@pytest.mark.parametrize("fn", ["sd_sphere", "sd_cube", "sd_plane",
                                "sd_octahedron"])
def test_sdf_matches_jax(fn):
    p = _pts(4096, 2)
    p[:8] = 0.0  # the 0-vector branch of length_safe
    r, b = float(_SIZES[0]), _SIZES
    args_j = {"sd_sphere": (r,), "sd_cube": (JVec3(*map(jnp.float32, b)),),
              "sd_plane": (), "sd_octahedron": (r,)}[fn]
    args_t = {"sd_sphere": (r,), "sd_cube": (TVec3(*map(float, b)),),
              "sd_plane": (), "sd_octahedron": (r,)}[fn]
    a = np.asarray(getattr(jsdf, fn)(_j3(p), *args_j))
    t = getattr(tsdf, fn)(_t3(p), *args_t)
    assert t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), a, rtol=0, atol=1e-6)


def test_rot3d_matches_jax():
    p = _pts(4096, 3)
    rot = np.random.default_rng(4).uniform(-3.2, 3.2, (4096, 3)).astype(np.float32)
    a = _np(jsdf.rot3d(_j3(p), _j3(rot)))
    t = _np(tsdf.rot3d(_t3(p), _t3(rot)))
    np.testing.assert_allclose(t, a, rtol=0, atol=1e-6)


@pytest.mark.parametrize("op", [0, 1, 2])
@pytest.mark.parametrize("index", [0, 1])
def test_combine_matches_jax(op, index):
    r = np.random.default_rng(5 + op)
    d1, d2 = (r.normal(0, 1, 4096).astype(np.float32) for _ in range(2))
    d2[:64] = d1[:64]  # ties: the keep rules
    d2[64:128] = -d1[64:128]
    i1, i2 = (r.integers(-1, 9, 4096).astype(np.int32) for _ in range(2))
    k = np.float32(0.35)
    if op == 2:
        # The JAX package folds the smooth union in scenegen._combine.
        dj, ij = jsg._combine(op, jnp.asarray(d1), jnp.asarray(i1),
                              jnp.asarray(d2), jnp.asarray(i2), index, k)
    else:
        dj, ij = jsdf.combine(op, jnp.asarray(d1), jnp.asarray(i1),
                              jnp.asarray(d2), jnp.asarray(i2), index)
    dt, it = tsdf.combine(op, torch.from_numpy(d1), torch.from_numpy(i1),
                          torch.from_numpy(d2), torch.from_numpy(i2), index,
                          float(k))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=1e-6)
    assert np.array_equal(it.numpy(), np.asarray(ij))


# -- scene maps and bounds --------------------------------------------------------


def _checks(spec, n, seed, dense):
    """Per-shape guards: all passing, or a seeded random half."""
    r = np.random.default_rng(seed)
    out = []
    for _ in range(spec.n_shapes):
        out.append(np.ones(n, bool) if dense else r.random(n) < 0.5)
    return out


@pytest.mark.parametrize("dense", [True, False], ids=["all", "random"])
@pytest.mark.parametrize("name", SCENES)
def test_maps_match_jax(name, dense):
    """Faithful and baked maps against JAX, and the packed program against
    the port's own closures, under the same guards."""
    jc, tc = pair(name)
    n = 2048
    p = _pts(n, 6)
    g = _checks(tc.spec, n, 7, dense)
    cj = tuple(jnp.asarray(c) for c in g)
    ct = tuple(torch.from_numpy(c) for c in g)
    pv_j, pv_t = jnp.asarray(jc.params), torch.from_numpy(tc.params)
    bv_j, bv_t = jb.bake(jc.spec, pv_j), tb.bake(tc.spec, pv_t)
    maps = {
        "faithful": (jsg.make_map(jc.spec)(_j3(p), pv_j, cj),
                     tsg.make_map(tc.spec)(_t3(p), pv_t, ct)),
        "baked": (jb.make_map_baked(jc.spec)(_j3(p), bv_j, cj),
                  tb.make_map_baked(tc.spec)(_t3(p), bv_t, ct)),
    }
    for geometry, ((dj, ij), (dt, it)) in maps.items():
        dj, ij = np.asarray(dj), np.asarray(ij)
        np.testing.assert_allclose(dt.numpy(), dj, rtol=0, atol=1e-5,
                                   err_msg=geometry)
        assert np.array_equal(it.numpy(), ij), geometry

        prog = tp.build_program(tc.spec, geometry)
        table = tp.program_table(prog, pv_t)
        guard = torch.stack([ct[sid] for sid in _boxed_ids(prog)], dim=1) \
            if prog.n_boxed else torch.zeros((n, 0), dtype=torch.bool)
        dp, ip = tp.make_map_program(prog, table.tolist())(_t3(p), guard)
        np.testing.assert_allclose(dp.numpy(), dt.numpy(), rtol=0, atol=1e-6,
                                   err_msg=geometry)
        assert np.array_equal(ip.numpy(), it.numpy()), geometry


def _boxed_ids(prog):
    """Shape id of each guard column, in the program's box order."""
    ops = prog.ops
    rows = ops[(ops[:, 0] == tp.OPC_SHAPE) & (ops[:, 3] >= 0)]
    return [int(sid) for _, sid in sorted(zip(rows[:, 3], rows[:, 4]))]


def _rays(n, seed):
    r = np.random.default_rng(seed)
    ro = r.uniform(-5, 5, (n, 3)).astype(np.float32)
    rd = r.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, rd


@pytest.mark.parametrize("name", SCENES)
def test_bounds_match_jax(name):
    """Checks, slab intervals and the debug tint of both geometries, and
    the program's guards (its boxes come from the same trails)."""
    jc, tc = pair(name)
    ro, rd = _rays(2048, 8)
    pv_j, pv_t = jnp.asarray(jc.params), torch.from_numpy(tc.params)
    bv_j, bv_t = jb.bake(jc.spec, pv_j), tb.bake(tc.spec, pv_t)
    pairs = {
        "faithful": (jsg.make_bounds(jc.spec, with_t=True)(_j3(ro), _j3(rd), pv_j),
                     tsg.make_bounds(tc.spec, with_t=True)(_t3(ro), _t3(rd), pv_t)),
        "baked": (jb.make_bounds_baked(jc.spec, with_t=True)(_j3(ro), _j3(rd), bv_j),
                  tb.make_bounds_baked(tc.spec, with_t=True)(_t3(ro), _t3(rd), bv_t)),
    }
    for geometry, ((cj, tnj, tfj, dj), (ct, tnt, tft, dt)) in pairs.items():
        assert len(cj) == len(ct) == tc.spec.n_shapes
        for a, b, na, nb, fa, fb in zip(cj, ct, tnj, tnt, tfj, tft):
            assert (a is None) == (b is None)
            if a is not None:
                assert np.array_equal(b.numpy(), np.asarray(a)), geometry
                hit = np.asarray(a)
                np.testing.assert_allclose(nb.numpy()[hit], np.asarray(na)[hit],
                                           rtol=1e-6, atol=1e-6)
                np.testing.assert_allclose(fb.numpy()[hit], np.asarray(fa)[hit],
                                           rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=1e-6)

        prog = tp.build_program(tc.spec, geometry)
        (chk,), dbg = tp.program_bounds(prog, tp.program_table(prog, pv_t),
                                        _t3(ro), _t3(rd), False)
        for col, sid in enumerate(_boxed_ids(prog)):
            assert torch.equal(chk[:, col], ct[sid]), geometry
        assert torch.equal(dbg, dt), geometry


def test_program_layout():
    """Op records, guard boxes and the t-cull rule on csg_demo: the carved
    union's shapes are folded by a subtraction, so t-culling must keep
    them; the cluster's are min-folded and may leave the map."""
    _, tc = pair("csg_demo")
    prog = tp.build_program(tc.spec, "baked")
    ops = prog.ops
    assert ops.shape[1] == tp.OP_WIDTH
    assert (ops[:, 0] == tp.OPC_SHAPE).sum() == tc.spec.n_shapes
    assert (ops[:, 0] == tp.OPC_ENTER).sum() == (ops[:, 0] == tp.OPC_LEAVE).sum()
    assert prog.depth == 2 and prog.n_boxed == 4
    assert prog.box_cull.tolist() == [0, 0, 1, 1]
    shapes = ops[ops[:, 0] == tp.OPC_SHAPE]
    assert shapes[:, 5].tolist()[:2] == [tp.FOLD_ASSIGN, 1]  # bite, block
    code = tp.program_code_on(prog, "cpu")
    assert code.dtype == torch.int32
    # ops, box_cull, caps (none without skip_unboxed), a cap count a LEAVE
    n_leave = int((ops[:, 0] == tp.OPC_LEAVE).sum())
    assert prog.caps.size == 0 and prog.cap_leave.tolist() == [0] * n_leave
    assert code.numel() == ops.size + prog.n_boxed + n_leave
