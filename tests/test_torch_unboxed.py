"""Port parity: the marching frame's ``analytic_unboxed`` mode (K2b) against
the JAX package.

``analytic_unboxed`` takes the guard-less shapes of
``analytic_eligible_ids`` out of the baked map (the skip program of
render/program.py) and caps the t-culled march with their closed form
(kernels/megakernel.py:make_analytic_unboxed).  These tests hold, against
JAX on the CPU:

* the eligible ids, on every library scene and on the clobber, cube and
  eligibility-predicate scenes (tests/test_baked.py:240-330);
* the skip program's map to JAX ``make_map_baked(_d)(skip_unboxed=True)``
  on scattered points with random guards, to the 1e-5 of scene distances
  (tests/test_torch_sdf.py), ids equal; with every guard off, JAX's
  union-level "empty" value and the port's fold agree too;
* the closed form to JAX ``_make_analytic_unboxed`` on scattered rays: ids
  equal, t and normals to 1e-5 on well-conditioned hits (near-grazing
  sphere rays excepted, as tests/test_torch_megakernel.py:118-130);
* the 64x32, 2-bounce frame under tests/test_baked.py:186-205's contract
  (under 2 % of pixels off by > 1e-2) against both JAX's oracle and
  ``render_frame_pallas(..., analytic_unboxed=True, interpret=True)``;
* JAX's ``ValueError``s.

The CUDA kernel is held to the plain version on the card by chip_smoke.py.
"""

from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compute_path_tracer_tpu.kernels.megakernel import (
    _make_analytic_unboxed, render_frame_pallas)
from compute_path_tracer_tpu.render import baked as jb
from compute_path_tracer_tpu.render import render_frame as j_render_frame
from compute_path_tracer_tpu.scene import compile_scene as j_compile
from compute_path_tracer_tpu.scene import library as j_lib
from compute_path_tracer_tpu.scene.model import (
    KIND_CUBE, KIND_PLANE, KIND_SPHERE, SUBTRACTION, Scene, Shape, Union)
from compute_path_tracer_tpu.vecmath import Vec3 as JVec3
from compute_path_tracer_tpu_torch.kernels import megakernel as mk
from compute_path_tracer_tpu_torch.render import baked as tb
from compute_path_tracer_tpu_torch.render import program as tp
from compute_path_tracer_tpu_torch.scene import compile_scene as t_compile
from compute_path_tracer_tpu_torch.scene import convert_scene
from compute_path_tracer_tpu_torch.vecmath import Vec3 as TVec3
from test_torch_sdf import clobber_scene

W, H, BOUNCES = 64, 32, 2
UNBOXED = dict(geometry="baked", t_cull=True, analytic_unboxed=True)


def cube_scene():
    """tests/test_baked.py:275's guard-less rotated cube beside a lamp."""
    root = Union(name="Root")
    box = root.add_shape(Shape(KIND_CUBE, name="Box"))
    box.size3.set(0.5, 0.4, 0.3)
    box.transform.rotation.set(0.3, 0.5, 0.1)
    box.transform.position.set(0.1, -0.1, 0.4)
    box.transform.aabb = False
    box.material.color.set(0.7, 0.5, 0.3)
    lamp = root.add_shape(Shape(KIND_SPHERE, name="Lamp"))
    lamp.size.set(0.6)
    lamp.transform.position.set(1.2, 1.2, -0.8)
    lamp.material.color.set(0.0, 0.0, 0.0)
    lamp.material.brightness.set(10.0)
    lamp.material.light_col.set(1.0, 1.0, 1.0)
    lamp.transform.aabb = False
    return Scene([root])


def predicate_scene():
    """tests/test_baked.py:240's eligibility cases: a guard-less shape
    inside a subtraction, a guard-less clobbering first shape, a plane and
    a cube that qualify, a guarded sphere."""
    root = Union(name="Root")
    sub = root.add_union(Union(name="Carved"))
    sub.op = SUBTRACTION
    sub.add_shape(Shape(KIND_SPHERE, name="Body")).transform.aabb = False
    clob = root.add_union(Union(name="Mixed"))
    clob.add_union(Union(name="Child"))
    clob.add_shape(Shape(KIND_SPHERE, name="First")).transform.aabb = False
    env = root.add_union(Union(name="Env"))
    env.add_shape(Shape(KIND_PLANE, name="Ground")).transform.aabb = False
    env.add_shape(Shape(KIND_CUBE, name="Wall")).transform.aabb = False
    env.add_shape(Shape(KIND_SPHERE, name="Guarded"))
    return Scene([root])


SCENES = {"cube": cube_scene, "clobber": clobber_scene,
          "predicate": predicate_scene,
          "benchmark_16": lambda: j_lib.benchmark_scene(16)}
LIBRARY = ["sphere_and_plane", "csg_demo", "blend_demo", "glass_demo",
           "benchmark_scene", "edge_demo"]


@lru_cache(maxsize=None)
def pair(name):
    scene = SCENES[name]() if name in SCENES else getattr(j_lib, name)()
    return j_compile(scene), t_compile(convert_scene(scene))


@pytest.mark.parametrize("name", LIBRARY + list(SCENES))
def test_eligible_ids_match_jax(name):
    jc, tc = pair(name)
    assert tb.analytic_eligible_ids(tc.spec) == jb.analytic_eligible_ids(jc.spec)
    if name == "predicate":
        assert tb.analytic_eligible_ids(tc.spec) == frozenset({2, 3})
    # The skip program lists them as caps, in walk order.
    prog = tp.build_program(tc.spec, "baked", True)
    want = [(bs.kind, bs.off, bs.shape_id) for bs in tb.baked_shapes_in_order(
        tc.spec) if bs.shape_id in tb.analytic_eligible_ids(tc.spec)]
    assert [tuple(c) for c in prog.caps.tolist()] == want
    full = tp.build_program(tc.spec, "baked")
    assert (prog.n_boxed, prog.f_len) == (full.n_boxed, full.f_len)


def _points(n, seed):
    return np.random.default_rng(seed).uniform(-4, 4, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("guards", ["random", "off"])
@pytest.mark.parametrize("name", ["csg_demo", "benchmark_16", "clobber",
                                  "predicate", "cube"])
def test_skip_map_matches_jax(name, guards):
    """The skip program's map against JAX's skip_unboxed maps: random
    per-point guards, or every guard off, where JAX takes a union's
    "empty" value (baked.py:_union_cull_pred with the skipped ids)."""
    jc, tc = pair(name)
    pts = _points(512, 5)
    pv = torch.from_numpy(tc.params)
    bv_t = tb.bake(tc.spec, pv)
    bv_j = jb.bake(jc.spec, jnp.asarray(jc.params))
    boxed = [bs.shape_id for bs in tb.boxed_shapes(tc.spec)]
    rng = np.random.default_rng(7)
    guard = (rng.random((len(pts), len(boxed))) < 0.5 if guards == "random"
             else np.zeros((len(pts), len(boxed)), bool))
    checks = [None] * jc.spec.n_shapes
    for j, sid in enumerate(boxed):
        checks[sid] = jnp.asarray(guard[:, j])
    anyhit = None
    if guards == "off":
        anyhit = tuple(None if c is None else jnp.asarray(False)
                       for c in checks)
    jp = JVec3(*(jnp.asarray(pts[:, i]) for i in range(3)))
    d_j = np.asarray(jb.make_map_baked_d(jc.spec, skip_unboxed=True)(
        jp, bv_j, tuple(checks), anyhit))
    _, i_j = jb.make_map_baked(jc.spec, skip_unboxed=True)(jp, bv_j,
                                                           tuple(checks))
    prog = tp.build_program(tc.spec, "baked", True)
    table = tp.program_table(prog, pv)
    d_t, i_t = tp.make_map_program(prog, table.tolist())(
        TVec3(*(torch.from_numpy(np.ascontiguousarray(pts[:, i]))
                for i in range(3))), torch.from_numpy(guard))
    np.testing.assert_allclose(d_t.numpy(), d_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    assert float(np.abs(bv_t.numpy() - np.asarray(bv_j)).max()) < 1e-4


def _rays(n, seed):
    r = np.random.default_rng(seed)
    ro = r.uniform(-4, 4, (n, 3)).astype(np.float32)
    rd = r.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, rd


@pytest.mark.parametrize("name", ["benchmark_16", "csg_demo", "cube",
                                  "predicate"])
def test_closed_form_matches_jax(name):
    """cap_fn, normal_fn and closest_fn against JAX on scattered rays; both
    read the same baked vector."""
    jc, tc = pair(name)
    bv = np.asarray(jb.bake(jc.spec, jnp.asarray(jc.params)))
    ro, rd = _rays(4096, 9)
    j3 = [JVec3(*(jnp.asarray(a[:, i]) for i in range(3))) for a in (ro, rd)]
    t3 = [TVec3(*(torch.from_numpy(np.ascontiguousarray(a[:, i]))
                  for i in range(3))) for a in (ro, rd)]
    j_cap, j_normal, j_closest = _make_analytic_unboxed(jc.spec)
    t_cap, t_normal, t_closest = mk.make_analytic_unboxed(tc.spec)
    bv_t = torch.from_numpy(bv)
    tj, ij = map(np.asarray, j_cap(*j3, jnp.asarray(bv)))
    tt, it = (x.numpy() for x in t_cap(*t3, bv_t))
    np.testing.assert_array_equal(it, ij)
    hit = ij >= 0
    assert hit.any() and (~hit).any()
    assert (tt[~hit] == tj[~hit]).all()
    # Well-conditioned hits: XLA contracts multiply-adds where b*b - c
    # cancels on near-grazing sphere rays; the port rounds each operation.
    kinds = {bs.shape_id: bs for bs in tb.baked_shapes_in_order(tc.spec)}
    clean = hit.copy()
    for k in np.nonzero(hit)[0]:
        bs = kinds[int(ij[k])]
        if bs.kind == KIND_SPHERE:
            c, r = bv[bs.off:bs.off + 3].astype(np.float64), bv[bs.off + 3]
            oc = ro[k].astype(np.float64) - c
            b = oc @ rd[k]
            clean[k] = b * b - (oc @ oc - r * r) > 1e-2 * b * b
    assert clean.mean() > 0.5 * hit.mean()
    np.testing.assert_allclose(tt[clean], tj[clean], rtol=1e-5, atol=1e-5)
    p = ro + rd * np.where(hit, tj, 0.0)[:, None]
    nj = j_normal(JVec3(*(jnp.asarray(p[:, i]) for i in range(3))),
                  jnp.asarray(ij), jnp.asarray(bv))
    nt = t_normal(TVec3(*(torch.from_numpy(np.ascontiguousarray(p[:, i]))
                          for i in range(3))), torch.from_numpy(ij.copy()), bv_t)
    for a, b in zip(nj, nt):
        np.testing.assert_allclose(b.numpy()[clean], np.asarray(a)[clean],
                                   rtol=0, atol=1e-5)
    dj, tcj, icj = map(np.asarray, j_closest(*j3, jnp.asarray(bv)))
    dt, tct, ict = (x.numpy() for x in t_closest(*t3, bv_t))
    np.testing.assert_array_equal(ict, icj)
    np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tct, tcj, rtol=1e-5, atol=1e-5)


def _share_off(a, b):
    assert np.isfinite(a).all() and np.isfinite(b).all()
    return float((np.abs(a - b).max(axis=-1) > 1e-2).mean())


@pytest.mark.parametrize("name", ["benchmark_16", "csg_demo", "cube"])
def test_frame_matches_jax(name):
    """The plain frame against JAX's oracle (which has no cap: the
    contract's divergence classes) and against the Pallas kernel in
    interpret mode with the same cap."""
    jc, tc = pair(name)
    kw = dict(width=W, height=H, bounces=BOUNCES, debug=0, frame=2,
              last_clear=0)
    before = dict(mk.LAUNCHES)
    port = mk.render_frame_megakernel(tc.spec, torch.from_numpy(tc.params),
                                      **UNBOXED, **kw).numpy()
    assert mk.LAUNCHES == before  # CPU tensors never reach the kernels
    oracle = np.asarray(j_render_frame(jc.spec, jnp.asarray(jc.params),
                                       geometry="baked", **kw))
    pallas = np.asarray(render_frame_pallas(
        jc.spec, jnp.asarray(jc.params), interpret=True, tile=(32, 128),
        **UNBOXED, **kw))
    assert _share_off(port, oracle) < 0.02
    assert _share_off(port, pallas) < 0.02


def test_empty_eligible_set_is_a_no_op():
    """A scene without eligible shapes renders as without the flag."""
    _, tc = pair("edge_demo")
    assert not tb.analytic_eligible_ids(tc.spec)
    pv = torch.from_numpy(tc.params)
    kw = dict(width=16, height=8, bounces=1, geometry="baked", t_cull=True)
    a = mk.render_frame_megakernel(tc.spec, pv, analytic_unboxed=True, **kw)
    b = mk.render_frame_megakernel(tc.spec, pv, **kw)
    assert torch.equal(a, b)


@pytest.mark.parametrize("kw", [
    dict(geometry="faithful", t_cull=True, analytic_unboxed=True),
    dict(geometry="baked", t_cull=False, analytic_unboxed=True),
    dict(geometry="baked", t_cull=True, analytic_unboxed=True, debug=1),
    dict(geometry="baked", t_cull=True, analytic_unboxed=True, debug=2),
    dict(geometry="baked", analytic_all=True, analytic_unboxed=True),
], ids=str)
def test_rejections_match_jax(kw):
    jc, tc = pair("sphere_and_plane")
    args = dict(width=16, height=8, bounces=0, **kw)
    with pytest.raises(ValueError):
        render_frame_pallas(jc.spec, jnp.asarray(jc.params), interpret=True,
                            **args)
    with pytest.raises(ValueError):
        mk.render_frame_megakernel(tc.spec, torch.from_numpy(tc.params),
                                   **args)
