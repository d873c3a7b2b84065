"""Port parity: the closest-approach march of the autograd path's edge
estimators (diff/vjp.py: ``_march_closest``, ``ClosestApproach``) against
the JAX package's ``_march_closest`` and ``make_closest_approach``.

Forward, on primary rays of three scenes (faithful and baked) and on
secondary rays of benchmark_scene(16) built as
tests/test_torch_excl_closest.py builds them (reflected about their 6-tap
normal, respawned OFFSET along it, each excluding its own hit and, below
0.3, its respawn surface, stopped at its own hit distance).  Tolerances,
with their reasons:

* ``i_min`` equal on every ray: no ray has two best taps within the
  tolerance below (the count of such ties is 0 in every case);
* on the rays within 0.1 of a silhouette (JAX d_min >= -0.1, where the
  estimator's coverage moves), d_min and d2 within 2e-5 absolute and
  t_min, t2 within 2e-5 absolute or 1e-5 relative, whichever is larger: XLA contracts the march's multiply-adds,
  which the port rounds one operation at a time (ROADMAP queue 3), so each
  tap's point moves by about an ulp of t and t drifts by a few ulps over
  the taps (measured: 1.25e-5 in d, 5.6e-6 relative in t, at t up to
  6.4);
* on every ray, d_min and d2 within 1e-4 absolute and t_min, t2 within
  3e-5 relative.  The rays past 2e-5 are deep inside a shape (measured: d
  <= -0.15 on each, up to 6.5e-5 in d and 2.4e-5 relative in t), where the
  along-ray valley is flat and its argmin t ill-conditioned.

Backward: the Danskin gradient of sum(w d_min) in the params and the six
ray components, without and with the two-valley blend, against
``jax.grad`` on tests/test_edge.py:238's rotated-cube corner column and,
with both exclusions, the stop distance and the blend, on the reflected
rays of tests/test_edge.py:159's occluder scene, within
1e-4 of the largest JAX entry (autograd sums in another order than XLA,
which also contracts); and the port's own copy of that test's check that
the blended gradient at the corner row tracks the finite difference of
d_min within 30 %.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compute_path_tracer_tpu.diff import vjp as jv
from compute_path_tracer_tpu.render.baked import bake as j_bake
from compute_path_tracer_tpu.render.baked import make_bounds_baked as j_bounds_b
from compute_path_tracer_tpu.render.baked import make_map_baked as j_map_b
from compute_path_tracer_tpu.render.scenegen import make_bounds as j_bounds
from compute_path_tracer_tpu.render.scenegen import make_map as j_map
from compute_path_tracer_tpu.scene import compile_scene as j_compile
from compute_path_tracer_tpu.scene import library as j_lib
from compute_path_tracer_tpu.vecmath import Vec3 as JVec3
from compute_path_tracer_tpu_torch.constants import DEFAULT_FOV, FP, OFFSET
from compute_path_tracer_tpu_torch.diff import vjp as tv
from compute_path_tracer_tpu_torch.ops.camera import calc_uv, primary_ray
from compute_path_tracer_tpu_torch.render.baked import (
    bake,
    make_bounds_baked,
    make_map_baked,
)
from compute_path_tracer_tpu_torch.render.reference import (
    calc_normal,
    camera_rays,
    cast_ray,
)
from compute_path_tracer_tpu_torch.render.scenegen import make_bounds, make_map
from compute_path_tracer_tpu_torch.scene import KIND_CUBE, Scene, Shape, Union
from compute_path_tracer_tpu_torch.scene import compile_scene as t_compile
from compute_path_tracer_tpu_torch.scene import convert_scene
from compute_path_tracer_tpu_torch.vecmath import Vec3, reflect

W, H = 32, 24
BAND = -0.1
D_TOL = 2e-5
D_ALL, T_REL, T_BAND = 1e-4, 3e-5, 1e-5
GRAD_TOL = 1e-4
NAMES = ("d_min", "t_min", "i_min", "d2", "t2")


_SCENES = {"bench16": lambda: j_lib.benchmark_scene(16)}


def _scene(name):
    scene = _SCENES[name]() if name in _SCENES else getattr(j_lib, name)()
    return j_compile(scene), t_compile(convert_scene(scene))


def _maps(jc, tc, geometry):
    """(port map, port bounds, port vector, JAX map, JAX bounds, JAX
    vector) of the geometry."""
    pt = torch.from_numpy(tc.params.copy())
    pj = jnp.asarray(jc.params)
    if geometry == "baked":
        return (make_map_baked(tc.spec), make_bounds_baked(tc.spec),
                bake(tc.spec, pt), j_map_b(jc.spec), j_bounds_b(jc.spec),
                j_bake(jc.spec, pj))
    return (make_map(tc.spec), make_bounds(tc.spec), pt, j_map(jc.spec),
            j_bounds(jc.spec), pj)


def _jvec(v):
    return JVec3(*(jnp.asarray(c.numpy()) for c in v))


def _compare(port, ref):
    """Asserts the module docstring's tolerances; returns the count of
    rays whose i_min differs."""
    port = [c.numpy() for c in port]
    ref = [np.asarray(c) for c in ref]
    band = ref[0] >= BAND
    assert band.any()
    for k in (0, 3):
        err = np.abs(port[k] - ref[k])
        assert err.max() <= D_ALL, (NAMES[k], err.max())
        assert err[band].max() <= D_TOL, (NAMES[k], err[band].max())
    for k in (1, 4):
        err = np.abs(port[k] - ref[k])
        assert (err <= T_REL * np.abs(ref[k]) + D_TOL).all(), NAMES[k]
        assert (err[band] <= np.maximum(D_TOL, T_BAND * np.abs(
            ref[k][band]))).all(), NAMES[k]
    return int((port[2] != ref[2]).sum())


@pytest.mark.parametrize("name,geometry", [
    ("sphere_and_plane", "faithful"), ("csg_demo", "baked"),
    ("bench16", "faithful"), ("bench16", "baked")])
def test_primary_rays_match_jax(name, geometry):
    jc, tc = _scene(name)
    tmap, tbounds, tgv, jmap, jbounds, jgv = _maps(jc, tc, geometry)
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.int32),
                            torch.arange(W, dtype=torch.int32), indexing="ij")
    _, ro, rd = camera_rays(xs, ys, 0, 1.0, W / H, width=W, height=H)
    checks = tbounds(ro, rd, tgv)[0]
    port = tv._march_closest(lambda p, c: tmap(p, tgv, c), ro, rd, checks)

    @jax.jit
    def ref(gv, o, d):
        return jv._march_closest(jmap, o, d, gv, jbounds(o, d, gv)[0])

    assert _compare(port, ref(jgv, _jvec(ro), _jvec(rd))) == 0


def _secondary_rays(name, geometry, width, height, fov):
    """The reflected rays of the scene's primary hits (respawned OFFSET
    along the 6-tap normal, as a specular bounce is), with their guards,
    the two ids each excludes and its stop distance."""
    jc, tc = _scene(name)
    tmap, tbounds, tgv, jmap, jbounds, jgv = _maps(jc, tc, geometry)

    def mapc(p, c):
        return tmap(p, tgv, c)

    ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.int32),
                            torch.arange(width, dtype=torch.int32),
                            indexing="ij")
    _, ro, rd = camera_rays(xs, ys, 0, fov, width / height, width=width,
                            height=height)
    chk0 = tbounds(ro, rd, tgv)[0]
    t0, id0 = cast_ray(mapc, ro, rd, chk0)
    hit = ~(t0 > FP)
    ro, rd, t0, id0 = (Vec3(*(c[hit] for c in ro)),
                       Vec3(*(c[hit] for c in rd)), t0[hit], id0[hit])
    hp = ro + rd * t0
    n = calc_normal(mapc, hp, tuple(None if c is None else c[hit]
                                    for c in chk0))
    ro2, rd2 = hp + n * OFFSET, reflect(rd, n).normalize_safe()
    chk2 = tbounds(ro2, rd2, tgv)[0]
    t2, id2 = cast_ray(mapc, ro2, rd2, chk2)
    return (jc, tc, tmap, tgv, ro2, rd2, chk2, (id2, id0), t2, jmap, jbounds,
            jgv)


@pytest.fixture(scope="module")
def secondary():
    """benchmark_scene(16)'s secondary rays at 64x32, baked
    (tests/test_torch_excl_closest.py's construction)."""
    return _secondary_rays("bench16", "baked", 64, 32, 1.0)


def test_secondary_rays_with_exclusions_match_jax(secondary):
    _, _, tmap, tgv, ro, rd, checks, excl, t_stop, jmap, jbounds, jgv = \
        secondary
    assert ro.x.shape[0] > 500

    def mapc(p, c):
        return tmap(p, tgv, c)

    port = tv._march_closest(mapc, ro, rd, checks, excl,
                             (None, tv.EDGE_T_SELF), t_stop)

    @jax.jit
    def ref(gv, o, d, e0, e1, ts):
        return jv._march_closest(jmap, o, d, gv, jbounds(o, d, gv)[0],
                                 (e0, e1), (None, jv._EDGE_T_SELF), ts)

    out = ref(jgv, _jvec(ro), _jvec(rd), *(jnp.asarray(e.numpy())
                                          for e in excl),
              jnp.asarray(t_stop.numpy()))
    assert _compare(port, out) == 0
    # The exclusions and the stop matter on these rays.
    free = tv._march_closest(mapc, ro, rd, checks)
    assert (free[2] != port[2]).any()


def test_secondary_danskin_backward_matches_jax_grad():
    """The secondary estimator's closest approach (both exclusions, the stop
    distance, the blend at edge_beta2's footprint) differentiated in the
    params and the six ray components, on the reflected rays of
    tests/test_edge.py:159's occluder scene (faithful geometry, 32x32, fov
    3)."""
    from test_edge import _occluder_scene

    _SCENES["occluder"] = _occluder_scene
    jc, tc, tmap, _, ro, rd, checks, excl, t_stop, jmap, jbounds, _ = \
        _secondary_rays("occluder", "faithful", 32, 32, 3.0)
    tie = 2.0 * 2.0 / (32 * 3.0)
    w = (1.0 + np.arange(ro.x.shape[0]) % 3).astype(np.float32)
    p = torch.from_numpy(tc.params.copy()).requires_grad_()
    rays = [c.clone().requires_grad_() for c in (*ro, *rd)]
    d_b, _, i_b = tv.make_closest_approach(tmap, (None, tv.EDGE_T_SELF))(
        Vec3(*rays[:3]), Vec3(*rays[3:]), p, checks, excl, t_stop=t_stop,
        tie_scale=tie)
    assert (i_b >= 0).any()
    (d_b * torch.from_numpy(w)).sum().backward()
    got = np.concatenate([p.grad.numpy()] + [r.grad.numpy() for r in rays])
    closest = jv.make_closest_approach(jmap, excl_tmax=(None, jv._EDGE_T_SELF))
    e0, e1 = (jnp.asarray(e.numpy()) for e in excl)
    ts = jnp.asarray(t_stop.numpy())

    def loss(pv, ox, oy, oz, dx, dy, dz):
        o, d = JVec3(ox, oy, oz), JVec3(dx, dy, dz)
        d1, _, _ = closest(o, d, pv, jbounds(o, d, pv)[0], (e0, e1),
                           t_stop=ts, tie_scale=tie)
        return jnp.sum(d1 * jnp.asarray(w))

    args = [jnp.asarray(jc.params)] + [jnp.asarray(c.numpy())
                                       for c in (*ro, *rd)]
    want = np.concatenate([np.asarray(g) for g in jax.jit(
        jax.grad(loss, argnums=tuple(range(7))))(*args)])
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_TOL * scale)


def _corner():
    """tests/test_edge.py:238's rotated cube (rz = 0.4) and the primary rays
    of its column 40 at 64x64."""
    root = Union(name="Root")
    box = root.add_shape(Shape(KIND_CUBE, name="Box"))
    box.size3.set(0.55, 0.35, 0.55)
    box.material.brightness.set(2.0)
    box.material.light_col.set(1.0, 1.0, 1.0)
    scene = Scene([root])
    jc = j_compile(scene)
    tc = t_compile(scene)
    slot = tc.spec.roots[0].children_shapes[0].transform.rot[2]
    base = np.asarray(tc.params, np.float32).copy()
    base[slot] = 0.4
    res = 64
    ys = torch.arange(res, dtype=torch.float32)
    xs = torch.full((res,), 40.0)
    u, v = calc_uv(xs, ys, res, res, 1.0)
    ro, rd = primary_ray(u, v, DEFAULT_FOV)
    return jc, tc, base, slot, res, ro, rd


@pytest.fixture(scope="module")
def corner():
    return _corner()


def _port_grad(tc, base, ro, rd, w, tie):
    map_fn, bounds = make_map(tc.spec), make_bounds(tc.spec)
    p = torch.from_numpy(base.copy()).requires_grad_()
    rays = [c.clone().requires_grad_() for c in (*ro, *rd)]
    checks = bounds(Vec3(*ro), Vec3(*rd), p.detach())[0]
    d1, _, _ = tv.make_closest_approach(map_fn)(
        Vec3(*rays[:3]), Vec3(*rays[3:]), p, checks, tie_scale=tie)
    (d1 * torch.from_numpy(w)).sum().backward()
    return np.concatenate([p.grad.numpy()] + [r.grad.numpy() for r in rays])


@pytest.mark.parametrize("blend", [False, True])
def test_danskin_backward_matches_jax_grad(corner, blend):
    jc, tc, base, _, res, ro, rd = corner
    tie = 2.0 * 0.5 / (res * DEFAULT_FOV) if blend else None
    w = (1.0 + np.arange(res) % 3).astype(np.float32)
    got = _port_grad(tc, base, ro, rd, w, tie)
    jmap, jbounds = j_map(jc.spec), j_bounds(jc.spec)
    closest = jv.make_closest_approach(jmap)

    def loss(pv, ox, oy, oz, dx, dy, dz):
        o, d = JVec3(ox, oy, oz), JVec3(dx, dy, dz)
        checks, _ = jbounds(o, d, pv)
        d1, _, _ = closest(o, d, pv, checks, tie_scale=tie)
        return jnp.sum(d1 * jnp.asarray(w))

    args = [jnp.asarray(base)] + [jnp.asarray(c.numpy()) for c in (*ro, *rd)]
    want = np.concatenate([np.asarray(g) for g in jax.jit(
        jax.grad(loss, argnums=tuple(range(7))))(*args)])
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_TOL * scale)


def test_blend_on_the_corner_row_tracks_finite_difference(corner):
    """tests/test_edge.py:238's check in the port: at the corner row the
    blended Danskin gradient of d_min in the rotation is within 30 % of its
    central finite difference, and on the rows whose second slot is empty
    the blend leaves the single-argmin gradient as it was."""
    _, tc, base, slot, res, ro, rd = corner
    map_fn, bounds = make_map(tc.spec), make_bounds(tc.spec)
    tie = 2.0 * 0.5 / (res * DEFAULT_FOV)
    row = 32
    cot = np.zeros(res, np.float32)
    cot[row] = 1.0

    def d_row(pv, tie_scale, rows=cot):
        checks = bounds(ro, rd, pv.detach())[0]
        d1, _, _ = tv.make_closest_approach(map_fn)(ro, rd, pv, checks,
                                                    tie_scale=tie_scale)
        return (d1 * torch.from_numpy(rows)).sum()

    p = torch.from_numpy(base.copy()).requires_grad_()
    d_row(p, tie).backward()
    g = float(p.grad[slot])
    eps = 0.01
    bp, bm = base.copy(), base.copy()
    bp[slot] += eps
    bm[slot] -= eps
    with torch.no_grad():
        fd = (float(d_row(torch.from_numpy(bp), tie))
              - float(d_row(torch.from_numpy(bm), tie))) / (2 * eps)
    assert np.sign(g) == np.sign(fd)
    assert abs(g - fd) <= 0.3 * abs(fd), (g, fd)

    # Rows whose slot 2 is empty (d2 = 1e9) get w2 = 0 exactly.
    checks = bounds(ro, rd, torch.from_numpy(base))[0]
    _, _, _, d2, _ = tv._march_closest(
        lambda q, c: map_fn(q, torch.from_numpy(base), c), ro, rd, checks)
    empty = (d2.numpy() == tv.EMPTY).astype(np.float32)
    assert empty.any()
    grads = []
    for tie_scale in (tie, None):
        q = torch.from_numpy(base.copy()).requires_grad_()
        d_row(q, tie_scale, empty).backward()
        grads.append(q.grad.numpy())
    np.testing.assert_array_equal(grads[0], grads[1])
