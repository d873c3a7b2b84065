"""Port parity: the ray march of the differentiable renderer (K3,
kernels/march.py) against the JAX package's Pallas march kernel
(``march_pallas``) in interpret mode, on scattered rays made from a numpy
seed, as tests/test_kernel_interpret.py:94 holds that kernel to ``cast_ray``.

On the CPU ``march_rays`` runs its plain torch version (the CSG program of
render/program.py interpreted in torch); chip_smoke.py holds the CUDA kernel
to it on the card.  Tolerances, with their reasons:

* exact march: ids equal, hit t within 1e-5 (XLA contracts multiply-adds,
  the port rounds each operation; test_torch_march.py meets the same);
* t-culled march: ids equal and the same rays hit; JAX culls per tile on the
  reference boxes, the port per ray on bounding spheres (ROADMAP queue 3),
  so a hit fires elsewhere in the |d| < MHD shell, far along it on grazing
  rays: at most 10 % of hits move by more than 1e-3 against JAX's culled
  march (its own culled march moves 30 of these 543 hits that far from its
  exact one), and every hit stays within 1e-3 of JAX's exact march;
* normals on hits: the central difference divides the map's last-bit
  differences by its 2e-4 tap spacing; at hit points up to ~10 from the
  origin that reaches 2.4e-3, so 90 % of hits are held to 5e-4 (the bound
  on primary rays, ROADMAP queue 3) and all to 5e-3.
"""

from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compute_path_tracer_tpu.kernels.march import march_pallas
from compute_path_tracer_tpu.render import baked as jb
from compute_path_tracer_tpu.vecmath import Vec3 as JVec3
from compute_path_tracer_tpu_torch.kernels import march as km
from compute_path_tracer_tpu_torch.render import program as tp
from compute_path_tracer_tpu_torch.vecmath import Vec3 as TVec3
from test_torch_sdf import pair

H, W = 8, 128  # one (8, 128) tile of rays: no padding on the JAX side
FAR = 100.0


def _rays(seed=3):
    r = np.random.default_rng(seed)
    ro = r.uniform(-4, 4, (3, H, W)).astype(np.float32)
    d = r.normal(size=(3, H, W)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return ro, d


@lru_cache(maxsize=None)
def jax_march(t_cull, with_normal):
    jc, _ = pair("benchmark_16")
    ro, d = _rays()
    bv = jb.bake(jc.spec, jnp.asarray(jc.params))
    out = march_pallas(jc.spec, bv, JVec3(*map(jnp.asarray, ro)),
                       JVec3(*map(jnp.asarray, d)), geometry="baked",
                       t_cull=t_cull, interpret=True, tile=(H, W),
                       with_normal=with_normal)
    t, idx = np.asarray(out[0]).ravel(), np.asarray(out[1]).ravel()
    n = np.stack([np.asarray(c).ravel() for c in out[2]]) if with_normal \
        else None
    return t, idx, n


def port_march(t_cull, with_normal):
    _, tc = pair("benchmark_16")
    ro, d = _rays()
    prog = tp.build_program(tc.spec, "baked")
    table = tp.program_table(prog, torch.from_numpy(tc.params), t_cull)
    out = km.march_rays(prog, table,
                        TVec3(*(torch.from_numpy(c.ravel()) for c in ro)),
                        TVec3(*(torch.from_numpy(c.ravel()) for c in d)),
                        t_cull=t_cull, with_normal=with_normal)
    t, idx = out[0].numpy(), out[1].numpy()
    assert t.dtype == np.float32 and idx.dtype == np.int32
    n = np.stack([c.numpy() for c in out[2]]) if with_normal else None
    return t, idx, n


def test_exact_march_and_normals_match_pallas():
    t_j, i_j, n_j = jax_march(False, True)
    t_t, i_t, n_t = port_march(False, True)
    hit = t_j <= FAR
    assert 0.2 < hit.mean() < 0.8
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_array_equal(t_t > FAR, ~hit)
    np.testing.assert_allclose(t_t[hit], t_j[hit], rtol=0, atol=1e-5)
    dn = np.abs(n_t - n_j).max(axis=0)[hit]
    assert (dn <= 5e-4).mean() >= 0.9
    assert dn.max() <= 5e-3
    # A miss gets the zero normal, which no caller reads.
    assert not n_t[:, ~hit].any()


def test_tcull_march_matches_pallas():
    t_j, i_j, _ = jax_march(True, False)
    t_t, i_t, _ = port_march(True, False)
    hit = t_j <= FAR
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_array_equal(t_t > FAR, ~hit)
    assert (np.abs(t_t - t_j)[hit] > 1e-3).mean() <= 0.1
    t_exact = jax_march(False, True)[0]
    np.testing.assert_allclose(t_t[hit], t_exact[hit], rtol=0, atol=1e-3)


@pytest.mark.parametrize("t_cull", [False, True])
def test_cpu_tensor_runs_the_plain_version(t_cull):
    """On CPU tensors ``march_rays`` is ``march_rays_plain`` and launches
    nothing; the normal does not change t or idx."""
    _, tc = pair("csg_demo")
    ro, d = _rays(5)
    prog = tp.build_program(tc.spec, "faithful")
    table = tp.program_table(prog, torch.from_numpy(tc.params), t_cull)
    ro_t = TVec3(*(torch.from_numpy(c.ravel()) for c in ro))
    rd_t = TVec3(*(torch.from_numpy(c.ravel()) for c in d))
    before = dict(km.LAUNCHES)
    got = km.march_rays(prog, table, ro_t, rd_t, t_cull=t_cull,
                        with_normal=True)
    assert km.LAUNCHES == before
    want = km.march_rays_plain(prog, table, ro_t, rd_t, t_cull=t_cull,
                               with_normal=True)
    for a, b in zip(got[:2] + tuple(got[2]), want[:2] + tuple(want[2])):
        assert torch.equal(a, b)
    t, idx = km.march_rays_plain(prog, table, ro_t, rd_t, t_cull=t_cull,
                                 with_normal=False)
    assert torch.equal(t, got[0]) and torch.equal(idx, got[1])


def test_rays_are_checked():
    _, tc = pair("csg_demo")
    prog = tp.build_program(tc.spec, "baked")
    table = tp.program_table(prog, torch.from_numpy(tc.params))
    ro = TVec3(*(torch.zeros(4) for _ in range(3)))
    with pytest.raises(ValueError):
        km._check_rays(prog, table, ro, TVec3(*(torch.zeros(5) for _ in range(3))))
    with pytest.raises(ValueError):
        km._check_rays(prog, table[1:], ro, ro)
    with pytest.raises(ValueError):
        km.march_rays(prog, table.to("meta"), ro, ro, t_cull=False,
                      with_normal=False)


def test_build_key_hashes_the_shared_header(tmp_path, monkeypatch):
    """K2 and K3 include csrc/csg_program.cuh: an edit there must give a new
    library path, so a stale build is never loaded."""
    import shutil

    from compute_path_tracer_tpu_torch.kernels import build

    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    names = {p.name for p in build._sources()}
    assert {"csg_program.cuh", "march_rays.cu", "megakernel_march.cu"} <= names
    before = build.library_path()
    header = csrc / "csg_program.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert build.library_path() != before


@lru_cache(maxsize=None)
def _hit_distance_case():
    """Camera-like rays into benchmark_scene(16), weights on the hits, and
    the JAX gradient of sum(w * t) through ``make_implicit_cast`` and
    ``bake``, with respect to the params and the six ray components."""
    import jax

    from compute_path_tracer_tpu.diff.vjp import make_implicit_cast

    jc, _ = pair("benchmark_16")
    r = np.random.default_rng(7)
    n = H * W
    ro = np.stack([r.uniform(-0.5, 0.5, n), r.uniform(-0.5, 0.5, n),
                   np.full(n, -3.0)]).astype(np.float32)
    d = np.stack([r.uniform(-0.8, 0.8, n), r.uniform(-0.6, 0.6, n),
                  np.ones(n)]).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    jmap, jbounds = jb.make_map_baked(jc.spec), jb.make_bounds_baked(jc.spec)

    def hit_t(pv, *c):
        gv = jb.bake(jc.spec, pv)
        o, dd = JVec3(*c[:3]), JVec3(*c[3:])
        checks, _ = jbounds(o, dd, gv)
        return make_implicit_cast(jmap)(None, o, dd, gv, checks)[0]

    args = (jnp.asarray(jc.params), *map(jnp.asarray, (*ro, *d)))
    t = np.asarray(hit_t(*args))
    w = np.where(t <= FAR, r.uniform(0.5, 1.5, n), 0.0).astype(np.float32)
    grads = jax.grad(lambda *a: jnp.sum(hit_t(*a) * w),
                     argnums=tuple(range(7)))(*args)
    return ro, d, w, [np.asarray(g) for g in grads]


@pytest.mark.parametrize("march", ["plain", "kernel"])
def test_implicit_hit_distance_gradient_matches_jax(march):
    """The implicit-function backward (``ImplicitCast``) against JAX's
    ``make_implicit_cast`` on a loss that reads the hit distance itself;
    the renderer's own loss never does (its radiance is a product of
    material constants), so this is where the backward is exercised.

    Plain march: the params' gradient within 1e-5 and each ray's within
    1e-4 of the largest entry (the map's multiply-adds round differently
    under XLA).  K3's t-culled march (its plain version here) hits other
    points of the MHD shell, where f_p differs: the params' gradient within
    2e-3 of the largest entry, 99 % of the ray entries within 1e-4, and
    every cosine above 0.99."""
    from compute_path_tracer_tpu_torch.diff.vjp import make_implicit_cast
    from compute_path_tracer_tpu_torch.render import baked as tb

    ro, d, w, want = _hit_distance_case()
    _, tc = pair("benchmark_16")
    p = torch.from_numpy(tc.params.copy()).requires_grad_()
    rays = [torch.from_numpy(c.copy()).requires_grad_() for c in (*ro, *d)]
    o, dd = TVec3(*rays[:3]), TVec3(*rays[3:])
    gv = tb.bake(tc.spec, p)
    checks, _ = tb.make_bounds_baked(tc.spec)(o, dd, gv.detach())
    cast = (make_implicit_cast(tb.make_map_baked(tc.spec), gv)
            if march == "plain" else km.make_kernel_cast(tc.spec, p, gv))
    t, _ = cast(o, dd, checks)
    (t * torch.from_numpy(w)).sum().backward()
    got = [p.grad.numpy()] + [x.grad.numpy() for x in rays]
    for i, (a, b) in enumerate(zip(got, want)):
        err = np.abs(a - b) / np.abs(b).max()
        cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
        if march == "plain":
            assert err.max() <= (1e-5 if i == 0 else 1e-4)
            assert cos >= 1 - 1e-6
        else:
            assert (err.max() if i == 0 else np.quantile(err, 0.99)) <= \
                (2e-3 if i == 0 else 1e-4)
            assert cos >= 0.99
