"""Port parity: the baked coefficients, the analytic_all plan and the packed
shape tables of the PyTorch port against the JAX package.

``bake`` runs batched over tree depths in the port and as a scalar graph in
JAX; the same formulas in the same order agree to 1e-6 (float32 trig may
differ by an ulp), and its gradient agrees with ``jax.grad`` to rtol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compute_path_tracer_tpu.render import baked as jb
from compute_path_tracer_tpu.render import soa as js
from compute_path_tracer_tpu.scene import compile_scene as j_compile
from compute_path_tracer_tpu.scene import library as j_lib
from compute_path_tracer_tpu.scene.model import KIND_SPHERE as J_SPHERE
from compute_path_tracer_tpu.scene.model import Scene as JScene
from compute_path_tracer_tpu.scene.model import Shape as JShape
from compute_path_tracer_tpu.scene.model import Union as JUnion
from compute_path_tracer_tpu_torch.render import baked as tb
from compute_path_tracer_tpu_torch.render import soa as ts
from compute_path_tracer_tpu_torch.scene import compile_scene as t_compile
from compute_path_tracer_tpu_torch.scene import convert_scene

SCENES = ["benchmark_scene", "sphere_and_plane", "csg_demo", "blend_demo",
          "glass_demo", "edge_demo"]


def _clobber_scene():
    """A guarded first shape beside a child union: the first-shape-assign
    clobber (containers.rs:244-252) puts an ancestor guard in the plan."""
    root = JUnion(name="R")
    child = JUnion(name="C")
    inner = child.add_shape(JShape(J_SPHERE, name="inner"))
    inner.transform.aabb = False
    inner.size.set(0.8)
    root.add_union(child)
    first = root.add_shape(JShape(J_SPHERE, name="first"))
    first.transform.position.set(0.5, 0.0, 0.0)
    return JScene([root])


def _pair(name):
    """The same scene compiled by both packages (a JAX-built scene carried
    into the port through the shared JSON format)."""
    if name == "clobber":
        scene = _clobber_scene()
    elif name == "benchmark_scene_8":
        scene = j_lib.benchmark_scene(8)
    else:
        scene = getattr(j_lib, name)()
    return j_compile(scene), t_compile(convert_scene(scene))


def _perturbed(params, seed):
    noise = np.random.default_rng(seed).normal(0.0, 0.05, params.shape)
    return (params + noise).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", SCENES)
def test_bake_matches_jax(name, seed):
    jc, tc = _pair(name)
    p = _perturbed(tc.params, seed)
    a = np.asarray(jb.bake(jc.spec, jnp.asarray(p)))
    b = tb.bake(tc.spec, torch.from_numpy(p))
    assert b.dtype == torch.float32 and b.shape == a.shape
    np.testing.assert_allclose(b.numpy(), a, rtol=1e-6, atol=1e-6)


# Small scenes: the JAX side differentiates its scalar graph eagerly.
@pytest.mark.parametrize("name", ["benchmark_scene_8", "csg_demo"])
def test_bake_grad_matches_jax(name):
    jc, tc = _pair(name)
    p = _perturbed(tc.params, 2)
    w = np.random.default_rng(3).normal(size=tb.baked_layout(tc.spec).n_slots)
    w = w.astype(np.float32)
    g_j = np.asarray(jax.grad(
        lambda q: jnp.sum(jb.bake(jc.spec, q) * jnp.asarray(w)))(jnp.asarray(p)))
    pt = torch.from_numpy(p).requires_grad_(True)
    (tb.bake(tc.spec, pt) * torch.from_numpy(w)).sum().backward()
    # Entries that cancel to near zero keep float32 summation noise at the
    # scale of the largest terms, hence the atol relative to that scale.
    np.testing.assert_allclose(pt.grad.numpy(), g_j, rtol=1e-4,
                               atol=1e-4 * float(np.abs(g_j).max()))


@pytest.mark.parametrize("name", SCENES + ["clobber"])
def test_analytic_all_plan_identical(name):
    jc, tc = _pair(name)
    # Same dataclass names and fields: the reprs compare every row.
    assert repr(tb.analytic_all_plan(tc.spec)) == repr(
        jb.analytic_all_plan(jc.spec))


@pytest.mark.parametrize("name", SCENES + ["clobber"])
def test_soa_layout_identical(name):
    jc, tc = _pair(name)
    a = js.build_soa_smem_layout(jc.spec)
    b = ts.build_soa_smem_layout(tc.spec)
    if a is None:
        assert b is None
        return
    assert repr(b.kinds) == repr(a.kinds)
    assert ts.UNROLL == a.unroll
    for f in ("f_len", "i_len", "f_mat", "n_shapes", "n_shapes_pad"):
        assert getattr(b, f) == getattr(a, f), f
    for f in ("bv_gather", "bv_mask", "mat_slots", "i_const"):
        x, y = getattr(b, f), getattr(a, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("name", ["benchmark_scene", "clobber"])
def test_pack_matches_jax(name):
    jc, tc = _pair(name)
    p = _perturbed(tc.params, 4)
    jf, ji = js.pack_soa_smem(js.build_soa_smem_layout(jc.spec),
                              jb.bake(jc.spec, jnp.asarray(p)), jnp.asarray(p))
    pt = torch.from_numpy(p)
    tf, ti = ts.pack_soa_smem(ts.build_soa_smem_layout(tc.spec),
                              tb.bake(tc.spec, pt), pt)
    assert tf.dtype == torch.float32 and ti.dtype == torch.int32
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6, atol=1e-6)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
