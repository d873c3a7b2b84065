"""Port parity: the wavefront renderer (the port's
benchmarks/frozen_wavefront.py over kernels/wavefront.py) against the JAX
package's ``benchmarks/frozen_wavefront.py``, whose bounce kernel runs
through ``pl.pallas_call(..., interpret=True)``, and against the port's
own K2 frame.

On the CPU every bounce runs the plain version (``wavefront_bounce_plain``);
chip_smoke.py holds the CUDA kernel to it on the card.  The holds:

* the port's frame against JAX's ``render_frame_wavefront`` (csg_demo,
  64x64, 2 bounces) under tests/test_torch_march.py's contract for the
  faithful K2 frames: at most 0.5 % of pixels off by more than 1e-2 (XLA
  contracts multiply-adds in the map; the port rounds each operation, which
  moves a hit by an ulp and, rarely, a sample's path);
* the frame bit for bit the port's plain K2 faithful exact frame
  (``render_frame_megakernel_plain``), on csg_demo and
  ``benchmark_scene(8)``: the same rays, marched and shaded alike, each
  pixel's radiance added in the same order (JAX's wavefront equals its
  megakernel bit for bit in the same way);
* ``sort_rays=True`` bit for bit ``sort_rays=False``;
* the compaction keeping each ray's state, RNG and pixel.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compute_path_tracer_tpu_torch.benchmarks import frozen_wavefront as fw
from compute_path_tracer_tpu_torch.kernels import megakernel as mk
from compute_path_tracer_tpu_torch.kernels import wavefront as wf
from compute_path_tracer_tpu_torch.render.program import (
    build_program, program_table)
from compute_path_tracer_tpu_torch.scene import (
    benchmark_scene, compile_scene, csg_demo, params_from_numpy)
from test_torch_sdf import pair

BENCH = Path(__file__).resolve().parents[1] / "benchmarks"
DIFF_TOL = 1e-2


def _jax_wavefront():
    spec = importlib.util.spec_from_file_location(
        "frozen_wavefront", BENCH / "frozen_wavefront.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _scene(name):
    scene = csg_demo() if name == "csg_demo" else benchmark_scene(8)
    cs = compile_scene(scene)
    return cs.spec, params_from_numpy(cs.params, cs.spec, "cpu")


def test_frame_matches_jax():
    jc, tc = pair("csg_demo")
    kw = dict(width=64, height=64, bounces=2)
    want = np.asarray(_jax_wavefront().render_frame_wavefront(
        jc.spec, jnp.asarray(jc.params), interpret=True, **kw))
    before = dict(wf.LAUNCHES)
    got = fw.render_frame_wavefront(tc.spec, torch.from_numpy(tc.params),
                                    **kw).numpy()
    assert wf.LAUNCHES == before
    assert got.shape == want.shape and np.isfinite(got).all()
    assert float((np.abs(got - want).max(axis=-1) > DIFF_TOL).mean()) <= 5e-3


@pytest.mark.parametrize("name", ["csg_demo", "benchmark_8"])
def test_frame_is_k2_faithful_exact_frame(name):
    """70x40 pads to two tile rows of two tiles; frame 2 over a prior
    accumulator at last_clear 1."""
    spec, params = _scene(name)
    prior = torch.from_numpy(np.random.default_rng(1).random(
        (40, 70, 3), dtype=np.float32))
    kw = dict(width=70, height=40, bounces=3, frame=2, last_clear=1)
    got = fw.render_frame_wavefront(spec, params, prior.clone(), **kw)
    want = mk.render_frame_megakernel_plain(spec, params, prior.clone(), **kw)
    assert torch.equal(got, want)


def test_sorted_rays_give_the_same_frame():
    spec, params = _scene("benchmark_8")
    kw = dict(width=48, height=40, bounces=4, frame=1)
    assert torch.equal(
        fw.render_frame_wavefront(spec, params, sort_rays=True, **kw),
        fw.render_frame_wavefront(spec, params, **kw))


def test_debug_modes_route_to_the_megakernel():
    spec, params = _scene("csg_demo")
    kw = dict(width=24, height=16, bounces=2, debug=1)
    assert torch.equal(fw.render_frame_wavefront(spec, params, **kw),
                       mk.render_frame_megakernel(spec, params, **kw))


@pytest.mark.parametrize("step", [fw.compact, fw.compact_sorted],
                         ids=["compact", "compact_sorted"])
def test_compaction_keeps_each_rays_state(step):
    """The live rays come first, each with its own state, RNG and pixel;
    the unsorted compaction keeps their order."""
    r = np.random.default_rng(3)
    n = 4096
    ray = torch.from_numpy(r.normal(size=(9, n)).astype(np.float32))
    rng = torch.from_numpy(r.integers(-2**31, 2**31, n).astype(np.int32))
    pix = torch.from_numpy(r.permutation(n).astype(np.int64))
    alive = torch.from_numpy(r.random(n) < 0.3)
    out_ray, out_rng, out_pix, k = step(ray, rng, pix, alive)
    live = int(alive.sum())
    assert k.dtype == torch.int32 and k.tolist() == [live]
    assert out_ray.is_contiguous() and out_ray.shape == ray.shape
    want = torch.nonzero(alive).flatten()
    got = out_pix[:live]
    if step is fw.compact:
        assert torch.equal(got, pix[want])
    else:
        assert torch.equal(got.sort().values, pix[want].sort().values)
    src = torch.argsort(pix)[got]      # where each moved ray came from
    assert torch.equal(out_rng[:live], rng[src])
    assert torch.equal(out_ray[:, :live], ray[:, src])


def test_bounce_checks_its_inputs():
    spec, params = _scene("csg_demo")
    prog = build_program(spec, "faithful")
    table = program_table(prog, params)
    ray = torch.zeros((9, 8))
    rng = torch.zeros(8, dtype=torch.int32)
    k = torch.tensor([0], dtype=torch.int32)
    add, alive = wf.wavefront_bounce(prog, table, k, ray, rng)
    assert add.shape == (8, 3) and not bool(alive.any())
    with pytest.raises(ValueError):
        wf.wavefront_bounce(build_program(spec, "baked"),
                            table, k, ray, rng)
    with pytest.raises(ValueError):
        wf.wavefront_bounce(prog, table.to("meta"), k, ray, rng)
