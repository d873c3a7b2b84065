"""Port parity: RenderSession, PNG export and the CLI of the PyTorch port,
and the rule that the port never imports JAX."""

import os
import subprocess
import sys
from functools import partial

import jax.numpy as jnp
import numpy as np
import torch

from compute_path_tracer_tpu.io.png import load_png_rgba as j_load_png
from compute_path_tracer_tpu.render.soa import render_frame_soa
from compute_path_tracer_tpu.scene import compile_scene as j_compile
from compute_path_tracer_tpu.scene import library as j_lib
from compute_path_tracer_tpu_torch.app.config import Settings
from compute_path_tracer_tpu_torch.kernels import render_frame_megakernel
from compute_path_tracer_tpu_torch.render.session import RenderSession
from compute_path_tracer_tpu_torch.scene import convert_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, BOUNCES = 64, 32, 3


def _session(scene):
    """A session in the full-analytic mode, which JAX render_frame_soa
    renders too."""
    return RenderSession(convert_scene(scene), W, H,
                         Settings(debug=0, bounces=BOUNCES), device="cpu",
                         frame_fn=partial(render_frame_megakernel,
                                          geometry="baked", analytic_all=True))


def test_session_accumulates_like_jax():
    scene = j_lib.benchmark_scene(16)
    jc = j_compile(scene)
    ref = np.zeros((H, W, 3), np.float32)
    for f in range(3):
        img = np.asarray(render_frame_soa(jc.spec, jnp.asarray(jc.params),
                                          width=W, height=H, bounces=BOUNCES,
                                          fov=1.0, aspect=W / H, frame=f))
        w = np.float32(1.0) / np.float32(f + 1)
        ref = ref * (np.float32(1.0) - w) + img * w
    sess = _session(scene)
    first = sess.step()
    out = sess.render(2)
    assert out is first  # the accumulator is updated in place
    assert (sess.frame, sess.last_clear) == (3, 3)
    diff = np.abs(out.numpy() - ref).max(axis=-1)
    assert np.isfinite(out.numpy()).all()
    assert float((diff > 1e-2).mean()) <= 5e-3


def test_two_speed_edits():
    sess = _session(j_lib.benchmark_scene(8))
    sess.render(2)
    spec = sess.compiled.spec
    before = sess.accum.clone()
    shape = sess.scene.roots[0].children_shapes[0]
    shape.transform.position.x.set(shape.transform.position.x.val + 0.3)
    sess.mark_values_changed()
    sess.step()
    assert sess.compiled.spec is spec  # value edit: no recompile
    assert sess.last_clear == 1
    assert not torch.equal(before, sess.accum)
    sess.scene.roots[0].children_shapes.pop()
    sess.mark_structure_changed()
    sess.step()
    assert sess.compiled.spec is not spec
    assert sess.compiled.spec.n_shapes == spec.n_shapes - 1


def test_png_reads_back_in_jax_package(tmp_path):
    sess = _session(j_lib.benchmark_scene(8))
    sess.render(1)
    path = str(tmp_path / "frame.png")
    sess.save_image(path)
    rgba = j_load_png(path)
    assert rgba.shape == (H, W, 4) and rgba.dtype == np.uint8
    expect = np.clip(sess.accum.numpy(), 0.0, 1.0) ** (1.0 / 2.2)
    expect = (expect * 255.0 + 0.5).astype(np.uint8)[::-1]
    assert np.array_equal(rgba[..., :3], expect)
    sess.save_image(path, tonemap="aces")
    assert j_load_png(path).shape == (H, W, 4)


def test_cli_render_smoke(tmp_path):
    out = tmp_path / "cli.png"
    res = subprocess.run(
        [sys.executable, "-m", "compute_path_tracer_tpu_torch", "render",
         "--scene", "benchmark_scene", "--width", "32", "--height", "24",
         "--frames", "2", "--bounces", "2", "--device", "cpu",
         "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "rendered 2 frames at 32x24" in res.stdout
    assert j_load_png(str(out)).shape == (24, 32, 4)


def test_port_never_imports_jax():
    code = (
        "import pkgutil, sys, importlib\n"
        "import compute_path_tracer_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')\n"
        "         if not m.name.endswith('__main__')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.startswith('compute_path_tracer_tpu.')\n"
        "       or m == 'compute_path_tracer_tpu']\n"
        "assert len(names) > 15, names\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
