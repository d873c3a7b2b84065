"""Port parity: multi-frame progressive accumulation.

``render/reference.py:render_accumulated`` (the torch oracle) is held to the
JAX package's ``render_accumulated`` on sphere_and_plane (3 frames, 32x16,
2 bounces) within 1e-6, as tests/test_reference.py:113 holds the JAX
version to its own frame loop.  ``render_accumulated_megakernel`` (JAX
``render_accumulated_pallas``) is held, on the CPU where it runs the plain
version, to N calls of ``render_frame_megakernel`` bit for bit, with K1's
``analytic_all`` mode and with K2's t-culled march; chip_smoke.py holds the
same on the card, where it launches the kernels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compute_path_tracer_tpu.render import render_accumulated as j_accumulated
from compute_path_tracer_tpu.scene import compile_scene as j_compile
from compute_path_tracer_tpu.scene import library as j_lib
from compute_path_tracer_tpu_torch.kernels import megakernel as mk
from compute_path_tracer_tpu_torch.render.reference import render_accumulated
from compute_path_tracer_tpu_torch.scene import compile_scene as t_compile
from compute_path_tracer_tpu_torch.scene import convert_scene

W, H, N_FRAMES = 32, 16, 3


def _pair(scene):
    return j_compile(scene), t_compile(convert_scene(scene))


def test_render_accumulated_matches_jax():
    jc, tc = _pair(j_lib.sphere_and_plane())
    want = np.asarray(j_accumulated(jc.spec, jnp.asarray(jc.params, jnp.float32),
                                    N_FRAMES, width=W, height=H, bounces=2))
    got = render_accumulated(tc.spec, torch.from_numpy(
        np.asarray(tc.params, np.float32)), N_FRAMES, width=W, height=H,
        bounces=2)
    assert got.shape == (H, W, 3) and float(got.max()) > 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("scene_fn,mode", [
    (lambda: j_lib.benchmark_scene(16), dict(geometry="baked",
                                             analytic_all=True)),
    (j_lib.csg_demo, dict(geometry="baked", t_cull=True)),
], ids=["K1 analytic_all", "K2 t_cull"])
def test_accumulated_megakernel_is_n_frames(scene_fn, mode):
    _, tc = _pair(scene_fn())
    params = torch.from_numpy(np.asarray(tc.params, np.float32))
    kw = dict(width=W, height=H, bounces=2, **mode)
    got = mk.render_accumulated_megakernel(tc.spec, params, N_FRAMES, **kw)
    want = None
    for f in range(N_FRAMES):
        want = mk.render_frame_megakernel(tc.spec, params, want, f, f, **kw)
    assert torch.equal(got, want)
    # Frame 0 overwrites: one frame is the frame itself.
    one = mk.render_accumulated_megakernel(tc.spec, params, 1, **kw)
    assert torch.equal(one, mk.render_frame_megakernel(tc.spec, params, **kw))
