"""Port parity: parallel/mesh.py's row-band and sample sharding, and the
band (``row_offset``, ``crop_h``) of K1's and K2's plain versions.

The ranks run as threads of this process over gloo groups of one
``HashStore`` (``run_ranks``), computing in turns and meeting in the
collectives; every rank's result is checked.  On
sphere_and_plane at 32x32 (the JAX package's tests/test_parallel.py and
tests/test_samples_sharded.py):

* ``render_frame_sharded`` over 8 and 4 ranks, debug 2 and 0 (a running
  mean onto a seeded prior at frame 1), both backends, is bit for bit the
  port's single-device frame (``render_frame_megakernel`` for
  ``backend="kernel"``, ``render.reference.render_frame`` for
  ``"oracle"``); the oracle is also held to JAX's ``render_frame_sharded``
  on its 8-device CPU mesh within 1e-6, the port's oracle tolerance
  (tests/test_torch_accumulate.py);
* a band of K1's and K2's plain versions at an odd row offset and band
  height is bit for bit the frame's rows, in every mode and debug 0-3;
  debug 4's band on even rows is too, and one on odd rows raises;
* a RenderSession with ``make_sharded_frame_fn`` is bit for bit a plain
  session over two frames.

``render_samples_sharded`` is in tests/test_torch_parallel_samples.py.
"""

import threading
from datetime import timedelta
from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from compute_path_tracer_tpu.parallel import make_mesh as j_make_mesh
from compute_path_tracer_tpu.parallel import render_frame_sharded as j_frame
from compute_path_tracer_tpu.scene import compile_scene as j_compile
from compute_path_tracer_tpu.scene import library as j_lib
from compute_path_tracer_tpu_torch.app.config import Settings
from compute_path_tracer_tpu_torch.kernels import megakernel as mk
from compute_path_tracer_tpu_torch.parallel import (
    make_sharded_frame_fn,
    render_frame_sharded,
)
from compute_path_tracer_tpu_torch.parallel.mesh import Mesh
from compute_path_tracer_tpu_torch.render.reference import render_frame
from compute_path_tracer_tpu_torch.render.session import RenderSession
from compute_path_tracer_tpu_torch.scene import compile_scene as t_compile
from compute_path_tracer_tpu_torch.scene import convert_scene

W = H = 32
CPU = torch.device("cpu")
ORACLE_TOL = 1e-6
RANK_TIMEOUT = 60


class _BatonGloo(dist.ProcessGroupGloo):
    """A gloo group whose ranks, threads of one process, take turns: a rank
    holds ``baton`` while it computes and lets it go while it waits in a
    collective.  Torch lets the interpreter lock go around each operation,
    and ranks that run at once fight over it at every one: the dry run over
    8 ranks took 20 to 100 s so, against a few seconds in turns."""

    def __init__(self, store, rank, size, baton):
        super().__init__(store, rank, size, timedelta(seconds=RANK_TIMEOUT))
        self.baton = baton

    def _in_turn(name):
        def collective(self, *args, **kwargs):
            self.baton.release()
            try:
                work = getattr(dist.ProcessGroupGloo, name)(self, *args,
                                                            **kwargs)
                work.wait()
            finally:
                self.baton.acquire()
            return work

        return collective

    allreduce = _in_turn("allreduce")
    allgather = _in_turn("allgather")
    broadcast = _in_turn("broadcast")
    barrier = _in_turn("barrier")


def run_ranks(n, fn):
    """``fn(mesh)`` on ``n`` ranks, one thread each over a gloo group of a
    fresh store (``_BatonGloo``: the ranks compute in turns); returns the
    ranks' results in rank order and raises the first rank's error."""
    store, baton = dist.HashStore(), threading.Lock()
    out, errors = [None] * n, []

    def rank(r):
        try:
            pg = _BatonGloo(store, r, n, baton)
            with baton:
                out[r] = fn(Mesh(pg, r, n, CPU))
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=rank, args=(r,), daemon=True)
               for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(2 * RANK_TIMEOUT)
    assert not any(t.is_alive() for t in threads), "a rank did not finish"
    if errors:
        raise errors[0]
    return out


@lru_cache(maxsize=None)
def scenes(name="sphere_and_plane"):
    scene = getattr(j_lib, name)()
    jc, tc = j_compile(scene), t_compile(convert_scene(scene))
    return jc, tc, torch.from_numpy(np.asarray(tc.params, np.float32))


def _prior():
    return torch.from_numpy(np.random.default_rng(7).random(
        (H, W, 3)).astype(np.float32))


@pytest.mark.parametrize("n", [8, 4])
@pytest.mark.parametrize("backend", ["kernel", "oracle"])
@pytest.mark.parametrize("debug", [2, 0])
def test_frame_sharded_bit_identical(n, backend, debug):
    jc, tc, params = scenes()
    frame = dict(frame=1, last_clear=1) if debug == 0 else {}
    kw = dict(width=W, height=H, debug=debug, bounces=1)

    def accum():
        return _prior() if debug == 0 else None

    got = run_ranks(n, lambda mesh: render_frame_sharded(
        tc.spec, params, mesh, accum(), backend=backend, **frame, **kw))
    if backend == "kernel":
        want = mk.render_frame_megakernel(tc.spec, params, accum(), **frame,
                                          **kw)
    else:
        want = render_frame(tc.spec, params, accum(), **frame, **kw)
    assert want.shape == (H, W, 3) and float(want.abs().max()) > 0.0
    for img in got:
        assert torch.equal(img, want)
    if backend == "oracle":
        j_img = np.asarray(j_frame(
            jc.spec, jnp.asarray(jc.params, jnp.float32), j_make_mesh(n),
            None if debug else jnp.asarray(_prior().numpy()),
            backend="oracle", **frame, **kw))
        np.testing.assert_allclose(got[0].numpy(), j_img, rtol=0,
                                   atol=ORACLE_TOL)


BAND_CASES = {
    "K1 analytic_all": ("benchmark_scene", dict(geometry="baked",
                                                analytic_all=True)),
    "K1 analytic_all debug 3": ("benchmark_scene", dict(
        geometry="baked", analytic_all=True, debug=3)),
    "K5 analytic_soa": ("benchmark_scene", dict(geometry="baked",
                                                analytic_soa=True)),
    "K2 faithful": ("csg_demo", {}),
    "K2 faithful debug 1": ("csg_demo", dict(debug=1)),
    "K2 baked debug 2": ("csg_demo", dict(geometry="baked", debug=2)),
    "K2 t_cull debug 3": ("csg_demo", dict(geometry="baked", t_cull=True,
                                           debug=3)),
    "K2b analytic_unboxed": ("sphere_and_plane", dict(
        geometry="baked", t_cull=True, analytic_unboxed=True)),
    "RELAX omega 1.6": ("csg_demo", dict(geometry="baked", t_cull=True,
                                         omega=1.6)),
    "K6 dist_grid": ("csg_demo", dict(geometry="baked", t_cull=True,
                                      dist_grid=True)),
}


@pytest.mark.parametrize("case", list(BAND_CASES))
def test_plain_band_is_the_frames_rows(case):
    """Rows 13-27 of 32 (an odd offset and an odd height), frame 2 onto a
    seeded prior in debug 0: bit for bit the whole frame's rows."""
    name, mode = BAND_CASES[case]
    scene = j_lib.benchmark_scene(16) if name == "benchmark_scene" else None
    if scene is None:
        _, tc, params = scenes(name)
    else:
        tc = t_compile(convert_scene(scene))
        params = torch.from_numpy(np.asarray(tc.params, np.float32))
    kw = dict(width=W, height=H, bounces=2, frame=2, last_clear=2, **mode)
    row0, crop = 13, 15
    prior = _prior()
    full = mk.render_frame_megakernel(tc.spec, params, prior.clone(), **kw)
    band = mk.render_frame_megakernel(
        tc.spec, params, prior[row0:row0 + crop].clone(), row_offset=row0,
        crop_h=crop, **kw)
    assert band.shape == (crop, W, 3)
    assert torch.equal(band, full[row0:row0 + crop])


def test_debug4_band():
    """Debug 4 counts per 2x16 warp: a band on even rows is the frame's
    rows bit for bit; an odd offset, or an odd height short of the frame's
    end, raises, through the sharded frame too."""
    _, tc, params = scenes("csg_demo")
    kw = dict(width=W, height=H, bounces=2, geometry="baked", t_cull=True,
              debug=4)
    full = mk.render_frame_megakernel(tc.spec, params, **kw)
    band = mk.render_frame_megakernel(tc.spec, params, row_offset=12,
                                      crop_h=14, **kw)
    assert torch.equal(band, full[12:26])
    for row0, crop in ((13, 14), (12, 15)):
        with pytest.raises(ValueError, match="warp"):
            mk.render_frame_megakernel(tc.spec, params, row_offset=row0,
                                       crop_h=crop, **kw)
    with pytest.raises(ValueError, match="warp"):
        render_frame_sharded(tc.spec, params, Mesh(None, 1, 4, CPU),
                             **dict(kw, height=36))


def test_height_must_divide():
    _, tc, params = scenes()
    with pytest.raises(ValueError, match="divisible"):
        render_frame_sharded(tc.spec, params, Mesh(None, 0, 8, CPU), width=W,
                             height=30)


def test_sharded_session_frame_fn():
    scene = convert_scene(j_lib.sphere_and_plane())
    settings = dict(debug=0, bounces=1)

    def two_frames(frame_fn):
        sess = RenderSession(scene, W, H, Settings(**settings),
                             frame_fn=frame_fn, device="cpu")
        sess.step()
        return sess.step()

    got = run_ranks(8, lambda mesh: two_frames(make_sharded_frame_fn(mesh)))
    want = two_frames(None)
    for img in got:
        assert torch.equal(img, want)


@pytest.mark.parametrize("row0,crop", [(-1, 4), (30, 4), (0, 0)],
                         ids=["negative offset", "past the end", "no rows"])
def test_band_outside_the_frame_raises(row0, crop):
    _, tc, params = scenes()
    with pytest.raises(ValueError, match="rows"):
        mk.render_frame_megakernel(tc.spec, params, width=W, height=H,
                                   bounces=1, row_offset=row0, crop_h=crop)
