"""Port parity: checkpoint / resume (io/checkpoint.py, ``render
--checkpoint`` / ``--resume``) against the JAX package's
``io/checkpoint.py`` (tests/test_resume.py).

* Interchange both ways: a checkpoint written by either package loads in
  the other with the same scene (its compiled parameters equal), the same
  arrays bit for bit and the same counters.
* Resume in the port: a session interrupted after 2 frames, checkpointed
  and resumed in a new session, renders frames 3 and 4 bit for bit as an
  uninterrupted 4-frame run (the RNG is a pure function of the pixel and
  the frame), from the port's own checkpoint and from one the JAX package
  wrote of the same state.
* The ``torch.save`` pair round-trips its contents bit for bit.
* ``render --checkpoint`` then ``render --resume`` through the CLI on the
  CPU equals one uninterrupted run, accumulator bit for bit.
"""

import numpy as np
import pytest
import torch

from compute_path_tracer_tpu.io import load_checkpoint as j_load
from compute_path_tracer_tpu.io import save_checkpoint as j_save
from compute_path_tracer_tpu.scene import compile_scene as j_compile
from compute_path_tracer_tpu.scene import sphere_and_plane as j_sphere_and_plane
from compute_path_tracer_tpu_torch.app.cli import main as cli_main
from compute_path_tracer_tpu_torch.app.cli import resume_session
from compute_path_tracer_tpu_torch.app.config import Settings
from compute_path_tracer_tpu_torch.io import (
    load_checkpoint,
    load_checkpoint_torch,
    save_checkpoint,
    save_checkpoint_torch,
)
from compute_path_tracer_tpu_torch.render.session import RenderSession
from compute_path_tracer_tpu_torch.scene import compile_scene, sphere_and_plane

W = H = 32
SETTINGS = dict(debug=0, bounces=1)


def _session(scene=None):
    return RenderSession(scene or sphere_and_plane(), W, H,
                         Settings(**SETTINGS), device="cpu")


@pytest.fixture(scope="module")
def runs():
    """An uninterrupted 4-frame accumulator and a session stopped after
    2."""
    full = _session().render(4).clone()
    part = _session()
    part.render(2)
    return full, part


def _resume_and_finish(state):
    sess = _session(state["scene"])
    resume_session(sess, state)
    return sess.render(2)


def test_resume_bit_identical(runs, tmp_path):
    full, part = runs
    ck = str(tmp_path / "ck")
    save_checkpoint(ck, scene=part.scene, params=part.params,
                    accum=part.accum, frame=part.frame,
                    last_clear=part.last_clear)
    state = load_checkpoint(ck)
    assert (state["frame"], state["last_clear"]) == (2, 2)
    assert torch.equal(_resume_and_finish(state), full)


def test_port_checkpoint_loads_in_jax(runs, tmp_path):
    _, part = runs
    ck = str(tmp_path / "ck")
    save_checkpoint(ck, scene=part.scene, params=part.params,
                    accum=part.accum, frame=part.frame,
                    last_clear=part.last_clear, extra={"step": 7})
    state = j_load(ck)
    np.testing.assert_array_equal(state["accum"], part.accum.numpy())
    np.testing.assert_array_equal(state["params"], part.params.numpy())
    np.testing.assert_array_equal(j_compile(state["scene"]).params,
                                  part.params.numpy())
    assert (state["frame"], state["last_clear"]) == (2, 2)
    assert int(state["extra"]["step"]) == 7


def test_jax_checkpoint_loads_and_resumes_in_the_port(runs, tmp_path):
    """The JAX package writes the port session's state (its accumulator
    and counters, the JAX scene); the port loads it and finishes the run
    bit for bit."""
    full, part = runs
    ck = str(tmp_path / "ck")
    jscene = j_sphere_and_plane()
    j_save(ck, scene=jscene, params=np.asarray(j_compile(jscene).params),
           accum=part.accum.numpy(), frame=2, last_clear=2,
           extra={"step": np.int64(7)})
    state = load_checkpoint(ck)
    np.testing.assert_array_equal(compile_scene(state["scene"]).params,
                                  j_compile(jscene).params)
    np.testing.assert_array_equal(state["params"], j_compile(jscene).params)
    assert int(state["extra"]["step"]) == 7
    assert torch.equal(_resume_and_finish(state), full)


def test_resume_rejects_another_size(runs, tmp_path):
    _, part = runs
    ck = str(tmp_path / "ck")
    save_checkpoint(ck, scene=part.scene, accum=part.accum, frame=2,
                    last_clear=2)
    sess = RenderSession(sphere_and_plane(), W, H + 1, Settings(**SETTINGS),
                         device="cpu")
    with pytest.raises(ValueError, match="accumulator"):
        resume_session(sess, load_checkpoint(ck))


def test_torch_save_pair_round_trip(runs, tmp_path):
    full, part = runs
    ck = str(tmp_path / "ck")
    save_checkpoint_torch(ck, scene=part.scene, params=part.params,
                          accum=part.accum, frame=part.frame,
                          last_clear=part.last_clear,
                          extra={"m": torch.arange(3.0)})
    state = load_checkpoint_torch(ck)
    assert torch.equal(state["accum"], part.accum)
    assert torch.equal(state["params"], part.params)
    assert torch.equal(state["extra"]["m"], torch.arange(3.0))
    assert (state["frame"], state["last_clear"]) == (2, 2)
    np.testing.assert_array_equal(compile_scene(state["scene"]).params,
                                  part.params.numpy())
    assert torch.equal(_resume_and_finish(state), full)


def test_cli_render_checkpoint_and_resume(tmp_path, capsys):
    base = ["render", "--device", "cpu", "--scene", "sphere_and_plane",
            "--width", "16", "--height", "12", "--bounces", "1",
            "--out", str(tmp_path / "img.png")]
    full, half, resumed = (str(tmp_path / n) for n in ("full", "half", "res"))
    assert cli_main(base + ["--frames", "4", "--checkpoint", full]) == 0
    assert cli_main(base + ["--frames", "2", "--checkpoint", half]) == 0
    assert cli_main(base + ["--frames", "2", "--resume", half,
                            "--checkpoint", resumed]) == 0
    out = capsys.readouterr().out
    assert "resumed" in out and "checkpoint ->" in out
    a, b = load_checkpoint(full), load_checkpoint(resumed)
    assert a["accum"].shape == (12, 16, 3)
    np.testing.assert_array_equal(a["accum"], b["accum"])
    assert (b["frame"], b["last_clear"]) == (4, 4)
