"""The port's live-editing demo (app/demo.py) and TUI controller
(app/tui.py) on the CPU: tests/test_demo.py and tests/test_tui.py over the
port's RenderSession, and the CLI ``demo --max-events``.

A value edit must keep ``sess.compiled.spec`` the same object and re-read
the parameters (the reference's queue_update path, primitives.rs:153-156);
a structure edit must lower the scene anew (queue_compile,
sdf_editor.rs:35-47).  The sessions render through the default frame
function's plain version (CPU tensors).
"""

import os
import threading
import time

import numpy as np
import pytest

from compute_path_tracer_tpu_torch.app.cli import main as cli_main
from compute_path_tracer_tpu_torch.app.config import Settings
from compute_path_tracer_tpu_torch.app.demo import apply_scene_file, watch_scene
from compute_path_tracer_tpu_torch.app.tui import TuiController
from compute_path_tracer_tpu_torch.render.session import RenderSession
from compute_path_tracer_tpu_torch.scene import csg_demo, sphere_and_plane
from compute_path_tracer_tpu_torch.scene.io import load_scene, save_scene
from compute_path_tracer_tpu_torch.scene.model import KIND_CUBE, Shape


def _session(tmp_path):
    path = str(tmp_path / "live.json")
    save_scene(sphere_and_plane(), path)
    sess = RenderSession(load_scene(path), 16, 16,
                         Settings(debug=2, bounces=1), device="cpu")
    return sess, path


def test_value_edit_routes_to_refresh(tmp_path):
    sess, path = _session(tmp_path)
    img0 = sess.step().numpy().copy()
    spec_before = sess.compiled.spec

    edited = load_scene(path)
    edited.roots[0].children_shapes[0].transform.position.set(0.4, 0.0, 0.0)
    save_scene(edited, path)

    kind, _ = apply_scene_file(sess, path)
    assert kind == "refresh"
    assert sess.compiled.spec is spec_before
    assert sess.last_clear == 0 and sess.accum is None
    img1 = sess.step().numpy()
    assert not np.array_equal(img0, img1)


def test_structure_edit_routes_to_recompile(tmp_path):
    sess, path = _session(tmp_path)
    sess.step()
    spec_before = sess.compiled.spec

    edited = load_scene(path)
    edited.roots[0].add_shape(Shape(KIND_CUBE, name="New"))
    save_scene(edited, path)

    kind, _ = apply_scene_file(sess, path)
    assert kind == "recompile"
    assert sess.compiled.spec is not spec_before
    assert sess.compiled.spec != spec_before
    assert sess.params.shape[0] == sess.compiled.params.shape[0]
    assert np.isfinite(sess.step().numpy()).all()


def _edit_later(path, edit, delay=0.4, after=None):
    """Edits the scene file in a thread ``delay`` seconds after it starts or
    after the file ``after`` appears (the demo's first image, written once
    it watches the scene)."""
    def run():
        if after is not None:
            for _ in range(1200):
                if os.path.exists(after):
                    break
                time.sleep(0.1)
        time.sleep(delay)
        edited = load_scene(path)
        edit(edited)
        save_scene(edited, path)
        st = os.stat(path)  # a visible mtime step on coarse filesystems
        os.utime(path, (st.st_atime, st.st_mtime + 1))

    t = threading.Thread(target=run)
    t.start()
    return t


def test_watch_scene_processes_edit_events(tmp_path):
    sess, path = _session(tmp_path)
    logs = []
    t = _edit_later(path, lambda s: s.roots[0].children_shapes[0].size.set(1.5))
    n = watch_scene(sess, path, frames=1, poll_s=0.1, max_events=1,
                    log=logs.append)
    t.join()
    assert n == 1
    assert any("value edit" in line for line in logs)


def test_cli_demo_max_events(tmp_path, capsys):
    path, png = str(tmp_path / "live.json"), str(tmp_path / "live.png")
    t = _edit_later(path, lambda s: s.roots[0].add_shape(
        Shape(KIND_CUBE, name="New")), delay=0.2, after=png)
    assert cli_main(["demo", "--device", "cpu", "--scene", path, "--seed",
                     "sphere_and_plane", "--width", "16", "--height", "16",
                     "--frames", "1", "--bounces", "1", "--max-events", "1",
                     "--out", png]) == 0
    t.join()
    out = capsys.readouterr().out
    assert "seeded" in out and "initial render" in out
    assert "[structure edit]" in out
    assert os.path.exists(tmp_path / "live.png")


@pytest.fixture()
def ctl():
    sess = RenderSession(csg_demo(), 32, 32, device="cpu")
    sess.settings.bounces = 1
    return TuiController(sess)


def _row_index(ctl, pred):
    for i, r in enumerate(ctl.rows):
        if pred(r):
            return i
    raise AssertionError("row not found")


def test_rows_cover_tree(ctl):
    assert {r.kind for r in ctl.rows} == {"union", "shape", "param", "flag"}
    assert any("sub" in r.label for r in ctl.rows)


def test_nudge_is_refresh_not_recompile(ctl):
    ctl.sel = _row_index(ctl, lambda r: r.kind == "param" and r.label == "pos.x")
    spec_before = ctl.session.compiled.spec
    params_before = ctl.session.params.numpy().copy()
    val_before = ctl.current.param.val

    kind, _ = ctl.nudge(+1)
    assert kind == "refresh"
    assert ctl.current.param.val != val_before
    assert ctl.session.compiled.spec is spec_before
    assert not np.array_equal(ctl.session.params.numpy(), params_before)
    assert "refresh" in ctl.status


def test_nudge_respects_param_range(ctl):
    ctl.sel = _row_index(ctl, lambda r: r.kind == "param" and r.label == "spec")
    ctl.nudge(+1, factor=1e9)
    assert ctl.current.param.val <= ctl.current.param.hi


def test_toggle_aabb_recompiles(ctl):
    ctl.sel = _row_index(ctl, lambda r: r.kind == "flag")
    shape = ctl.current.node
    before = shape.transform.aabb
    spec_before = ctl.session.compiled.spec
    kind, _ = ctl.toggle()
    assert kind == "recompile"
    assert shape.transform.aabb is (not before)
    assert ctl.session.compiled.spec is not spec_before


def test_toggle_union_op(ctl):
    ctl.sel = _row_index(ctl, lambda r: r.kind == "union" and "(union)" in r.label)
    u = ctl.current.node
    kind, _ = ctl.toggle()
    assert kind == "recompile"
    assert u.op == "subtraction"


def test_duplicate_with_rehash_and_delete(ctl):
    ctl.sel = _row_index(ctl, lambda r: r.kind == "shape")
    shape, parent = ctl.current.node, ctl.current.parent
    n_before = len(parent.children_shapes)
    uid_before = shape.transform.position.x.uid

    kind, _ = ctl.duplicate()
    assert kind == "recompile"
    assert len(parent.children_shapes) == n_before + 1
    dup = parent.children_shapes[-1]
    assert dup.transform.position.x.uid != uid_before

    ctl.sel = _row_index(ctl, lambda r: r.node is dup)
    kind, _ = ctl.delete()
    assert kind == "recompile"
    assert len(parent.children_shapes) == n_before


def test_add_shape(ctl):
    ctl.sel = _row_index(ctl, lambda r: r.kind == "union")
    u = ctl.current.node
    n = len(u.children_shapes)
    kind, _ = ctl.add_shape()
    assert kind == "recompile"
    assert len(u.children_shapes) == n + 1


def test_ascii_preview_renders(ctl):
    lines = ctl.render_ascii(cols=24, rows=8)
    assert len(lines) == 8 and all(len(s) == 24 for s in lines)
    assert any(c != " " for s in lines for c in s)


def test_move_clamps(ctl):
    ctl.move(-100)
    assert ctl.sel == 0
    ctl.move(10**6)
    assert ctl.sel == len(ctl.rows) - 1


def test_save(ctl, tmp_path):
    path = str(tmp_path / "saved.json")
    ctl.save(path)
    assert ctl.status == f"saved {path}"
    assert load_scene(path).roots[0].name == ctl.session.scene.roots[0].name
