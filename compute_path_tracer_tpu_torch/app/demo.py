"""Two-speed live editing over a watched scene JSON (JAX package:
``app/demo.py``).

The reference's defining UX is live editing: an edit either refreshes the
``data[]`` parameter buffer (cheap) or regenerates and recompiles the
compute shader (expensive), driven by dirty flags (reference:
src/sdf_editor/sdf_editor.rs:35-47, timings printed at
src/path_tracer/path_tracer.rs:66,75).  Headless, the editor surface is the
scene JSON file: this module watches it and routes each change down the
same split over a live ``RenderSession``:

* **value edit** (same topology, a number changed): the lowered scene and
  its ``SceneSpec`` are kept; only the flat parameter vector is re-read
  and moved to the session's device (the ``queue_update`` path,
  primitives.rs:153-156);
* **structure edit** (a shape added or removed, a kind, op or AABB
  changed): the scene is lowered anew, and the next frame builds its
  program and tables for the new spec (the ``queue_compile`` /
  ``remake_pipeline`` path, path_tracer.rs:62-76).

Both print their cost:

    python -m compute_path_tracer_tpu_torch demo --scene data/maps/live.json
    # ... edit live.json elsewhere; the demo re-renders on save.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

from ..scene.compile import compile_scene, params_from_numpy
from ..scene.io import load_scene


def apply_scene_file(sess, path: str):
    """Apply the scene file's current contents to a live RenderSession.

    Returns ``(kind, seconds)``: "refresh" (a value-only edit: the session
    keeps ``sess.compiled.spec``, the same object) or "recompile" (a
    structural edit: a new spec).  The discriminator is SceneSpec equality:
    the same lowered topology keeps every compiled closure valid, and the
    parameter identities (Param.uid, kept by JSON round trips) are re-read
    in place."""
    t0 = time.perf_counter()
    new_scene = load_scene(path)
    new_compiled = compile_scene(new_scene)
    if new_compiled.spec == sess.compiled.spec:
        params = sess.compiled.refresh(new_scene)
        kind = "refresh"
    else:
        sess.compiled = new_compiled
        params = new_compiled.params
        kind = "recompile"
    sess.scene = new_scene
    sess.params = params_from_numpy(params, sess.compiled.spec, sess.device)
    sess.reset_accumulation()
    return kind, time.perf_counter() - t0


def watch_scene(
    sess,
    path: str,
    *,
    frames: int = 4,
    out: Optional[str] = None,
    poll_s: float = 0.5,
    max_events: Optional[int] = None,
    log: Callable[[str], None] = print,
):
    """Poll ``path`` for mtime changes and re-render ``frames`` frames
    through the two-speed pipeline after each, logging each edit's kind,
    its lowering time and the frames' time (waited for on the device).
    ``max_events`` bounds the loop for scripted use and tests; returns the
    edits processed.  An edit whose JSON does not load (a file caught
    mid-save) is logged and skipped."""
    last_mtime = os.path.getmtime(path)
    events = 0
    t0 = time.perf_counter()
    sess.render(frames).cpu()
    if out:
        sess.save_image(out)
    log(
        f"initial render: {frames} frames in {time.perf_counter() - t0:.2f}s"
        + (f" -> {out}" if out else "")
    )
    while max_events is None or events < max_events:
        time.sleep(poll_s)
        try:
            mtime = os.path.getmtime(path)
        except OSError:
            continue  # mid-save; retry
        if mtime == last_mtime:
            continue
        last_mtime = mtime
        try:
            kind, lower_s = apply_scene_file(sess, path)
        except (OSError, ValueError, KeyError, TypeError) as e:
            log(f"edit ignored ({type(e).__name__}: {e})")
            continue
        t0 = time.perf_counter()
        sess.render(frames).cpu()  # waits for the device
        render_s = time.perf_counter() - t0
        if out:
            sess.save_image(out)
        if kind == "refresh":
            log(
                f"[value edit] param refresh {lower_s * 1e3:.2f} ms "
                f"(spec reused) + {frames} frames {render_s:.2f}s"
            )
        else:
            log(
                f"[structure edit] re-lower {lower_s * 1e3:.2f} ms + "
                f"new spec + {frames} frames {render_s:.2f}s"
            )
        events += 1
    return events
