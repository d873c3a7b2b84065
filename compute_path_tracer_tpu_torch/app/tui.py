"""In-process interactive scene editor: the terminal analog of the
reference's egui tree editor (JAX package: ``app/tui.py``).

The reference's defining UX is a live widget tree: per-param drag values
with speeds and ranges (reference: src/utility/macros.rs:2-33,
src/sdf_editor/containers.rs:79-140) whose edits route through the
two-speed dirty-flag loop (sdf_editor.rs:35-47): value drags refresh the
parameter buffer, structural edits recompile, each with its cost shown
(path_tracer.rs:66,75).

This module reproduces that UX headlessly over a live
:class:`~compute_path_tracer_tpu_torch.render.session.RenderSession`:

* :class:`TuiController`, the editing model: a flattened tree of rows
  (unions, shapes, params, AABB flags), cursor navigation, param nudging
  by the param's own drag speed (the ``Float.speed`` analog,
  primitives.rs:195-197), structural operations (duplicate with fresh
  identities, delete, op toggle, AABB toggle, add shape), each applied
  through the session's ``mark_values_changed`` /
  ``mark_structure_changed`` split with its measured time in ``status``;
* :func:`run_tui`, a stdlib-curses front end over the controller with an
  ASCII luminance preview of the progressive render.

The controller needs no terminal, so tests drive every edit path without
one; curses is imported only inside run_tui.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np

from ..scene.model import (
    KIND_NAMES,
    KIND_SPHERE,
    SUBTRACTION,
    UNION,
    Scene,
    Shape,
    Union,
)
from ..scene.params import Param


@dataclass
class Row:
    indent: int
    label: str
    kind: str  # "union" | "shape" | "param" | "flag"
    node: Any
    parent: Optional[Any] = None
    param: Optional[Param] = None
    extra: Any = None


@dataclass
class TuiController:
    session: Any  # RenderSession
    sel: int = 0
    status: str = "ready"
    rows: List[Row] = field(default_factory=list)

    def __post_init__(self):
        self.rebuild_rows()

    # -- tree flattening ----------------------------------------------------
    def rebuild_rows(self):
        rows: List[Row] = []

        def add_params(indent, owner, named):
            for label, p in named:
                rows.append(Row(indent, label, "param", owner, param=p))

        def walk_shape(sh: Shape, parent: Union, indent: int):
            rows.append(Row(indent, f"[{KIND_NAMES[sh.kind]}] {sh.name}",
                            "shape", sh, parent=parent))
            named = [
                ("pos.x", sh.transform.position.x),
                ("pos.y", sh.transform.position.y),
                ("pos.z", sh.transform.position.z),
                ("rot.x", sh.transform.rotation.x),
                ("rot.y", sh.transform.rotation.y),
                ("rot.z", sh.transform.rotation.z),
                ("scale", sh.transform.scale),
            ]
            if sh.size is not None:
                named.append(("size", sh.size))
            if sh.size3 is not None:
                named += [("size.x", sh.size3.x), ("size.y", sh.size3.y),
                          ("size.z", sh.size3.z)]
            named += [
                ("color.r", sh.material.color.x),
                ("color.g", sh.material.color.y),
                ("color.b", sh.material.color.z),
                ("brightness", sh.material.brightness),
                ("spec", sh.material.specular_chance),
                ("roughness", sh.material.roughness),
            ]
            add_params(indent + 1, sh, named)
            rows.append(Row(indent + 1, f"aabb: {sh.transform.aabb}",
                            "flag", sh, parent=parent))

        def walk_union(u: Union, parent: Optional[Union], indent: int):
            op = "sub" if u.op == SUBTRACTION else "union"
            rows.append(Row(indent, f"({op}) {u.name}", "union", u,
                            parent=parent))
            add_params(indent + 1, u, [
                ("pos.x", u.transform.position.x),
                ("pos.y", u.transform.position.y),
                ("pos.z", u.transform.position.z),
                ("scale", u.transform.scale),
            ])
            for cu in u.children_unions:
                walk_union(cu, u, indent + 1)
            for sh in u.children_shapes:
                walk_shape(sh, u, indent + 1)

        for root in self.session.scene.roots:
            walk_union(root, None, 0)
        self.rows = rows
        self.sel = min(self.sel, len(rows) - 1)

    # -- navigation ---------------------------------------------------------
    def move(self, delta: int):
        self.sel = max(0, min(len(self.rows) - 1, self.sel + delta))

    @property
    def current(self) -> Row:
        return self.rows[self.sel]

    # -- the two-speed apply loop ------------------------------------------
    def _apply(self, structural: bool):
        t0 = time.perf_counter()
        if structural:
            self.session.mark_structure_changed()
        else:
            self.session.mark_values_changed()
        self.session.update()
        dt = (time.perf_counter() - t0) * 1e3
        kind = "recompile" if structural else "refresh"
        self.status = f"{kind} {dt:.1f} ms"
        if structural:
            self.rebuild_rows()
        return kind, dt

    # -- edits --------------------------------------------------------------
    def nudge(self, direction: int, factor: float = 1.0):
        """Drag the selected param by ``direction * speed * factor`` (the
        egui drag-value analog, macros.rs:37-69); clamps to [lo, hi]."""
        row = self.current
        if row.kind != "param":
            self.status = "not a param row"
            return None
        p = row.param
        p.set(min(p.hi, max(p.lo, p.val + direction * p.speed * factor)))
        return self._apply(structural=False)

    def toggle(self):
        """Toggle the selected flag/op: union<->subtraction on union rows,
        AABB guard on aabb rows (both structural, containers.rs:48-68)."""
        row = self.current
        if row.kind == "union":
            row.node.op = UNION if row.node.op == SUBTRACTION else SUBTRACTION
        elif row.kind == "flag":
            row.node.transform.aabb = not row.node.transform.aabb
        else:
            self.status = "nothing to toggle"
            return None
        return self._apply(structural=True)

    def duplicate(self):
        """Duplicate the selected shape/union with fresh param identities
        (the duplicate-with-rehash rule, containers.rs:135-138)."""
        row = self.current
        if row.kind == "shape":
            row.parent.add_shape(row.node.duplicate())
        elif row.kind == "union" and row.parent is not None:
            row.parent.add_union(row.node.duplicate())
        else:
            self.status = "cannot duplicate"
            return None
        return self._apply(structural=True)

    def delete(self):
        row = self.current
        if row.kind == "shape":
            row.parent.children_shapes.remove(row.node)
        elif row.kind == "union" and row.parent is not None:
            row.parent.children_unions.remove(row.node)
        else:
            self.status = "cannot delete"
            return None
        return self._apply(structural=True)

    def add_shape(self, kind: int = KIND_SPHERE):
        row = self.current
        target = (row.node if row.kind == "union"
                  else row.parent if row.kind in ("shape", "flag")
                  else None)
        if target is None:
            self.status = "select a union or shape first"
            return None
        n = len(target.children_shapes)
        target.add_shape(Shape(kind, name=f"New{n}"))
        return self._apply(structural=True)

    def save(self, path: str):
        from ..scene.io import save_scene

        save_scene(self.session.scene, path)
        self.status = f"saved {path}"

    # -- preview ------------------------------------------------------------
    def render_ascii(self, cols: int = 48, rows: int = 16) -> List[str]:
        """One progressive frame, downsampled to an ASCII luminance map."""
        img = self.session.step().cpu().numpy()
        h, w = img.shape[:2]
        ramp = " .:-=+*#%@"
        ys = (np.arange(rows) * (h / rows)).astype(int)
        xs = (np.arange(cols) * (w / cols)).astype(int)
        lum = img[..., 0] * 0.2126 + img[..., 1] * 0.7152 + img[..., 2] * 0.0722
        lum = np.clip(lum[np.ix_(ys, xs)], 0.0, 1.0)
        idx = (lum * (len(ramp) - 1)).astype(int)
        return ["".join(ramp[i] for i in line) for line in idx]


def run_tui(scene: Scene, width: int = 128, height: int = 128,
            settings=None, frame_fn=None, device="cuda"):  # pragma: no cover
    """Curses front end over a RenderSession on ``device``; arrow keys
    navigate and nudge, the footer lists the other keys."""
    import curses

    from ..render.session import RenderSession

    sess = RenderSession(scene, width, height, settings=settings,
                         frame_fn=frame_fn, device=device)
    ctl = TuiController(sess)

    def loop(scr):
        curses.curs_set(0)
        scr.nodelay(False)
        while True:
            scr.erase()
            maxy, maxx = scr.getmaxyx()
            preview = ctl.render_ascii(min(64, maxx - 2), 16)
            for i, line in enumerate(preview):
                scr.addnstr(i, 0, line, maxx - 1)
            top = len(preview) + 1
            visible = maxy - top - 2
            first = max(0, ctl.sel - visible + 2)
            for i, row in enumerate(ctl.rows[first:first + visible]):
                y = top + i
                marker = ">" if first + i == ctl.sel else " "
                val = (f" = {row.param.val:.3f}" if row.kind == "param"
                       else "")
                scr.addnstr(y, 0, f"{marker} {'  ' * row.indent}"
                            f"{row.label}{val}", maxx - 1)
            scr.addnstr(
                maxy - 1, 0,
                f"[{ctl.status}] arrows:nav/nudge shift+l/r:fast t:toggle "
                "d:dup x:del a:add s:save q:quit", maxx - 1)
            scr.refresh()
            c = scr.getch()
            if c in (ord("q"), 27):
                break
            elif c == curses.KEY_UP:
                ctl.move(-1)
            elif c == curses.KEY_DOWN:
                ctl.move(1)
            elif c == curses.KEY_LEFT:
                ctl.nudge(-1)
            elif c == curses.KEY_RIGHT:
                ctl.nudge(+1)
            elif c == curses.KEY_SLEFT:
                ctl.nudge(-1, factor=10.0)
            elif c == curses.KEY_SRIGHT:
                ctl.nudge(+1, factor=10.0)
            elif c == ord("t"):
                ctl.toggle()
            elif c == ord("d"):
                ctl.duplicate()
            elif c == ord("x"):
                ctl.delete()
            elif c == ord("a"):
                ctl.add_shape()
            elif c == ord("s"):
                ctl.save("data/maps/tui_saved.json")

    curses.wrapper(loop)
