"""Live editing by one editor in a closed loop, as the reference's editor
runs while a slider is dragged: before each frame one value edit moves one
of the scene's grid primitives by a seeded offset of at most
``max_offset`` (a primitive picked again moves back to where it started,
so the scene does not drift), then ``mark_values_changed()``, ``step()``
and ``synchronize()``: the frame is shown before the next edit.  Every
edit resets the running mean, so each frame is one sample of the edited
scene.

The latency of an edit runs from applying it to the synchronize after its
frame.  The seed sets the edit sequence, the frame counter the window
starts at and the samples the check reads: a sample of the window's
edits, and at each the same sample of pixels, gathered after the edit's
latency was taken."""

from __future__ import annotations

import time

import numpy as np
import torch

from ..reference import load, render_check
from ..stats import p95
from .render import make_session, release, sample_pixels, seeded, spans, sync

EDIT_S_MIN = 0.004


class Cell:
    def __init__(self, config: dict, mix: dict, seed: int, device):
        self.config, self.mix, self.device = config, mix, device
        self.ref = load(config["renderer"]["reference"])
        self.reference_s = 0.0
        self.rng = seeded(seed)
        self.start = int(self.rng.integers(0, mix["start_frame_max"]))
        self.pixels = sample_pixels(self.rng, config, mix["check_pixels"])
        scene, self.session = make_session(config, device)
        self.shapes = render_check.grid_shapes(scene)
        self.origin = [tuple(s.transform.position.value) for s in self.shapes]
        self.moved = {}
        self.log = []
        self._index = torch.as_tensor(self.pixels, device=device)
        for _ in range(mix["warmup_edits"]):
            self.edit()
            self.session.step()
            sync(device)
        self.session.frame = self.start

    def edit(self) -> None:
        """Move one grid primitive by a seeded offset, or back."""
        i = int(self.rng.integers(len(self.shapes)))
        if i in self.moved:
            del self.moved[i]
            pos = self.origin[i]
        else:
            v = self.rng.normal(size=3)
            v *= self.rng.uniform(0.0, self.mix["max_offset"]) / np.linalg.norm(v)
            pos = tuple(float(o + d) for o, d in zip(self.origin[i], v))
            self.moved[i] = pos
        self.last_edit = (i, pos)
        self.shapes[i].transform.position.set(*pos)
        self.session.mark_values_changed()

    def window(self, seconds: float, traced: bool) -> dict:
        span, session = spans(traced), self.session
        latency = []
        # The positions at the window's start, and room for the pixels of
        # an edit every EDIT_S_MIN seconds (K2 alone takes longer), so that
        # the window allocates little of the harness's own.
        self.start_moved = dict(self.moved)
        cap = int(seconds / EDIT_S_MIN) + 1
        self.gathered = torch.empty((cap, len(self.pixels), 3),
                                    device=self.device)
        with span("bench.window"):
            end = time.perf_counter() + seconds
            while True:
                t0 = time.perf_counter()
                with span("bench.edit"):
                    self.edit()
                frame = session.frame
                with span("bench.step"):
                    accum = session.step()
                with span("bench.sync"):
                    sync(self.device)
                t1 = time.perf_counter()
                latency.append(t1 - t0)
                k = len(self.log)
                self.log.append((frame, self.last_edit))
                if k < cap:
                    torch.index_select(accum.reshape(-1, 3), 0, self._index,
                                       out=self.gathered[k])
                if t1 >= end:
                    break
        return {"units": len(latency),
                "metrics": {"edit_p95_ms": p95(latency) * 1e3}}

    def check(self) -> dict:
        """``pixel_rel_l1``: the sampled pixels of the sampled edits'
        frames against the reference's."""
        n = min(len(self.log), len(self.gathered))
        k = min(self.mix["check_edits"], n)
        picks = np.sort(np.concatenate([
            self.rng.choice(n - 1, k - 1, replace=False), [n - 1]]))
        got = self.gathered[torch.as_tensor(picks, device=self.device)]
        got = got.cpu().numpy()
        self.session = self.gathered = None
        release(self.device)
        self.picks = picks
        self.want = self.reference(picks)
        return {"pixel_rel_l1": render_check.rel_l1(got, self.want)}

    def control(self) -> dict:
        """The check's numbers with the reference in bfloat16 in the
        program's place (after ``check``)."""
        return {"pixel_rel_l1": render_check.rel_l1(
            self.reference(self.picks, lowered=True), self.want)}

    def reference(self, picks, lowered: bool = False) -> np.ndarray:
        """The reference's frame of each picked edit at the sampled pixels:
        ``(edits, pixels, 3)``.  A frame after a reset is its one sample."""
        c, n = self.config, len(self.pixels)
        states, spec = [], None
        moved, done = dict(self.start_moved), 0
        for i in picks:
            for _, (shape, pos) in self.log[done:i + 1]:
                moved[shape] = pos
            done = i + 1
            spec, params = render_check.scene_state(c["scene"], moved)
            states.append(params)
        xs = np.tile(self.pixels % c["width"], len(picks))
        ys = np.tile(self.pixels // c["width"], len(picks))
        frames = np.repeat([self.log[i][0] for i in picks], n)
        sids = np.repeat(np.arange(len(picks)), n)
        samples = self.ref.trace_samples(
            spec, states, xs, ys, frames, sids, width=c["width"],
            height=c["height"], bounces=c["bounces"], fov=c["fov"],
            device=self.device, lowered=lowered,
            options=c["renderer"]["options"])
        return samples.cpu().numpy().reshape(len(picks), n, 3)
