"""Progressive rendering of a still: frames one after another into the
session's running mean, as ``render --frames N`` runs them, with no sync
between frames; the window ends in ``synchronize()``.

The seed sets the frame counter the window starts at (each pixel's RNG
stream), and the sample of pixels the check reads.  After the window the
reference traces each sampled pixel for every frame the window rendered
and takes the same running mean, through the reference module the
configuration's renderer names."""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from ..reference import load, render_check
from .render import make_session, release, sample_pixels, seeded, spans, sync


class Cell:
    def __init__(self, config: dict, mix: dict, seed: int, device):
        self.config, self.mix, self.device = config, mix, device
        self.ref = load(config["renderer"]["reference"])
        self.reference_s = 0.0
        rng = seeded(seed)
        self.start = int(rng.integers(0, mix["start_frame_max"]))
        self.pixels = sample_pixels(rng, config, mix["check_pixels"])
        self.count_rows = np.sort(rng.choice(config["height"],
                                             mix["count_rows"], replace=False))
        _scene, self.session = make_session(config, device)
        for _ in range(mix["warmup_frames"]):
            self.session.step()
        sync(device)
        self.session.reset_accumulation()
        self.session.frame = self.start
        self.frames = 0

    def window(self, seconds: float, traced: bool) -> dict:
        span, session = spans(traced), self.session
        frames = 0
        with span("bench.window"):
            t0 = time.perf_counter()
            end = t0 + seconds
            while frames == 0 or time.perf_counter() < end:
                with span("bench.step"):
                    session.step()
                frames += 1
            with span("bench.sync"):
                sync(self.device)
            wall = time.perf_counter() - t0
        self.frames = frames
        return {"units": frames, "metrics": {"frame_ms": wall / frames * 1e3}}

    def check(self) -> dict:
        """``pixel_rel_l1``: the accumulator at the sampled pixels against
        the reference's."""
        got = self.session.accum.reshape(-1, 3)[
            torch.as_tensor(self.pixels, device=self.session.accum.device)]
        got = got.cpu().numpy()
        self.session = None
        release(self.device)
        self.want = self.reference()
        return {"pixel_rel_l1": render_check.rel_l1(got, self.want)}

    def control(self) -> dict:
        """The check's numbers with the control in the program's place:
        the reference in bfloat16 (after ``check``)."""
        return {"pixel_rel_l1": render_check.rel_l1(
            self.reference(lowered=True), self.want)}

    def reference(self, lowered: bool = False) -> np.ndarray:
        """The reference's accumulator at the sampled pixels."""
        c, n, f = self.config, len(self.pixels), self.frames
        spec, params = render_check.scene_state(c["scene"])
        xs = np.repeat(self.pixels % c["width"], f)
        ys = np.repeat(self.pixels // c["width"], f)
        frames = np.tile(np.arange(self.start, self.start + f), n)
        samples = self.ref.trace_samples(
            spec, [params], xs, ys, frames, np.zeros_like(xs),
            width=c["width"], height=c["height"], bounces=c["bounces"],
            fov=c["fov"], device=self.device,
            options=c["renderer"]["options"], lowered=lowered)
        return render_check.running_mean(samples.cpu().numpy().reshape(n, f, 3))

    @functools.cached_property
    def frame_work(self):
        """``(operations, bytes)`` of one frame: the guarded march of the
        sampled rows at the window's first frame, counted on the frozen
        renderer and scaled to the frame; bytes the accumulator read and
        written once."""
        c = self.config
        xs = np.tile(np.arange(c["width"]), len(self.count_rows))
        ys = np.repeat(self.count_rows, c["width"])
        spec, params = render_check.scene_state(c["scene"])
        tally = {}
        self.ref.trace_samples(
            spec, [params], xs, ys, np.full_like(xs, self.start),
            np.zeros_like(xs), width=c["width"], height=c["height"],
            bounces=c["bounces"], fov=c["fov"], device=self.device,
            options=c["renderer"]["options"], count=tally)
        scale = c["height"] / len(self.count_rows)
        ops = self.ref.work_ops(tally, spec) * scale
        return ops, 2.0 * 12 * c["width"] * c["height"]

