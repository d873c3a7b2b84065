"""Frame timing and throughput metrics.

The TimePackage analog (reference: src/packages/time_package.rs): delta time,
a rolling-average FPS recomputed every 0.5 s over at most 1000 samples, and
rays/s accounting derived from the frame geometry (JAX package:
``app/perf.py``).
"""

from __future__ import annotations

import time
from collections import deque


class TimePackage:
    """Rolling FPS meter (time_package.rs:4-52)."""

    MAX_SAMPLES = 1000
    REFRESH_INTERVAL = 0.5

    def __init__(self):
        self.start_time = time.perf_counter()
        self.last_frame = self.start_time
        self.delta_time = 0.0
        self.fps: float = 0.0
        self._samples: deque = deque(maxlen=self.MAX_SAMPLES)
        self._last_refresh = self.start_time

    def update(self) -> None:
        now = time.perf_counter()
        self.delta_time = now - self.last_frame
        self.last_frame = now
        if self.delta_time > 0:
            self._samples.append(1.0 / self.delta_time)
        if now - self._last_refresh >= self.REFRESH_INTERVAL and self._samples:
            self.fps = sum(self._samples) / len(self._samples)
            self._last_refresh = now

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self.start_time


def rays_per_second(
    width: int,
    height: int,
    frames: int,
    seconds: float,
    bounces: int = 0,
    samples_per_pixel: int = 1,
) -> float:
    """Primary-ray throughput; with ``bounces`` > 0 counts one ray per bounce
    segment per sample (the rays/s metric of BASELINE.json)."""
    if seconds <= 0:
        return float("inf")
    rays = width * height * samples_per_pixel * frames * max(1, bounces + 1)
    return rays / seconds
