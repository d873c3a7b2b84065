"""Runtime configuration: the reference's Settings and Constants uniform
analogs (JAX package: ``app/config.py``; reference
path_tracer.rs:149-163)."""

from __future__ import annotations

import dataclasses

from ..constants import DEFAULT_BOUNCES, DEFAULT_FOV


@dataclasses.dataclass
class Settings:
    """User-tweakable render settings (path_tracer.rs:157-163).

    debug: 0 path trace, 1 normals+AABB, 2 albedo, 3 bounce heatmap (0..=3)
    bounces: path-trace bounce budget (0..=32)
    scale: resolution scale factor, render size = window size * scale (0.1..=1.0)
    fov: z component of the un-normalized ray direction (0..=5)
    """

    # Default 1 (normals view) is reference-faithful (path_tracer.rs:159);
    # the CLI overrides it to 0 (full path trace).
    debug: int = 1
    bounces: int = DEFAULT_BOUNCES
    scale: float = 1.0
    fov: float = DEFAULT_FOV
    # In the reference's Settings uniform but never read by its kernel; kept
    # for config parity.
    aabb: int = 0

    def validate(self) -> "Settings":
        if not 0 <= self.debug <= 3:
            raise ValueError("debug must be in 0..=3")
        if not 0 <= self.bounces <= 32:
            raise ValueError("bounces must be in 0..=32")
        if not 0.1 <= self.scale <= 1.0:
            raise ValueError("scale must be in 0.1..=1.0")
        if not 0.0 <= self.fov <= 5.0:
            raise ValueError("fov must be in 0..=5")
        if self.aabb not in (0, 1):
            raise ValueError("aabb must be 0 or 1")
        return self


@dataclasses.dataclass
class Constants:
    """Per-frame driver-set state (path_tracer.rs:149-155)."""

    time: float = 0.0
    frame: int = 0
    aspect: float = 1.0
    last_clear: int = 0
