"""Application layer: configuration, timing, the CLI, the live-editing
demo and TUI (JAX package: ``app/``).  ``__all__`` is the JAX package's."""

from .config import Constants, Settings
from .perf import TimePackage, rays_per_second

__all__ = ["Constants", "Settings", "TimePackage", "rays_per_second"]
