"""Hand-written CUDA kernels for Hopper (``csrc/``), their build script and their
torch wrappers.  Each wrapper counts its launches in its module's
``LAUNCHES``."""

from .megakernel import render_frame_megakernel, render_frame_megakernel_plain

__all__ = ["render_frame_megakernel", "render_frame_megakernel_plain"]
