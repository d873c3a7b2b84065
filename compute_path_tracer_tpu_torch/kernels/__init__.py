"""Hand-written CUDA kernels for Hopper (``csrc/``), their build script and their
torch wrappers.  Each wrapper counts its launches in its module's
``LAUNCHES``."""

from .march import march_rays, march_rays_plain
from .megakernel import (
    render_accumulated_megakernel,
    render_frame_megakernel,
    render_frame_megakernel_plain,
)
from .train import fused_planes, fused_planes_plain, make_fused_value_and_grad

__all__ = ["fused_planes", "fused_planes_plain", "make_fused_value_and_grad",
           "march_rays", "march_rays_plain", "render_accumulated_megakernel",
           "render_frame_megakernel",
           "render_frame_megakernel_plain"]
