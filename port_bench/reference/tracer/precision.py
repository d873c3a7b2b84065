"""The working precision of the reference's march and shading state.

The reference computes in float32, as the configurations state.  The
correctness control lowers it: inside ``lowered(torch.bfloat16)`` every
map value, march distance, hit point and gathered radiance is rounded to
bfloat16, the precision a cheaper march would keep its state in."""

from __future__ import annotations

import contextlib

import torch

_DTYPE = None


def quantize(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the working precision, in its own dtype."""
    return x if _DTYPE is None else x.to(_DTYPE).to(x.dtype)


@contextlib.contextmanager
def lowered(dtype=torch.bfloat16):
    global _DTYPE
    saved, _DTYPE = _DTYPE, dtype
    try:
        yield
    finally:
        _DTYPE = saved
