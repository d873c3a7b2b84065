"""Counter-based per-pixel RNG, bit-exact with the JAX package's ``ops/rng.py``.

The wang hash of the reference (rng.glsl:1-36) with uint32 wraparound.  The
state is an int64 tensor holding uint32 values: torch has no right shift for
uint32 on the CPU, and in int64 every product below stays under 2**62, so
masking to 32 bits after each multiply gives the uint32 result exactly.  The
CUDA kernel computes the same chain in ``uint32_t``.

Every draw returns ``(new_state, value)``.
"""

from __future__ import annotations

import torch

from ..constants import PI2
from ..vecmath import Vec3, sqrt_rn

_MASK = 0xFFFFFFFF
_PI2_F32 = torch.tensor(PI2, dtype=torch.float32).item()


def wang_hash(state):
    """One step of the wang hash; returns the new state (rng.glsl:1-9)."""
    state = (state ^ 61) ^ (state >> 16)
    state = (state * 9) & _MASK
    state = state ^ (state >> 4)
    state = (state * 0x27D4EB2D) & _MASK
    state = state ^ (state >> 15)
    return state


def _u32_to_f32(v):
    """uint32 -> float32 rounded to nearest: the two 16-bit halves are exact
    in float32 and the one rounding is in the final add."""
    hi = (v >> 16).to(torch.float32)
    lo = (v & 0xFFFF).to(torch.float32)
    return hi * 65536.0 + lo


def random_float01(state):
    """Uniform float in [0, 1) (rng.glsl:11-14): float(hash) / 2^32."""
    state = wang_hash(state)
    return state, _u32_to_f32(state) * 2.0**-32


def random_unit_vector(state):
    """Uniform direction on the sphere via z/angle sampling (rng.glsl:16-24)."""
    state, r1 = random_float01(state)
    state, r2 = random_float01(state)
    z = r1 * 2.0 - 1.0
    a = r2 * _PI2_F32
    r = sqrt_rn(1.0 - z * z)
    return state, Vec3(r * torch.cos(a), r * torch.sin(a), z)


def gen_rng(px, py, frame: int, width: int, height: int):
    """Per-pixel seed from integer pixel coords + frame (rng.glsl:26-36).

    The reference's float scaling ``(x*0.5+0.5) * W`` stays in float32 and
    truncates to an integer, as in the JAX version: promoting it to double
    would change seeds.
    """
    fx = (px.to(torch.float32) * 0.5 + 0.5) * float(width)
    fy = (py.to(torch.float32) * 0.5 + 0.5) * float(height)
    seed = (fx.to(torch.int32).to(torch.int64) * 1973
            + fy.to(torch.int32).to(torch.int64) * 9277
            + (int(frame) & _MASK) * 26699)
    return (seed & _MASK) | 1
