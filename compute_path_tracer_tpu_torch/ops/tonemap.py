"""Tonemapping / color-correction post-process (JAX package:
``ops/tonemap.py``; reference render_texture_shader.wgsl:20-72).

Exposure -> ACES filmic curve -> linear-to-sRGB, plus the gamma-2.2 encode
the reference's PNG exporter applies instead (state.rs:280-292).
"""

from __future__ import annotations

import torch

from ..vecmath import Vec3, vclamp


def aces_film(x: Vec3) -> Vec3:
    """ACES filmic tone-mapping curve fit (render_texture_shader.wgsl:49-56)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14

    def chan(v):
        return torch.clamp((v * (a * v + b)) / (v * (c * v + d) + e), 0.0, 1.0)

    return Vec3(chan(x.x), chan(x.y), chan(x.z))


def linear_to_srgb(rgb: Vec3) -> Vec3:
    """Piecewise sRGB OETF (render_texture_shader.wgsl:30-38)."""
    rgb = vclamp(rgb, 0.0, 1.0)

    def chan(v):
        hi = torch.pow(v, 1.0 / 2.4) * 1.055 - 0.055
        lo = v * 12.92
        return torch.where(v < 0.0031308, lo, hi)

    return Vec3(chan(rgb.x), chan(rgb.y), chan(rgb.z))


def srgb_to_linear(rgb: Vec3) -> Vec3:
    """Inverse sRGB transfer (render_texture_shader.wgsl:40-47)."""
    rgb = vclamp(rgb, 0.0, 1.0)

    def chan(v):
        hi = torch.pow((v + 0.055) / 1.055, 2.4)
        lo = v / 12.92
        return torch.where(v < 0.04045, lo, hi)

    return Vec3(chan(rgb.x), chan(rgb.y), chan(rgb.z))


def color_correction(color: Vec3, exposure: float = 1.0) -> Vec3:
    """Display transform: exposure * ACES * sRGB (wgsl:62-72)."""
    return linear_to_srgb(aces_film(color * exposure))


def gamma_encode(color: Vec3, gamma: float = 2.2) -> Vec3:
    """Plain power-law encode of the reference's PNG export
    (state.rs:280-292)."""
    c = vclamp(color, 0.0, 1.0)
    return Vec3(*(torch.pow(v, 1.0 / gamma) for v in c))
