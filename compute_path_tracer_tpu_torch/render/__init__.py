"""Renderer layers: baked coefficients, packed shape tables, shading."""
