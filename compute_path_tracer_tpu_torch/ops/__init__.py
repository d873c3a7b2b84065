"""Per-pixel device math: RNG, camera, AABB slabs, tonemapping."""
