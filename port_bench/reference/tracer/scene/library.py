"""Built-in example and benchmark scenes.

The reference ships no scene library (its ``assets/maps`` is empty); these
constructors provide the configurations named in BASELINE.json: the
sphere+plane smoke scene, a 16-primitive CSG scene, and the 64-primitive
benchmark scene used for rays/s measurements.
"""

from __future__ import annotations

import math

from .model import (
    KIND_CUBE,
    KIND_OCTAHEDRON,
    KIND_PLANE,
    KIND_SPHERE,
    SMOOTH_UNION,
    SUBTRACTION,
    Scene,
    Shape,
    Union,
)


def _set_mat(shape, color=(1.0, 1.0, 1.0), brightness=0.0, light=(1.0, 1.0, 1.0),
             spec=0.0, spec_col=(1.0, 1.0, 1.0), roughness=0.0):
    m = shape.material
    m.color.set(*color)
    m.brightness.set(brightness)
    m.light_col.set(*light)
    m.specular_chance.set(spec)
    m.specular_color.set(*spec_col)
    m.roughness.set(roughness)
    return shape


def sphere_and_plane() -> Scene:
    """BASELINE.json config #1: a sphere over a ground plane, plus an
    emissive sky sphere so the path tracer has a light to find."""
    root = Union(name="Root")

    ball = root.add_shape(Shape(KIND_SPHERE, name="Ball"))
    ball.size.set(1.0)
    ball.transform.position.set(0.0, 0.0, 0.0)
    _set_mat(ball, color=(0.9, 0.3, 0.2))

    ground = root.add_shape(Shape(KIND_PLANE, name="Ground"))
    ground.transform.position.set(0.0, -1.0, 0.0)
    ground.transform.aabb = False  # infinite plane can't be boxed
    _set_mat(ground, color=(0.6, 0.6, 0.6))

    sky = root.add_shape(Shape(KIND_SPHERE, name="SkyLight"))
    sky.size.set(20.0)
    sky.transform.position.set(0.0, 44.0, 0.0)
    sky.transform.aabb = False
    _set_mat(sky, color=(0.0, 0.0, 0.0), brightness=4.0, light=(1.0, 0.95, 0.9))

    return Scene([root], name="sphere_and_plane")


def csg_demo() -> Scene:
    """Nested unions exercising every reference CSG feature: subtraction,
    per-node transforms with scale correction, duplicate shapes, AABB
    toggles (reference features per SURVEY.md §2 checklist)."""
    root = Union(name="Root")

    # A cube with a sphere bite taken out of it, built the reference way:
    # in a Subtraction union the *last* combined hit is the base
    # (containers.rs:244-252 fold order).
    carved = root.add_union(Union(name="Carved", op=SUBTRACTION))
    carved.transform.position.set(-1.2, 0.0, 0.0)
    carved.transform.rotation.set(0.3, 0.6, 0.0)

    bite = carved.add_shape(Shape(KIND_SPHERE, name="Bite"))
    bite.size.set(0.9)
    bite.transform.position.set(0.5, 0.4, -0.4)
    _set_mat(bite, color=(0.9, 0.8, 0.2))

    block = carved.add_shape(Shape(KIND_CUBE, name="Block"))
    block.size3.set(0.7, 0.7, 0.7)
    _set_mat(block, color=(0.3, 0.5, 0.9))

    # A scaled sub-union holding a small sphere + octahedron pair.
    cluster = root.add_union(Union(name="Cluster"))
    cluster.transform.position.set(1.3, 0.2, 0.3)
    cluster.transform.scale.set(0.6)

    orb = cluster.add_shape(Shape(KIND_SPHERE, name="Orb"))
    orb.size.set(0.8)
    _set_mat(orb, color=(0.9, 0.9, 0.9), spec=0.6, roughness=0.1)

    gem = cluster.add_shape(Shape(KIND_OCTAHEDRON, name="Gem"))
    gem.size.set(0.9)
    gem.transform.position.set(0.0, 1.4, 0.0)
    _set_mat(gem, color=(0.8, 0.3, 0.8))

    # Ground and lamp live in their OWN root union: a shape added next to
    # child unions would clobber them via the reference's first-shape-assign
    # fold (containers.rs:244-252; see scene/compile.py warning).
    env = Union(name="Environment")
    ground = env.add_shape(Shape(KIND_PLANE, name="Ground"))
    ground.transform.position.set(0.0, -1.2, 0.0)
    ground.transform.aabb = False
    _set_mat(ground, color=(0.55, 0.55, 0.55))

    lamp = env.add_shape(Shape(KIND_SPHERE, name="Lamp"))
    lamp.size.set(8.0)
    lamp.transform.position.set(4.0, 20.0, -6.0)
    lamp.transform.aabb = False
    _set_mat(lamp, color=(0.0, 0.0, 0.0), brightness=6.0, light=(1.0, 0.9, 0.8))

    return Scene([root, env], name="csg_demo")


def blend_demo() -> Scene:
    """BASELINE.json config #2 flavor: smooth-min blended blobs."""
    root = Union(name="Root")
    blob = root.add_union(Union(name="Blobs", op=SMOOTH_UNION))
    blob.smooth_k.set(0.35)
    for i in range(4):
        a = i * (2.0 * math.pi / 4.0)
        s = blob.add_shape(Shape(KIND_SPHERE, name=f"Blob{i}"))
        s.size.set(0.55)
        s.transform.position.set(0.8 * math.cos(a), 0.35 * math.sin(2 * a), 0.8 * math.sin(a))
        _set_mat(s, color=(0.4 + 0.15 * i, 0.8 - 0.15 * i, 0.6))

    # Separate root: see csg_demo note on the first-shape-assign fold.
    env = Union(name="Environment")
    ground = env.add_shape(Shape(KIND_PLANE, name="Ground"))
    ground.transform.position.set(0.0, -1.0, 0.0)
    ground.transform.aabb = False
    _set_mat(ground, color=(0.6, 0.6, 0.6))

    lamp = env.add_shape(Shape(KIND_SPHERE, name="Lamp"))
    lamp.size.set(10.0)
    lamp.transform.position.set(0.0, 25.0, -5.0)
    lamp.transform.aabb = False
    _set_mat(lamp, color=(0.0, 0.0, 0.0), brightness=5.0, light=(1.0, 1.0, 1.0))

    return Scene([root, env], name="blend_demo")


def glass_demo() -> Scene:
    """Refraction showcase: a glass sphere in front of colored objects
    (exercises the refraction extension; the reference reserves these
    material slots but never shades them)."""
    root = Union(name="Root")

    glass = root.add_shape(Shape(KIND_SPHERE, name="GlassBall"))
    glass.size.set(0.8)
    glass.transform.position.set(0.0, 0.0, -0.6)
    m = glass.material
    m.color.set(1.0, 1.0, 1.0)
    m.specular_chance.set(0.06)
    m.specular_color.set(1.0, 1.0, 1.0)
    m.refract_chance.set(0.92)
    m.refract_color.set(0.95, 0.97, 1.0)
    m.ior.set(0.5)  # refractive index 1.5

    behind = root.add_shape(Shape(KIND_CUBE, name="Backdrop"))
    behind.size3.set(0.4, 0.4, 0.4)
    behind.transform.position.set(0.6, 0.1, 1.6)
    behind.transform.rotation.set(0.0, 0.7, 0.0)
    _set_mat(behind, color=(0.9, 0.25, 0.2))

    env = Union(name="Environment")
    ground = env.add_shape(Shape(KIND_PLANE, name="Ground"))
    ground.transform.position.set(0.0, -1.0, 0.0)
    ground.transform.aabb = False
    _set_mat(ground, color=(0.55, 0.6, 0.65))

    lamp = env.add_shape(Shape(KIND_SPHERE, name="Lamp"))
    lamp.size.set(8.0)
    lamp.transform.position.set(-5.0, 18.0, -8.0)
    lamp.transform.aabb = False
    _set_mat(lamp, color=(0.0, 0.0, 0.0), brightness=6.0, light=(1.0, 0.96, 0.9))

    return Scene([root, env], name="glass_demo")


def benchmark_scene(n_prims: int = 64, seed: int = 7,
                    spacing: float = 1.6) -> Scene:
    """The 64-primitive CSG benchmark scene from BASELINE.json: a jittered
    grid of spheres/cubes/octahedra with varied materials, a ground plane and
    two emissive spheres.  Deterministic for reproducible benchmarks.

    ``spacing`` scales the grid pitch (default 1.6 = the BASELINE scene);
    large values give a SPARSE scene (mostly empty tiles) for evaluating the
    opt-in culling variants (benchmarks/optin_benchmark.py)."""
    import random

    rng = random.Random(seed)
    root = Union(name="Root")

    n_grid = max(1, n_prims - 3)  # leave room for ground + two lights
    side = max(1, round(n_grid ** (1.0 / 3.0)))
    placed = 0
    for ix in range(side + 1):
        for iy in range(side + 1):
            for iz in range(side + 1):
                if placed >= n_grid:
                    break
                kind = rng.choice((KIND_SPHERE, KIND_SPHERE, KIND_CUBE, KIND_OCTAHEDRON))
                s = root.add_shape(Shape(kind, name=f"P{placed}"))
                x = (ix - side / 2.0) * spacing + rng.uniform(-0.3, 0.3)
                y = (iy - side / 2.0) * spacing + rng.uniform(-0.3, 0.3)
                z = (iz - side / 2.0) * spacing + rng.uniform(-0.3, 0.3) + 3.0
                s.transform.position.set(x, y, z)
                s.transform.rotation.set(
                    rng.uniform(0, 3.14), rng.uniform(0, 3.14), 0.0
                )
                if kind == KIND_CUBE:
                    s.size3.set(*(rng.uniform(0.25, 0.5) for _ in range(3)))
                else:
                    s.size.set(rng.uniform(0.3, 0.55))
                _set_mat(
                    s,
                    color=(rng.uniform(0.2, 0.95), rng.uniform(0.2, 0.95), rng.uniform(0.2, 0.95)),
                    spec=rng.choice((0.0, 0.0, 0.3, 0.7)),
                    roughness=rng.uniform(0.0, 0.6),
                )
                placed += 1

    ground = root.add_shape(Shape(KIND_PLANE, name="Ground"))
    ground.transform.position.set(0.0, -side * 1.0 - 1.0, 0.0)
    ground.transform.aabb = False
    _set_mat(ground, color=(0.5, 0.5, 0.5))

    for i, (lx, ly, lz) in enumerate(((10.0, 18.0, -8.0), (-12.0, 14.0, 6.0))):
        lamp = root.add_shape(Shape(KIND_SPHERE, name=f"Lamp{i}"))
        lamp.size.set(6.0)
        lamp.transform.position.set(lx, ly, lz)
        lamp.transform.aabb = False
        _set_mat(lamp, color=(0.0, 0.0, 0.0), brightness=8.0, light=(1.0, 0.93, 0.85))

    name = (f"benchmark_{n_prims}" if spacing == 1.6
            else f"benchmark_{n_prims}_sp{spacing:g}")
    return Scene([root], name=name)


def edge_demo() -> Scene:
    """A flat-lit (emissive-only) sphere on black: radiance is constant
    inside the silhouette, so position gradients exist ONLY at the edge -
    the showcase scene for reparameterized edge gradients
    (diff/vjp.py edge_grad; CLI: optimize --edge-grad --perturb-what
    position --scene edge_demo --bounces 0)."""
    root = Union(name="Root")
    ball = root.add_shape(Shape(KIND_SPHERE, name="Ball"))
    ball.size.set(0.8)
    _set_mat(ball, color=(0.0, 0.0, 0.0), brightness=2.0, light=(1.0, 0.9, 0.7))
    return Scene([root], name="edge_demo")
