"""Scene system: editable CSG tree, param registry, compiler, persistence.

Carried over from the JAX package's ``scene/`` with behaviour unchanged
(numpy only): the same tree-of-unions data model, stable param identities,
two-speed compile/refresh, JSON save/load and duplicate-with-rehash, lowered
to a hashable SceneSpec plus a flat f32 vector.  ``params_from_numpy`` and
``convert_scene`` are the port's additions.
"""

from .compile import (
    OP_SMOOTH_UNION,
    OP_SUBTRACTION,
    OP_UNION,
    CompiledScene,
    SceneSpec,
    ShapeSpec,
    TransformSpec,
    UnionSpec,
    compile_scene,
    params_from_numpy,
)
from .io import convert_scene, list_maps, load_map, load_scene, save_map, save_scene
from .library import benchmark_scene, blend_demo, csg_demo, edge_demo, glass_demo, sphere_and_plane
from .model import (
    KIND_CUBE,
    KIND_OCTAHEDRON,
    KIND_PLANE,
    KIND_SPHERE,
    SMOOTH_UNION,
    SUBTRACTION,
    UNION,
    Material,
    Scene,
    Shape,
    Transform,
    Union,
)
from .params import S1, S2, S3, Param, ParamTable, ParamV3

__all__ = [
    "OP_SMOOTH_UNION",
    "OP_SUBTRACTION",
    "OP_UNION",
    "CompiledScene",
    "SceneSpec",
    "ShapeSpec",
    "TransformSpec",
    "UnionSpec",
    "compile_scene",
    "params_from_numpy",
    "convert_scene",
    "list_maps",
    "load_map",
    "load_scene",
    "save_map",
    "save_scene",
    "benchmark_scene",
    "blend_demo",
    "csg_demo",
    "edge_demo",
    "glass_demo",
    "sphere_and_plane",
    "KIND_CUBE",
    "KIND_OCTAHEDRON",
    "KIND_PLANE",
    "KIND_SPHERE",
    "SMOOTH_UNION",
    "SUBTRACTION",
    "UNION",
    "Material",
    "Scene",
    "Shape",
    "Transform",
    "Union",
    "S1",
    "S2",
    "S3",
    "Param",
    "ParamTable",
    "ParamV3",
]
