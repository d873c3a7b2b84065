"""Editable scene model: CSG tree of transforms, materials and SDF shapes.

The user-facing scene description, mirroring the reference's sdf_editor data
model (reference: src/sdf_editor/{containers,data_structures}.rs): a list of
root :class:`Union` nodes, each owning a :class:`Transform`, a CSG op, child
unions and child :class:`Shape` leaves; shapes carry a transform, an 18-term
:class:`Material` and one primitive kind with its size params.

The model is mutable host-side Python.  Rendering never touches it directly:
:mod:`.compile` lowers it to a static, hashable
``SceneSpec`` plus a flat f32 parameter vector (the ``data[]`` analog).
"""

from __future__ import annotations

import copy
from typing import List, Optional

from .params import S1, S2, Param, ParamV3

# Shape kinds (reference: containers.rs:259-319 Shapes enum).
KIND_SPHERE = 0
KIND_CUBE = 1
KIND_PLANE = 2
KIND_OCTAHEDRON = 3

KIND_NAMES = {
    KIND_SPHERE: "sphere",
    KIND_CUBE: "cube",
    KIND_PLANE: "plane",
    KIND_OCTAHEDRON: "octahedron",
}
KIND_BY_NAME = {v: k for k, v in KIND_NAMES.items()}

# CSG ops (containers.rs:215-219 UnionType).
UNION = "union"
SUBTRACTION = "subtraction"
SMOOTH_UNION = "smooth_union"  # new capability (BASELINE.json config #2)


class Transform:
    """Per-node translate / Euler-rotate / uniform-scale, plus AABB culling
    controls (reference: data_structures.rs:10-27)."""

    def __init__(
        self,
        position: Optional[ParamV3] = None,
        rotation: Optional[ParamV3] = None,
        scale: Optional[Param] = None,
        aabb_exaggeration: Optional[Param] = None,
        aabb: bool = True,
    ):
        self.position = position or ParamV3.xyz("Position", S2, 0.0)
        self.rotation = rotation or ParamV3.xyz("Rotation", S1, 0.0)
        self.scale = scale or Param.ranged("Scale", S1, 1.0, 0.0, float("inf"))
        self.aabb_exaggeration = aabb_exaggeration or Param.ranged(
            "AABB_exaggeration", S2, 1.3, 0.0, 10.0
        )
        self.aabb = aabb

    def params(self):
        return (
            *self.position.params(),
            *self.rotation.params(),
            self.scale,
            self.aabb_exaggeration,
        )

    def rehash(self):
        self.position.rehash()
        self.rotation.rehash()
        self.scale.rehash()
        self.aabb_exaggeration.rehash()

    def to_dict(self):
        return {
            "position": self.position.to_dict(),
            "rotation": self.rotation.to_dict(),
            "scale": self.scale.to_dict(),
            "aabb_exaggeration": self.aabb_exaggeration.to_dict(),
            "aabb": self.aabb,
        }

    @classmethod
    def from_dict(cls, d):
        return cls(
            ParamV3.from_dict(d["position"]),
            ParamV3.from_dict(d["rotation"]),
            Param.from_dict(d["scale"]),
            Param.from_dict(d["aabb_exaggeration"]),
            d["aabb"],
        )


class Material:
    """The 10-field physical material, 18 scalars total
    (reference: data_structures.rs:115-151, test_compute.glsl:45-59)."""

    def __init__(self, **kw):
        self.color = kw.get("color") or ParamV3.rgb("Surface Color")
        self.brightness = kw.get("brightness") or Param.ranged(
            "Brightness", S2, 0.0, 0.0, float("inf")
        )
        self.light_col = kw.get("light_col") or ParamV3.rgb("Light Color")
        self.specular_chance = kw.get("specular_chance") or Param.percent(
            "Spec chance", S1, 0.0
        )
        self.specular_color = kw.get("specular_color") or ParamV3.rgb("Spec color")
        self.roughness = kw.get("roughness") or Param.ranged(
            "Roughness", S1, 0.0, 0.0, float("inf")
        )
        self.ior = kw.get("ior") or Param.free("IOR", S1, 0.0)
        self.refract_chance = kw.get("refract_chance") or Param.percent(
            "Refract chance", S1, 0.0
        )
        self.refract_roughness = kw.get("refract_roughness") or Param.free(
            "Refract roughness", S1, 0.0
        )
        self.refract_color = kw.get("refract_color") or ParamV3.rgb("Refract color")

    def params(self):
        """Params in ``Mat(...)`` constructor order (data_structures.rs:178-194)."""
        return (
            *self.color.params(),
            self.brightness,
            *self.light_col.params(),
            self.specular_chance,
            *self.specular_color.params(),
            self.roughness,
            self.ior,
            self.refract_chance,
            self.refract_roughness,
            *self.refract_color.params(),
        )

    def rehash(self):
        for group in (
            self.color,
            self.light_col,
            self.specular_color,
            self.refract_color,
        ):
            group.rehash()
        for p in (
            self.brightness,
            self.specular_chance,
            self.roughness,
            self.ior,
            self.refract_chance,
            self.refract_roughness,
        ):
            p.rehash()

    _FIELDS_V3 = ("color", "light_col", "specular_color", "refract_color")
    _FIELDS_F = (
        "brightness",
        "specular_chance",
        "roughness",
        "ior",
        "refract_chance",
        "refract_roughness",
    )

    def to_dict(self):
        d = {}
        for f in self._FIELDS_V3:
            d[f] = getattr(self, f).to_dict()
        for f in self._FIELDS_F:
            d[f] = getattr(self, f).to_dict()
        return d

    @classmethod
    def from_dict(cls, d):
        kw = {f: ParamV3.from_dict(d[f]) for f in cls._FIELDS_V3}
        kw.update({f: Param.from_dict(d[f]) for f in cls._FIELDS_F})
        return cls(**kw)


class Shape:
    """A leaf primitive: transform + material + kind + size params
    (reference: containers.rs:322-402)."""

    def __init__(
        self,
        kind: int = KIND_SPHERE,
        name: str = "Shape",
        transform: Optional[Transform] = None,
        material: Optional[Material] = None,
        size: Optional[Param] = None,
        size3: Optional[ParamV3] = None,
    ):
        self.kind = kind
        self.name = name
        self.transform = transform or Transform()
        self.material = material or Material()
        # sphere/octahedron use a scalar size; cube a vec3; plane none
        # (containers.rs:260-273).
        if kind in (KIND_SPHERE, KIND_OCTAHEDRON):
            self.size = size or Param.free("Size", S2, 1.0)
            self.size3 = None
        elif kind == KIND_CUBE:
            self.size = None
            self.size3 = size3 or ParamV3.xyz("Size", S2, 1.0)
        else:
            self.size = None
            self.size3 = None

    def size_params(self):
        if self.size is not None:
            return (self.size,)
        if self.size3 is not None:
            return self.size3.params()
        return ()

    def params(self):
        return (*self.transform.params(), *self.size_params(), *self.material.params())

    def rehash(self):
        self.transform.rehash()
        self.material.rehash()
        if self.size is not None:
            self.size.rehash()
        if self.size3 is not None:
            self.size3.rehash()

    def duplicate(self) -> "Shape":
        """Deep copy with fresh param identities, so the copy gets its own
        slots (reference: containers.rs:135-138 duplicate-with-rehash)."""
        c = copy.deepcopy(self)
        c.rehash()
        return c

    def to_dict(self):
        d = {
            "kind": KIND_NAMES[self.kind],
            "name": self.name,
            "transform": self.transform.to_dict(),
            "material": self.material.to_dict(),
        }
        if self.size is not None:
            d["size"] = self.size.to_dict()
        if self.size3 is not None:
            d["size3"] = self.size3.to_dict()
        return d

    @classmethod
    def from_dict(cls, d):
        return cls(
            KIND_BY_NAME[d["kind"]],
            d.get("name", "Shape"),
            Transform.from_dict(d["transform"]),
            Material.from_dict(d["material"]),
            Param.from_dict(d["size"]) if "size" in d else None,
            ParamV3.from_dict(d["size3"]) if "size3" in d else None,
        )


class Union:
    """An interior CSG node (reference: containers.rs:9-27)."""

    def __init__(
        self,
        name: str = "Union",
        transform: Optional[Transform] = None,
        op: str = UNION,
        children_unions: Optional[List["Union"]] = None,
        children_shapes: Optional[List[Shape]] = None,
        smooth_k: Optional[Param] = None,
    ):
        self.name = name
        self.transform = transform or Transform()
        self.op = op
        self.children_unions = children_unions or []
        self.children_shapes = children_shapes or []
        # Blend radius, only meaningful for op == SMOOTH_UNION.
        self.smooth_k = smooth_k or Param.ranged("Smooth k", S2, 0.25, 1e-4, 10.0)

    def add_union(self, u: "Union") -> "Union":
        self.children_unions.append(u)
        return u

    def add_shape(self, s: Shape) -> Shape:
        self.children_shapes.append(s)
        return s

    def rehash(self):
        self.transform.rehash()
        self.smooth_k.rehash()
        for u in self.children_unions:
            u.rehash()
        for s in self.children_shapes:
            s.rehash()

    def duplicate(self) -> "Union":
        c = copy.deepcopy(self)
        c.rehash()
        return c

    def to_dict(self):
        return {
            "name": self.name,
            "transform": self.transform.to_dict(),
            "op": self.op,
            "smooth_k": self.smooth_k.to_dict(),
            "children_unions": [u.to_dict() for u in self.children_unions],
            "children_shapes": [s.to_dict() for s in self.children_shapes],
        }

    @classmethod
    def from_dict(cls, d):
        return cls(
            d.get("name", "Union"),
            Transform.from_dict(d["transform"]),
            d["op"],
            [cls.from_dict(u) for u in d["children_unions"]],
            [Shape.from_dict(s) for s in d["children_shapes"]],
            Param.from_dict(d["smooth_k"]) if "smooth_k" in d else None,
        )


class Scene:
    """A list of root unions (reference: sdf_editor.rs:14-17 header_unions)."""

    def __init__(self, roots: Optional[List[Union]] = None, name: str = "scene"):
        self.roots = roots if roots is not None else [Union()]
        self.name = name

    def add_root(self, u: Union) -> Union:
        self.roots.append(u)
        return u

    def iter_shapes(self):
        """All shapes in compile order (child unions before own shapes,
        matching the map-codegen walk in containers.rs:143-166)."""

        def walk(u: Union):
            for cu in u.children_unions:
                yield from walk(cu)
            yield from u.children_shapes

        for root in self.roots:
            yield from walk(root)

    def to_dict(self):
        return {"name": self.name, "roots": [u.to_dict() for u in self.roots]}

    @classmethod
    def from_dict(cls, d):
        return cls([Union.from_dict(u) for u in d["roots"]], d.get("name", "scene"))
