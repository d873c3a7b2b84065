"""Scene compiler: CSG tree -> static SceneSpec + flat f32 parameter vector.

Carried over unchanged from the JAX package's ``scene/compile.py`` (numpy
only); :func:`params_from_numpy` is the port's entry for the flat vector.
The analog of the reference's GLSL codegen (reference:
src/sdf_editor/sdf_editor.rs:186-246 and containers.rs:143-179): instead of
emitting shader source, compilation produces

* a :class:`SceneSpec` - a frozen, hashable description of the scene
  *structure* (topology, ops, shape kinds, parameter slot indices).  Renderers
  key their static tables on it, so it plays the role of the generated
  ``map()``/``bounds()`` code: changing it rebuilds those tables, like the
  reference's ``remake_pipeline`` (path_tracer.rs:62-76); and
* a flat ``float32`` parameter vector - the ``data[]`` buffer analog
  (primitives.rs:117-129).  Value-only edits produce a new vector via
  :meth:`CompiledScene.refresh` with no recompilation (the cheap half of the
  reference's two-speed update, sdf_editor.rs:35-47), and gradients of the
  rendered image are taken with respect to this vector.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from .model import (
    SMOOTH_UNION,
    SUBTRACTION,
    UNION,
    Material,
    Scene,
    Shape,
    Transform,
    Union,
)
from .params import ParamTable

# CSG op codes used in specs.
OP_UNION = 0
OP_SUBTRACTION = 1
OP_SMOOTH_UNION = 2

_OP_CODES = {UNION: OP_UNION, SUBTRACTION: OP_SUBTRACTION, SMOOTH_UNION: OP_SMOOTH_UNION}


@dataclass(frozen=True)
class TransformSpec:
    pos: Tuple[int, int, int]
    rot: Tuple[int, int, int]
    scale: int
    ex: int
    aabb: bool


@dataclass(frozen=True)
class ShapeSpec:
    kind: int
    # size parameter slots: () for plane, (r,) for sphere/octahedron,
    # (x, y, z) for cube
    size: Tuple[int, ...]
    transform: TransformSpec
    # 18 material slots in Mat(...) constructor order
    # (data_structures.rs:178-194)
    material: Tuple[int, ...]
    # dense id; doubles as the AABB check index (containers.rs:57-66) and the
    # row in the material table
    shape_id: int


@dataclass(frozen=True)
class UnionSpec:
    transform: TransformSpec
    op: int
    smooth_k: int
    children_unions: Tuple["UnionSpec", ...]
    children_shapes: Tuple[ShapeSpec, ...]


@dataclass(frozen=True)
class SceneSpec:
    roots: Tuple[UnionSpec, ...]
    n_shapes: int
    n_params: int

    def iter_shapes(self):
        def walk(u: UnionSpec):
            for cu in u.children_unions:
                yield from walk(cu)
            yield from u.children_shapes

        for root in self.roots:
            yield from walk(root)


def _compile_transform(t: Transform, table: ParamTable) -> TransformSpec:
    return TransformSpec(
        pos=(table.slot(t.position.x), table.slot(t.position.y), table.slot(t.position.z)),
        rot=(table.slot(t.rotation.x), table.slot(t.rotation.y), table.slot(t.rotation.z)),
        scale=table.slot(t.scale),
        ex=table.slot(t.aabb_exaggeration),
        aabb=t.aabb,
    )


def _compile_material(m: Material, table: ParamTable) -> Tuple[int, ...]:
    return tuple(table.slot(p) for p in m.params())


def _compile_shape(s: Shape, table: ParamTable, counter: list) -> ShapeSpec:
    tspec = _compile_transform(s.transform, table)
    size = tuple(table.slot(p) for p in s.size_params())
    mat = _compile_material(s.material, table)
    sid = counter[0]
    counter[0] += 1
    return ShapeSpec(kind=s.kind, size=size, transform=tspec, material=mat, shape_id=sid)


def _compile_union(u: Union, table: ParamTable, counter: list) -> UnionSpec:
    # Walk order matches the reference map codegen: this node's transform,
    # then child unions, then child shapes (containers.rs:143-166).
    if u.children_unions and u.children_shapes:
        first = u.children_shapes[0]
        warnings.warn(
            f"union {u.name!r} mixes child unions with shapes: per the "
            "reference fold (containers.rs:244-252) its first shape "
            f"({first.name!r}) ASSIGNS into the accumulator and overwrites "
            "the child unions' contribution whenever its AABB guard passes"
            + (" (always: AABB disabled)" if not first.transform.aabb else "")
            + "; put shapes in a sibling union if that is not intended",
            stacklevel=2,
        )
    tspec = _compile_transform(u.transform, table)
    k_slot = table.slot(u.smooth_k) if u.op == SMOOTH_UNION else -1
    children_u = tuple(_compile_union(cu, table, counter) for cu in u.children_unions)
    children_s = tuple(_compile_shape(cs, table, counter) for cs in u.children_shapes)
    return UnionSpec(
        transform=tspec,
        op=_OP_CODES[u.op],
        smooth_k=k_slot,
        children_unions=children_u,
        children_shapes=children_s,
    )


class CompiledScene:
    """The result of compiling a scene: static spec + dynamic params.

    ``spec`` is hashable and keys the renderers' static tables; ``params``
    is the flat float32 vector consumed (and differentiated) by renderers.
    """

    def __init__(self, spec: SceneSpec, table: ParamTable):
        self.spec = spec
        self.table = table

    @property
    def params(self) -> np.ndarray:
        return self.table.vector()

    def refresh(self, scene: Scene) -> np.ndarray:
        """Re-read every param value from the scene into the vector.

        Raises ``KeyError`` if the scene's structure changed since compile
        (an unregistered param identity), in which case the caller must
        recompile - the same contract as the reference's queue_update vs
        queue_compile dirty flags (primitives.rs:161-190).
        """
        for root in scene.roots:
            self._refresh_union(root)
        return self.table.vector()

    def _refresh_union(self, u: Union):
        for p in u.transform.params():
            self.table.refresh(p)
        if u.op == SMOOTH_UNION:
            self.table.refresh(u.smooth_k)
        for cu in u.children_unions:
            self._refresh_union(cu)
        for cs in u.children_shapes:
            for p in cs.params():
                self.table.refresh(p)


def compile_scene(scene: Scene) -> CompiledScene:
    """Lower a scene tree to (SceneSpec, param vector)."""
    table = ParamTable()
    counter = [0]
    roots = tuple(_compile_union(root, table, counter) for root in scene.roots)
    spec = SceneSpec(roots=roots, n_shapes=counter[0], n_params=len(table))
    return CompiledScene(spec, table)


def params_from_numpy(np_params, spec: SceneSpec, device) -> torch.Tensor:
    """The flat parameter vector as a float32 tensor on ``device``.

    ``np_params`` must be a 1-D float32 array of length ``spec.n_params``:
    a vector compiled for another structure would index the wrong slots.
    """
    arr = np.asarray(np_params)
    if arr.dtype != np.float32:
        raise TypeError(f"params must be float32, got {arr.dtype}")
    if arr.shape != (spec.n_params,):
        raise ValueError(
            f"params shape {arr.shape} does not match the spec's "
            f"({spec.n_params},)")
    return torch.from_numpy(arr.copy()).to(device)
