"""Leaf parameters with stable identities and the flat parameter registry.

This is the "differentiable part" of the scene system: every editable number
in a scene is a :class:`Param` with a random 128-bit identity, and compiling a
scene registers each param into a :class:`ParamTable` that deduplicates by
identity and hands back a slot index into one flat f32 vector.

Mirrors the reference's ``Float``/``V3``/``DataArray`` design
(reference: src/sdf_editor/primitives.rs:117-129, 204-332): literals become
``data[i]`` indirections so value edits refresh the vector without recompiling,
and duplicating a node re-hashes its params so copies get their own slots
(containers.rs:135-138).  The flat vector is additionally the
thing gradients flow into: ``d(image)/d(params)`` is a vector of the same
shape.
"""

from __future__ import annotations

import math
import secrets
from typing import Dict, List, Optional

import numpy as np

# Drag-speed constants (primitives.rs:195-197); kept for editor parity.
S1 = 0.001
S2 = 0.01
S3 = 0.1

# The reference seeds its data array with a sentinel so index 0 is never a
# real parameter (primitives.rs:53-56 `vec![6969.69]`).  Keeping it makes our
# slot indices line up with the reference's generated `data[i]` code.
SENTINEL = 6969.69


def gen_uid() -> int:
    """Random 128-bit identity (primitives.rs:12-17)."""
    return secrets.randbits(128)


class Param:
    """A single named f32 parameter (the reference's ``Float``).

    ``lo``/``hi``/``speed`` are editor metadata (slider range / drag speed)
    and do not constrain the stored value.
    """

    __slots__ = ("val", "lo", "hi", "speed", "name", "uid")

    def __init__(
        self,
        name: str,
        val: float,
        lo: float = -math.inf,
        hi: float = math.inf,
        speed: float = S2,
        uid: Optional[int] = None,
    ):
        self.name = name
        self.val = float(val)
        self.lo = lo
        self.hi = hi
        self.speed = speed
        self.uid = gen_uid() if uid is None else uid

    # Constructors mirroring Float::{new, inv, percent} (primitives.rs:214-240)
    @classmethod
    def ranged(cls, name: str, speed: float, default: float, lo: float, hi: float):
        return cls(name, default, lo, hi, speed)

    @classmethod
    def free(cls, name: str, speed: float, default: float):
        return cls(name, default, -math.inf, math.inf, speed)

    @classmethod
    def percent(cls, name: str, speed: float, default: float):
        return cls(name, default, 0.0, 1.0, speed)

    def rehash(self) -> None:
        """Give this param a fresh identity (used on node duplication)."""
        self.uid = gen_uid()

    def set(self, val: float) -> None:
        self.val = float(val)

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "val": self.val,
            "lo": None if math.isinf(self.lo) else self.lo,
            "hi": None if math.isinf(self.hi) else self.hi,
            "speed": self.speed,
            # uid serialized as hex so scenes keep param identities across
            # save/load, like the reference serializing Float.hash
            # (sdf_editor.rs:131-167 note in SURVEY §3.5).
            "uid": f"{self.uid:032x}",
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Param":
        return cls(
            d["name"],
            d["val"],
            -math.inf if d.get("lo") is None else d["lo"],
            math.inf if d.get("hi") is None else d["hi"],
            d.get("speed", S2),
            int(d["uid"], 16),
        )

    def __repr__(self):
        return f"Param({self.name}={self.val})"


class ParamV3:
    """Three named params forming a vector (the reference's ``V3``)."""

    __slots__ = ("x", "y", "z", "name")

    def __init__(self, name: str, x: Param, y: Param, z: Param):
        self.name = name
        self.x, self.y, self.z = x, y, z

    @classmethod
    def xyz(cls, name: str, speed: float, default: float):
        return cls(
            name,
            Param.free("X", speed, default),
            Param.free("Y", speed, default),
            Param.free("Z", speed, default),
        )

    @classmethod
    def rgb(cls, name: str):
        return cls(
            name,
            Param.free("R", 1.0, 1.0),
            Param.free("G", 1.0, 1.0),
            Param.free("B", 1.0, 1.0),
        )

    @property
    def value(self):
        return (self.x.val, self.y.val, self.z.val)

    def set(self, x: float, y: float, z: float) -> None:
        self.x.set(x)
        self.y.set(y)
        self.z.set(z)

    def rehash(self) -> None:
        self.x.rehash()
        self.y.rehash()
        self.z.rehash()

    def params(self):
        return (self.x, self.y, self.z)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "x": self.x.to_dict(),
            "y": self.y.to_dict(),
            "z": self.z.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ParamV3":
        return cls(
            d["name"],
            Param.from_dict(d["x"]),
            Param.from_dict(d["y"]),
            Param.from_dict(d["z"]),
        )

    def __repr__(self):
        return f"ParamV3({self.name}={self.value})"


class ParamTable:
    """Flat f32 parameter vector with uid-deduplicated slot assignment.

    The DataArray analog (primitives.rs:59-157): ``slot()`` during scene
    compile assigns/reuses indices; ``refresh()`` re-reads values from the
    scene objects into the vector without changing the slot layout (the cheap
    half of the two-speed update).
    """

    def __init__(self):
        self.data: List[float] = [SENTINEL]
        self.seen: Dict[int, int] = {}

    def slot(self, p: Param) -> int:
        idx = self.seen.get(p.uid)
        if idx is None:
            self.data.append(p.val)
            idx = len(self.data) - 1
            self.seen[p.uid] = idx
        return idx

    def refresh(self, p: Param) -> None:
        idx = self.seen.get(p.uid)
        if idx is None:
            raise KeyError(
                f"param {p.name!r} (uid {p.uid:#x}) is not registered; "
                "the scene structure changed - recompile instead of refresh"
            )
        self.data[idx] = p.val

    def vector(self) -> np.ndarray:
        return np.asarray(self.data, dtype=np.float32)

    def __len__(self):
        return len(self.data)
