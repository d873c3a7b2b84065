"""Scene JSON save/load.

Mirrors the reference's map persistence (reference:
src/sdf_editor/sdf_editor.rs:131-167): the whole editable tree, including
param identities, round-trips through pretty-printed JSON under a maps
directory, so loaded scenes keep their parameter slots stable.

The JSON format is the JAX package's, unchanged, so a map saved by either
package loads in the other; :func:`convert_scene` carries a live scene
object across the same way.
"""

from __future__ import annotations

import json
import os
from typing import List

from .model import Scene

DEFAULT_MAPS_DIR = "data/maps"


def save_scene(scene: Scene, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(scene.to_dict(), f, indent=2)


def load_scene(path: str) -> Scene:
    with open(path) as f:
        return Scene.from_dict(json.load(f))


def convert_scene(scene) -> Scene:
    """A port :class:`Scene` from any scene object that serializes to the
    shared JSON format (``to_dict``), such as one built with the JAX
    package.  Param identities survive, so both compile to the same slots."""
    return Scene.from_dict(json.loads(json.dumps(scene.to_dict())))


def save_map(scene: Scene, name: str, maps_dir: str = DEFAULT_MAPS_DIR,
             overwrite: bool = False) -> str:
    """Save under ``{maps_dir}/{name}.json`` (sdf_editor.rs:131-139).

    Refuses to clobber an existing map unless ``overwrite=True`` - the
    headless analog of the reference's overwrite-warning dialog
    (sdf_editor.rs:169-181)."""
    path = os.path.join(maps_dir, f"{name}.json")
    if os.path.exists(path) and not overwrite:
        raise FileExistsError(
            f"map '{name}' already exists at {path}; pass overwrite=True"
        )
    save_scene(scene, path)
    return path


def load_map(name: str, maps_dir: str = DEFAULT_MAPS_DIR) -> Scene:
    return load_scene(os.path.join(maps_dir, f"{name}.json"))


def list_maps(maps_dir: str = DEFAULT_MAPS_DIR) -> List[str]:
    """Saved map names (the open-menu listing, sdf_editor.rs:141-167)."""
    if not os.path.isdir(maps_dir):
        return []
    return sorted(
        os.path.splitext(f)[0] for f in os.listdir(maps_dir) if f.endswith(".json")
    )
