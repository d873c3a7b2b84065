"""Checkpoint / resume for render and optimization state (JAX package:
``io/checkpoint.py``).

A checkpoint holds the scene JSON, the flat parameter vector, the
progressive accumulator with its frame counters and any extra arrays.
Restoring ``frame`` and ``last_clear`` resumes the exact sample sequence,
since the RNG is a pure function of the pixel and the frame: a resumed
render is bit for bit an uninterrupted one.

``save_checkpoint`` / ``load_checkpoint`` write and read the JAX package's
on-disk format (a directory of ``scene.json``, ``state.npz`` and
``meta.json``), so a checkpoint written by either package loads in the
other.  ``save_checkpoint_torch`` / ``load_checkpoint_torch`` are the
counterpart of the JAX package's Orbax pair: the same logical contents,
the arrays and counters in one ``torch.save`` file (``state.pt``), read
back with ``torch.load(weights_only=True)`` onto a device of the caller's
choice.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..scene.io import load_scene, save_scene
from ..scene.model import Scene


def _host(a) -> np.ndarray:
    """An array or tensor (on any device) as a host numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def save_checkpoint(
    path: str,
    *,
    scene: Optional[Scene] = None,
    params=None,
    accum=None,
    frame: int = 0,
    last_clear: int = 0,
    extra: Optional[Dict[str, Any]] = None,
) -> None:
    """Write a checkpoint directory: scene.json + state.npz + meta.json.
    ``params`` and ``accum`` may be tensors on any device or arrays; they
    are written as float32."""
    os.makedirs(path, exist_ok=True)
    if scene is not None:
        save_scene(scene, os.path.join(path, "scene.json"))
    arrays = {}
    if params is not None:
        arrays["params"] = _host(params).astype(np.float32)
    if accum is not None:
        arrays["accum"] = _host(accum).astype(np.float32)
    for k, v in (extra or {}).items():
        arrays[f"extra_{k}"] = _host(v)
    np.savez(os.path.join(path, "state.npz"), **arrays)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"frame": int(frame), "last_clear": int(last_clear)}, f)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Load a checkpoint directory back into a dict: ``scene``, ``params``
    and ``accum`` (numpy), ``frame``, ``last_clear`` and ``extra``, each
    where the checkpoint has it."""
    out: Dict[str, Any] = {}
    scene_path = os.path.join(path, "scene.json")
    if os.path.exists(scene_path):
        out["scene"] = load_scene(scene_path)
    npz_path = os.path.join(path, "state.npz")
    if os.path.exists(npz_path):
        with np.load(npz_path) as z:
            for k in z.files:
                if k.startswith("extra_"):
                    out.setdefault("extra", {})[k[len("extra_"):]] = z[k]
                else:
                    out[k] = z[k]
    meta_path = os.path.join(path, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            out.update(json.load(f))
    return out


def save_checkpoint_torch(
    path: str,
    *,
    scene: Optional[Scene] = None,
    params=None,
    accum=None,
    frame: int = 0,
    last_clear: int = 0,
    extra: Optional[Dict[str, Any]] = None,
) -> None:
    """:func:`save_checkpoint`'s contents through ``torch.save``: the scene
    JSON beside ``state.pt``, which holds the tensors (moved to the host)
    and the counters."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    if scene is not None:
        save_scene(scene, os.path.join(path, "scene.json"))
    tree: Dict[str, Any] = {"frame": int(frame), "last_clear": int(last_clear)}
    if params is not None:
        tree["params"] = torch.as_tensor(_host(params))
    if accum is not None:
        tree["accum"] = torch.as_tensor(_host(accum))
    if extra:
        tree["extra"] = {k: torch.as_tensor(_host(v)) for k, v in extra.items()}
    torch.save(tree, os.path.join(path, "state.pt"))


def load_checkpoint_torch(path: str, device="cpu") -> Dict[str, Any]:
    """Load a checkpoint written by :func:`save_checkpoint_torch`, its
    tensors on ``device``."""
    path = os.path.abspath(path)
    out: Dict[str, Any] = {}
    scene_path = os.path.join(path, "scene.json")
    if os.path.exists(scene_path):
        out["scene"] = load_scene(scene_path)
    tree = torch.load(os.path.join(path, "state.pt"), map_location=device,
                      weights_only=True)
    out.update(tree)
    out["frame"] = int(out.get("frame", 0))
    out["last_clear"] = int(out.get("last_clear", 0))
    return out
