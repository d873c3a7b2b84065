"""Static per-scene tables derived from the SceneSpec (JAX package:
``render/scenegen.py``).

Only ``material_slot_matrix`` is carried over so far; the faithful
per-scene ``map()``/``bounds()`` closures come with the marching kernel.
"""

from __future__ import annotations

import numpy as np

from ..constants import MAT_SIZE
from ..scene.compile import SceneSpec


def material_slot_matrix(spec: SceneSpec) -> np.ndarray:
    """(n_shapes, 18) int32 matrix of parameter slots, row = shape id, columns
    in Mat(...) constructor order (data_structures.rs:178-194)."""
    rows = np.zeros((spec.n_shapes, MAT_SIZE), dtype=np.int32)
    for ss in spec.iter_shapes():
        rows[ss.shape_id] = ss.material
    return rows
