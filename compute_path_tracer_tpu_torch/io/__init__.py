"""Host I/O: PNG export and checkpoint / resume (numpy and JSON; the
``torch.save`` pair).

``__all__`` is the JAX package's, with the Orbax pair
(``save_checkpoint_orbax``, ``load_checkpoint_orbax``) replaced by its
counterpart ``save_checkpoint_torch`` / ``load_checkpoint_torch``.  The
JAX package's ``io/native.py`` (ctypes bindings of a C++ image-export fast
path and a wang_hash cross-check; optional) has no
counterpart (ROADMAP queue 1, item 7's optional tail).
"""

from .checkpoint import (
    load_checkpoint,
    load_checkpoint_torch,
    save_checkpoint,
    save_checkpoint_torch,
)
from .png import encode_png_rgba, hdr_to_rgba8, load_png_rgba, save_png

__all__ = [
    "load_checkpoint",
    "load_checkpoint_torch",
    "save_checkpoint",
    "save_checkpoint_torch",
    "encode_png_rgba",
    "hdr_to_rgba8",
    "load_png_rgba",
    "save_png",
]
