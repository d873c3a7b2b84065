"""The benchmark's plain reference: plain PyTorch that imports nothing of
the program.  ``tracer/`` is the frozen renderer; ``render_check`` computes
what a render cell's accumulator must hold at sampled pixels; ``fused_step``
follows the fused inverse step; ``count`` counts the work for the kernels'
rooflines.

A configuration's renderer (``"renderer": {"reference": ...}``) and an
inverse traffic mix (``"reference"``) name the module that stands for the
program: :func:`load` finds it by that name, so a cell whose program path
has no reference yet brings one as a new module here."""

import importlib


def load(name: str):
    """The reference module ``port_bench/reference/<name>.py``."""
    return importlib.import_module(f"{__name__}.{name}")
