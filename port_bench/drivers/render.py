"""What the render drivers share: the session the configuration asks for,
the seeded sample of pixels the check reads, and the spans of a traced
window."""

from __future__ import annotations

import contextlib
from functools import partial

import numpy as np
import torch


def seeded(seed: int) -> np.random.Generator:
    return np.random.default_rng(int(seed) % (1 << 63))


def make_session(config: dict, device):
    """The program's ``RenderSession`` over the configuration's scene, size
    and renderer (the CLI's ``render --mode``), and the scene it edits."""
    from compute_path_tracer_tpu_torch.app.config import Settings
    from compute_path_tracer_tpu_torch.kernels.megakernel import (
        render_frame_megakernel,
    )
    from compute_path_tracer_tpu_torch.render.session import RenderSession
    from compute_path_tracer_tpu_torch.scene.library import benchmark_scene

    scene = benchmark_scene(config["scene"]["n_prims"],
                            seed=config["scene"]["seed"])
    settings = Settings(debug=config["debug"], bounces=config["bounces"],
                        fov=config["fov"])
    frame_fn = partial(render_frame_megakernel, **config["renderer"]["options"])
    return scene, RenderSession(scene, config["width"], config["height"],
                                settings, frame_fn=frame_fn, device=device)


def sample_pixels(rng: np.random.Generator, config: dict, n: int) -> np.ndarray:
    """``n`` distinct flat pixel indices ``y * width + x``."""
    return rng.choice(config["width"] * config["height"], size=n,
                      replace=False).astype(np.int64)


def spans(traced: bool):
    """``span(name)``: a ``record_function`` in a traced window, else
    nothing."""
    if traced:
        from torch.profiler import record_function

        return record_function
    return lambda name: contextlib.nullcontext()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def release(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
