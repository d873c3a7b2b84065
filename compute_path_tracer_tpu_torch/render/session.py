"""RenderSession: frame orchestration with two-speed scene updates (JAX
package: ``render/session.py``).

The headless analog of the reference's ``State`` + dirty-flag machinery
(reference: src/state.rs:115-235, src/sdf_editor/sdf_editor.rs:35-47):

* ``mark_structure_changed()`` = queue_compile: the next update recompiles
  the scene to a fresh SceneSpec and resets accumulation;
* ``mark_values_changed()`` = queue_update: the next update only refreshes
  the flat parameter vector and resets accumulation;
* ``step()`` renders one progressively-accumulated frame, advancing the
  frame / last_clear counters the way path_tracer.rs:97-118 does;
* ``save_image()`` is the PNG export path (state.rs:237-303).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..app.config import Settings
from ..app.perf import TimePackage
from ..kernels.megakernel import render_frame_megakernel
from ..scene.compile import compile_scene, params_from_numpy
from ..scene.model import Scene


class RenderSession:
    """Renders ``scene`` on ``device`` (a CUDA device for the kernel; the CPU
    runs the kernel's plain torch version)."""

    def __init__(
        self,
        scene: Scene,
        width: int = 512,
        height: int = 512,
        settings: Optional[Settings] = None,
        frame_fn: Optional[Callable] = None,
        device="cuda",
    ):
        self.scene = scene
        self.window_width = width
        self.window_height = height
        self.settings = (settings or Settings()).validate()
        self.device = torch.device(device)
        # Pluggable per-frame renderer with render_frame_pallas's signature;
        # the default marches the faithful geometry, so any scene renders.
        self.frame_fn = frame_fn or render_frame_megakernel

        self.compiled = compile_scene(scene)
        self.params = params_from_numpy(self.compiled.params,
                                        self.compiled.spec, self.device)

        self.frame = 0
        self.last_clear = 0
        self.accum = None
        self.time = TimePackage()

        self._queue_compile = False
        self._queue_update = False
        self._scale = self.settings.scale

    # -- dirty flags (primitives.rs:161-190) --------------------------------
    def mark_structure_changed(self) -> None:
        self._queue_compile = True
        self._queue_update = True

    def mark_values_changed(self) -> None:
        self._queue_update = True

    # -- geometry -----------------------------------------------------------
    @property
    def render_width(self) -> int:
        return max(1, int(self.window_width * self._scale))

    @property
    def render_height(self) -> int:
        return max(1, int(self.window_height * self._scale))

    @property
    def aspect(self) -> float:
        return self.window_width / self.window_height

    def resize(self, width: int, height: int) -> None:
        self.window_width = width
        self.window_height = height
        self.reset_accumulation()

    def set_scale(self, scale: float) -> None:
        self.settings.scale = scale
        self.settings.validate()
        self._scale = scale
        self.reset_accumulation()

    def reset_accumulation(self) -> None:
        """The last_clear = 0 reset on any change (path_tracer.rs:101-106)."""
        self.accum = None
        self.last_clear = 0

    # -- per-frame update (state.rs:115-126) --------------------------------
    def update(self) -> None:
        self.time.update()
        if self._queue_compile:
            self.compiled = compile_scene(self.scene)
            self.params = params_from_numpy(self.compiled.params,
                                            self.compiled.spec, self.device)
            self.reset_accumulation()
        elif self._queue_update:
            self.params = params_from_numpy(self.compiled.refresh(self.scene),
                                            self.compiled.spec, self.device)
            self.reset_accumulation()
        self._queue_compile = False
        self._queue_update = False

    def step(self) -> torch.Tensor:
        """Process pending edits, render one frame, advance counters.

        Returns the current (H, W, 3) accumulator (linear HDR).
        """
        self.update()
        w, h = self.render_width, self.render_height
        if self.accum is not None and tuple(self.accum.shape[:2]) != (h, w):
            self.reset_accumulation()
        self.accum = self.frame_fn(
            self.compiled.spec,
            self.params,
            accum=self.accum,
            frame=self.frame,
            last_clear=self.last_clear,
            width=w,
            height=h,
            debug=self.settings.debug,
            bounces=self.settings.bounces,
            fov=self.settings.fov,
            aspect=self.aspect,
        )
        self.frame += 1
        self.last_clear += 1
        return self.accum

    def render(self, n_frames: int = 1):
        """Step n frames; returns the final accumulator."""
        out = None
        for _ in range(n_frames):
            out = self.step()
        return out

    # -- export (state.rs:237-303) ------------------------------------------
    def save_image(self, path: str, gamma: float = 2.2, tonemap: str = "gamma") -> None:
        """Export the accumulator as PNG: ``"gamma"`` is the reference's PNG
        export (state.rs:280-292), ``"aces"`` what its window shows
        (render_texture_shader.wgsl:62-72)."""
        from ..io.png import save_png

        if self.accum is None:
            raise RuntimeError("nothing rendered yet")
        if tonemap == "aces":
            from ..ops.tonemap import color_correction
            from ..vecmath import Vec3

            img = color_correction(Vec3.from_stacked(self.accum)).stack()
            save_png(path, img.cpu().numpy(), gamma=1.0)  # display-encoded
        elif tonemap == "gamma":
            save_png(path, np.asarray(self.accum.cpu()), gamma=gamma)
        else:
            raise ValueError("tonemap must be 'gamma' or 'aces'")
