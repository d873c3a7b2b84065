"""Command-line interface: headless progressive render to PNG (JAX package:
``app/cli.py``).

Only ``render`` is ported so far, in the three modes of the JAX CLI's
Pallas backend: ``faithful`` (the sphere march over the faithful
geometry), ``tcull`` (baked geometry, t-interval-culled march) and
``analytic`` (the full-analytic bounce, union-only scenes):

  python -m compute_path_tracer_tpu_torch render --scene csg_demo \
      --width 1920 --height 1080 --frames 16 --out out.png

``--device cpu`` runs the kernels' plain torch versions.  The other
subcommands of the JAX package are listed and raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def _load_scene(name: str):
    from ..scene import library
    from ..scene.io import load_scene

    if os.path.exists(name):
        return load_scene(name)
    make = getattr(library, name, None)
    if make is None:
        known = [
            n for n in dir(library)
            if not n.startswith("_") and callable(getattr(library, n))
        ]
        raise SystemExit(f"unknown scene {name!r}; builtins: {', '.join(known)}")
    return make()


# --mode -> render_frame_megakernel options (JAX package: app/cli.py:50-65).
MODES = {
    "faithful": {},
    "tcull": dict(geometry="baked", t_cull=True),
    "analytic": dict(geometry="baked", analytic_all=True),
}


def cmd_render(args) -> int:
    from functools import partial

    from ..app.config import Settings
    from ..kernels.megakernel import render_frame_megakernel
    from ..render.session import RenderSession

    scene = _load_scene(args.scene)
    settings = Settings(
        debug=args.debug, bounces=args.bounces, scale=args.scale, fov=args.fov
    ).validate()
    sess = RenderSession(scene, args.width, args.height, settings,
                         frame_fn=partial(render_frame_megakernel,
                                          **MODES[args.mode]),
                         device=args.device)

    t0 = time.perf_counter()
    sess.render(args.frames)
    sess.accum.cpu()  # waits for the device
    dt = time.perf_counter() - t0
    sess.save_image(args.out, tonemap=args.tonemap)
    px = sess.render_width * sess.render_height
    print(
        f"rendered {args.frames} frames at {sess.render_width}x{sess.render_height} "
        f"on {sess.device} in {dt:.2f}s "
        f"({px * args.frames / dt / 1e6:.1f} Mpix/s) -> {args.out}"
    )
    return 0


def _not_ported(name):
    def run(args):
        raise NotImplementedError(
            f"the {name!r} subcommand is not ported yet (see ROADMAP.md)")

    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="compute_path_tracer_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="headless progressive render to PNG")
    r.add_argument("--scene", default="csg_demo", help="builtin name or JSON path")
    r.add_argument("--width", type=int, default=512)
    r.add_argument("--height", type=int, default=512)
    r.add_argument("--frames", type=int, default=16)
    r.add_argument("--bounces", type=int, default=8)
    r.add_argument("--debug", type=int, default=0, choices=(0, 1, 2, 3))
    r.add_argument("--fov", type=float, default=1.0)
    r.add_argument("--scale", type=float, default=1.0)
    r.add_argument("--mode", default="faithful", choices=tuple(MODES),
                   help="faithful march, t-interval-culled march, or the "
                        "full-analytic bounce (union-only scenes; fastest)")
    r.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernel's plain version")
    r.add_argument("--out", default="image.png")
    r.add_argument("--tonemap", default="gamma", choices=("gamma", "aces"))
    r.set_defaults(fn=cmd_render)

    for name, text in (("optimize", "inverse rendering to a target image"),
                       ("demo", "watch a scene JSON; re-render on save"),
                       ("info", "device / topology info")):
        sub.add_parser(name, help=f"{text} (not ported yet)").set_defaults(
            fn=_not_ported(name))

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
