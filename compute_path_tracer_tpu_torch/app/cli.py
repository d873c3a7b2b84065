"""Command-line interface: headless progressive render to PNG (JAX package:
``app/cli.py``).

``render`` runs in the three modes of the JAX CLI's Pallas backend:
``faithful`` (the sphere march over the faithful geometry), ``tcull``
(baked geometry, t-interval-culled march) and ``analytic`` (the
full-analytic bounce, union-only scenes):

  python -m compute_path_tracer_tpu_torch render --scene csg_demo \
      --width 1920 --height 1080 --frames 16 --out out.png

``optimize`` is inverse rendering to a target image (by default the
self-target demo: perturb the params, recover the scene), with the smooth
gradient of diff/, or with ``--fused`` the fused train step (``--edge-grad``
and ``--edge-secondary`` add its silhouette terms; with ``--fused`` the
refract_chance slots are not perturbed):

  python -m compute_path_tracer_tpu_torch optimize --steps 50
  python -m compute_path_tracer_tpu_torch optimize --fused --edge-grad \
      --perturb-what position

``--device cpu`` runs the kernels' plain torch versions.  ``demo`` and
``info``, and ``--edge-grad`` / ``--edge-secondary`` without ``--fused``,
raise ``NotImplementedError``.
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


def cmd_optimize(args) -> int:
    import numpy as np
    import torch

    from ..diff import optimize_to_target, render_image_diff
    from ..render.scenegen import material_slot_matrix
    from ..scene import compile_scene, params_from_numpy

    if (args.edge_grad or args.edge_secondary) and not args.fused:
        raise NotImplementedError("--edge-grad / --edge-secondary without "
                                  "--fused need the XLA silhouette "
                                  "estimators, which are not ported "
                                  "(ROADMAP queue 1, item 8.1)")
    scene = _load_scene(args.scene)
    cs = compile_scene(scene)
    device = torch.device(args.device)

    if args.target:
        from ..io.png import load_png_rgba

        rgba = load_png_rgba(args.target).astype(np.float32) / 255.0
        target = torch.from_numpy(rgba[..., :3] ** 2.2).to(device)  # undo export gamma
    else:
        # Self-target demo: perturb params, recover the original scene.
        with torch.no_grad():
            target = render_image_diff(
                cs.spec, params_from_numpy(cs.params, cs.spec, device),
                width=args.width, height=args.height, bounces=args.bounces,
                spp=args.spp)

    rng = np.random.default_rng(0)
    init = np.asarray(cs.params, np.float32)
    mask = None
    pos_slot = None
    if args.perturb_what == "position":
        # Silhouette-recovery demo: offset one shape's x-position and
        # optimize only that slot back (smooth gradients of a position are
        # near zero; the JAX package pairs this with --edge-grad).
        pos_slot = cs.spec.roots[0].children_shapes[0].transform.pos[0]
        init[pos_slot] += args.perturb
        mask = np.zeros_like(init)
        mask[pos_slot] = 1.0
        print(f"perturbed position slot {pos_slot} by {args.perturb:+.3f}")
    else:
        init = init + rng.normal(0, args.perturb, init.shape).astype(np.float32)
        if args.fused:
            # The fused step trains scenes without refraction only: keep the
            # refract_chance slots where the scene has them.
            rc = material_slot_matrix(cs.spec)[:, 13]
            init[rc] = np.asarray(cs.params, np.float32)[rc]

    result = optimize_to_target(
        cs.spec, init, target, width=args.width, height=args.height,
        bounces=args.bounces, spp=args.spp, steps=args.steps,
        learning_rate=args.lr, param_mask=mask, device=device,
        fused=args.fused, edge_grad=args.edge_grad,
        edge_secondary=args.edge_secondary,
        callback=lambda i, l: print(f"step {i:4d} loss {l:.6f}")
        if i % max(1, args.steps // 10) == 0 else None,
    )
    losses = result.losses.tolist()
    print(f"final loss {losses[-1]:.6f} (from {losses[0]:.6f})")
    if pos_slot is not None:
        true_x = float(cs.params[pos_slot])
        got_x = float(result.params[pos_slot])
        print(f"position slot {pos_slot}: true {true_x:+.4f} "
              f"recovered {got_x:+.4f} (started {init[pos_slot]:+.4f})")
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

    o = sub.add_parser("optimize", help="inverse rendering to a target image")
    o.add_argument("--scene", default="sphere_and_plane")
    o.add_argument("--target", default=None,
                   help="PNG target (default: self-target demo)")
    o.add_argument("--width", type=int, default=64)
    o.add_argument("--height", type=int, default=64)
    o.add_argument("--bounces", type=int, default=2)
    o.add_argument("--spp", type=int, default=1,
                   help="samples (frame RNG streams) per optimizer step")
    o.add_argument("--steps", type=int, default=50)
    o.add_argument("--lr", type=float, default=2e-2)
    o.add_argument("--perturb", type=float, default=0.05)
    o.add_argument("--fused", action="store_true",
                   help="the fused train step (kernels/train.py): forward "
                        "and per-pixel backward in one kernel launch")
    o.add_argument("--perturb-what", default="all", choices=("all", "position"),
                   help="'position': offset one shape's x and recover it")
    o.add_argument("--edge-grad", action="store_true",
                   help="with --fused: the primary silhouette gradient term")
    o.add_argument("--edge-secondary", action="store_true",
                   help="with --fused --edge-grad: the secondary-bounce "
                        "silhouette term")
    o.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain versions")
    o.set_defaults(fn=cmd_optimize)

    for name, text in (("demo", "watch a scene JSON; re-render on save"),
                       ("info", "device / topology info")):
        sub.add_parser(name, help=f"{text} (not ported yet)").set_defaults(
            fn=_not_ported(name))

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
