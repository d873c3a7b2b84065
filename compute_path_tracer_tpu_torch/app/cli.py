"""Command-line interface: headless progressive render to PNG, inverse
rendering, and the live-editing demo (JAX package: ``app/cli.py``).

``render`` runs in the three modes of the JAX CLI's Pallas backend:
``faithful`` (the sphere march over the faithful geometry, K2), ``tcull``
(baked geometry, t-interval-culled march, K2) and ``analytic`` (the
full-analytic bounce, union-only scenes, K1).  ``--checkpoint DIR`` writes
the scene, params, accumulator and frame counters after the frames (the
JAX package's format, io/checkpoint.py); ``--resume DIR`` starts from such
a checkpoint (its scene, accumulator and counters), so that ``--frames N``
more frames end bit for bit where an uninterrupted run would:

  python -m compute_path_tracer_tpu_torch render --scene csg_demo \
      --width 1920 --height 1080 --frames 16 --out out.png
  python -m compute_path_tracer_tpu_torch render --frames 8 --checkpoint ck
  python -m compute_path_tracer_tpu_torch render --frames 8 --resume ck

``optimize`` is inverse rendering to a target image (by default the
self-target demo: perturb the params, recover the scene), through the
autograd path of diff/ or, with ``--fused``, the fused train step (with
``--fused`` the refract_chance slots are not perturbed).  ``--edge-grad``
adds the silhouette gradient and ``--edge-secondary`` its secondary-bounce
term, on either path:

  python -m compute_path_tracer_tpu_torch optimize --steps 50
  python -m compute_path_tracer_tpu_torch optimize --edge-grad \
      --perturb-what position --scene edge_demo --bounces 0

``demo`` watches a scene JSON and re-renders on each save, printing the
refresh or recompile cost of the edit (app/demo.py); ``--tui`` opens the
terminal editor (app/tui.py) instead.  The JAX CLI's ``--backend
xla|pallas`` is ``--device`` and ``--mode`` here.

``info`` prints the process's topology (parallel/distributed.py:
``local_device_info``) and its devices, on the card unless ``--device
cpu`` is given; without a card it exits 1.

``--device cpu`` runs the kernels' plain torch versions.
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


def _frame_fn(mode: str):
    from functools import partial

    from ..kernels.megakernel import render_frame_megakernel

    return partial(render_frame_megakernel, **MODES[mode])


def resume_session(sess, state) -> None:
    """Continue ``sess`` from a loaded checkpoint: its accumulator (which
    must have the session's render size) and frame counters."""
    import torch

    accum = torch.as_tensor(state["accum"], dtype=torch.float32)
    if tuple(accum.shape) != (sess.render_height, sess.render_width, 3):
        raise ValueError(f"the checkpoint's accumulator is {tuple(accum.shape)}"
                         f", the session renders {sess.render_height}x"
                         f"{sess.render_width}")
    sess.update()
    sess.accum = accum.to(sess.device)
    sess.frame = int(state["frame"])
    sess.last_clear = int(state["last_clear"])


def cmd_render(args) -> int:
    from ..app.config import Settings
    from ..render.session import RenderSession

    state = None
    if args.resume:
        from ..io.checkpoint import load_checkpoint

        state = load_checkpoint(args.resume)
        scene = state["scene"]
    else:
        scene = _load_scene(args.scene)
    settings = Settings(
        debug=args.debug, bounces=args.bounces, scale=args.scale, fov=args.fov
    ).validate()
    sess = RenderSession(scene, args.width, args.height, settings,
                         frame_fn=_frame_fn(args.mode), device=args.device)
    if state is not None:
        resume_session(sess, state)
        print(f"resumed {args.resume} at frame {sess.frame}")

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
    if args.checkpoint:
        from ..io.checkpoint import save_checkpoint

        save_checkpoint(args.checkpoint, scene=sess.scene, params=sess.params,
                        accum=sess.accum, frame=sess.frame,
                        last_clear=sess.last_clear)
        print(f"checkpoint -> {args.checkpoint}")
    return 0


def cmd_optimize(args) -> int:
    import numpy as np
    import torch

    from ..diff import optimize_to_target, render_image_diff
    from ..render.scenegen import material_slot_matrix
    from ..scene import compile_scene, params_from_numpy

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
        # optimize only that slot back.  Smooth gradients of a position are
        # (near) zero: this is the case --edge-grad exists for.
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


def cmd_demo(args) -> int:
    """Two-speed live-editing demo: watch a scene JSON and re-render on
    save, printing the refresh or recompile cost (the reference's live
    editor loop, sdf_editor.rs:35-47, headless)."""
    from ..app.config import Settings
    from ..app.demo import watch_scene
    from ..render.session import RenderSession
    from ..scene.io import load_scene, save_scene

    if not os.path.exists(args.scene):
        # Seed the watched file from a builtin, so there is something to edit.
        save_scene(_load_scene(args.seed), args.scene)
        print(f"seeded {args.scene} from builtin '{args.seed}': edit it and "
              "save")
    scene = load_scene(args.scene)
    settings = Settings(debug=args.debug, bounces=args.bounces).validate()
    if args.tui:
        from ..app.tui import run_tui

        run_tui(scene, args.width, args.height, settings=settings,
                frame_fn=_frame_fn(args.mode), device=args.device)
        return 0
    sess = RenderSession(scene, args.width, args.height, settings,
                         frame_fn=_frame_fn(args.mode), device=args.device)
    print(f"watching {args.scene} on {sess.device} (ctrl-c to stop); "
          f"renders -> {args.out}")
    try:
        watch_scene(sess, args.scene, frames=args.frames, out=args.out,
                    max_events=args.max_events)
    except KeyboardInterrupt:
        pass
    return 0


def cmd_info(args) -> int:
    import json

    import torch

    from ..parallel import local_device_info

    if torch.device(args.device).type == "cuda":
        if not torch.cuda.is_available():
            print("info: no CUDA device; run on an NVIDIA GPU or pass "
                  "--device cpu", file=sys.stderr)
            return 1
        devices = [f"cuda:{i} {torch.cuda.get_device_name(i)}"
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [args.device]
    info = local_device_info(args.device)
    info["devices"] = devices
    print(json.dumps(info, indent=2))
    return 0


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
    r.add_argument("--checkpoint", default=None,
                   help="write a checkpoint directory after the frames")
    r.add_argument("--resume", default=None,
                   help="start from a checkpoint directory (its scene, "
                        "accumulator and frame counters)")
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
                   help="add the silhouette (visibility edge) gradient")
    o.add_argument("--edge-secondary", action="store_true",
                   help="with --edge-grad: extend it to secondary-bounce "
                        "visibility edges")
    o.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain versions")
    o.set_defaults(fn=cmd_optimize)

    d = sub.add_parser(
        "demo", help="watch a scene JSON; re-render on save (two-speed edits)")
    d.add_argument("--scene", default="data/maps/live.json",
                   help="JSON to watch")
    d.add_argument("--seed", default="csg_demo",
                   help="builtin to seed the file from when it is missing")
    d.add_argument("--width", type=int, default=256)
    d.add_argument("--height", type=int, default=256)
    d.add_argument("--frames", type=int, default=4)
    d.add_argument("--bounces", type=int, default=4)
    d.add_argument("--debug", type=int, default=0, choices=(0, 1, 2, 3))
    d.add_argument("--mode", default="faithful", choices=tuple(MODES),
                   help="as render's --mode")
    d.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernel's plain version")
    d.add_argument("--out", default="live.png")
    d.add_argument("--max-events", type=int, default=None,
                   help="stop after N edits (default: run until ctrl-c)")
    d.add_argument("--tui", action="store_true",
                   help="interactive terminal editor (arrow-key param "
                        "nudging on the live scene tree) instead of the "
                        "file watch")
    d.set_defaults(fn=cmd_demo)

    i = sub.add_parser("info", help="device / topology info")
    i.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' describes the CPU process")
    i.set_defaults(fn=cmd_info)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
