"""The inverse-rendering job, as ``optimize`` runs its self-target: the
scene's geometry perturbed (``perturbed_slots``: N(0, ``perturb``) on every
boxed primitive's position and size, drawn from the seed), Adam toward the
unperturbed scene's image.  The seed also picks the rows the traced run
counts.  The window runs the program's ``optimize_to_target`` with the
mix's ``options``, ``steps_per_call`` steps a call, each call from the same
start, until ``--seconds`` have passed: every run times the same
trajectory, however many calls fit, where one call sized to the window
would time a longer stretch of it, whose steps cost less, on a faster
program.  Each step is timed through the callback.

The target (one sample of the true scene's frame 0, the frame stream the
steps render) is made in set-up by the reference module the
configuration's renderer names, and handed to the program and to the
check; its seconds are not set-up (``reference_s``).  The check follows
the first ``ref_steps`` steps of the window's first call (``compare``) on
the reference module the mix names (``job_step``): the first step's loss,
the first gradient as Adam got it (its first moment after one step over
``1 - beta1``) by its worst leaf, and the parameters' change after the
followed steps by its median leaf (a leaf: a primitive's geometry or
material slots, a union's transform)."""

from __future__ import annotations

import contextlib
import functools
import sys
import time

import numpy as np
import torch

from ..reference import load, render_check
from .render import release, seeded, spans, sync

BETAS = (0.9, 0.999)
EPS = 1e-8


def leaves(spec) -> list:
    """Slot indices of each leaf of the flat parameter vector: every
    shape's geometry (transform and size) and material slots, every
    union's transform, the vector's own slots only."""
    out = []

    def keep(slots):
        s = sorted({int(i) for i in slots if 0 <= int(i) < spec.n_params})
        if s:
            out.append(np.asarray(s, np.int64))

    def transform(t):
        return (*t.pos, *t.rot, t.scale, t.ex)

    def walk(u):
        keep(transform(u.transform) + ((u.smooth_k,) if u.smooth_k >= 0 else ()))
        for cu in u.children_unions:
            walk(cu)
        for s in u.children_shapes:
            keep(transform(s.transform) + tuple(s.size))
            keep(s.material)

    for root in spec.roots:
        walk(root)
    return out


def perturbed_slots(spec) -> np.ndarray:
    """The slots the job perturbs: every boxed primitive's position and
    size.  Its materials and the guard-less lamps and ground stay: a
    material drawn from the seed changed the paths' lengths, and so a
    step's work, from seed to seed."""
    return np.asarray(sorted({i for s in spec.iter_shapes()
                              if s.transform.aabb
                              for i in (*s.transform.pos, *s.size)}),
                      np.int64)


def leaf_gaps(got: np.ndarray, want: np.ndarray, groups, grad_ref):
    """``| |got_L| - |want_L| | / max(|want_L|, median)`` of each leaf L
    whose reference gradient is at least a thousandth of the median
    leaf's (the others move under Adam by round-off alone)."""
    g = np.array([np.linalg.norm(grad_ref[s]) for s in groups])
    kept = [s for s, n in zip(groups, g) if n >= 1e-3 * np.median(g)]
    a = np.array([np.linalg.norm(got[s]) for s in kept])
    b = np.array([np.linalg.norm(want[s]) for s in kept])
    den = np.maximum(b, np.median(b))
    return np.where(den > 0, np.abs(a - b) / np.where(den > 0, den, 1.0),
                    np.where(a == b, 0.0, np.inf))


class Cell:
    # The faults ``reference`` can plant, read by port_bench.calibrate (a
    # step that leaves the parameters unchanged reads 1 by step_gap).
    FAULTS = ("half", "altered")

    def __init__(self, config: dict, mix: dict, seed: int, device):
        from compute_path_tracer_tpu_torch.diff.inverse import (
            optimize_to_target,
        )
        from compute_path_tracer_tpu_torch.scene.compile import compile_scene
        from compute_path_tracer_tpu_torch.scene.library import benchmark_scene

        self.config, self.mix, self.device = config, mix, device
        self.optimize = optimize_to_target
        c, job = config, config["job"]
        compiled = compile_scene(benchmark_scene(c["scene"]["n_prims"],
                                                 seed=c["scene"]["seed"]))
        self.spec = compiled.spec
        truth = np.asarray(compiled.params, np.float32)
        self.ref_spec, ref_truth = render_check.scene_state(c["scene"])
        moved = perturbed_slots(self.ref_spec)
        rng = seeded(seed)
        init = truth.copy()
        init[moved] += rng.normal(0.0, job["perturb"],
                                  moved.shape).astype(np.float32)
        self.init = init
        self.count_rows = np.sort(rng.choice(c["height"], mix["count_rows"],
                                             replace=False))
        # The self-target: the true scene's frame 0 through the reference.
        w, h = c["width"], c["height"]
        xs, ys = np.tile(np.arange(w), h), np.repeat(np.arange(h), w)
        t0 = time.perf_counter()
        self.target = load(c["renderer"]["reference"]).trace_samples(
            self.ref_spec, [ref_truth], xs, ys, np.zeros_like(xs),
            np.zeros_like(xs), width=w, height=h, bounces=c["bounces"],
            fov=c["fov"], device=device,
            options=c["renderer"]["options"]).reshape(h, w, 3)
        # The target's lanes leave blocks of their own sizes in the
        # allocator's cache: return them before the program's warm-up.
        release(device)
        self.reference_s = time.perf_counter() - t0
        self.kwargs = dict(width=w, height=h, bounces=c["bounces"],
                           spp=job["spp"], learning_rate=job["lr"],
                           device=device, **mix["options"])
        self.ref = load(mix["reference"])
        self.mask = np.ones_like(init)
        self.mask[self.ref.pinned_slots(self.ref_spec)] = 0.0
        self.optimize(self.spec, init, self.target,
                      steps=mix["warmup_steps"], **self.kwargs)
        sync(device)

    def window(self, seconds: float, traced: bool) -> dict:
        span = spans(traced)
        per_call, follow = self.mix["steps_per_call"], self.mix["ref_steps"]
        state = {"calls": 0}

        def make_adam(params):
            state["opt"] = torch.optim.Adam(params, lr=self.kwargs["learning_rate"],
                                            betas=BETAS, eps=EPS)
            return state["opt"]

        times = []

        def callback(i, loss):
            times.append(time.perf_counter())
            if state["calls"]:
                return
            if i == 0:
                (p,) = state["opt"].param_groups[0]["params"]
                state["m1"] = state["opt"].state[p]["exp_avg"].clone()
            if i == follow - 1:
                (p,) = state["opt"].param_groups[0]["params"]
                state["p_follow"] = p.detach().clone()

        if torch.device(self.device).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        with span("bench.window"):
            t0 = time.perf_counter()
            end = t0 + seconds
            while state["calls"] == 0 or time.perf_counter() < end:
                with span("bench.call"):
                    result = self.optimize(self.spec, self.init, self.target,
                                           steps=per_call, optimizer=make_adam,
                                           callback=callback, **self.kwargs)
                if state["calls"] == 0:
                    self.result = result
                state["calls"] += 1
            with span("bench.sync"):
                sync(self.device)
            wall = time.perf_counter() - t0
        self.state = state
        steps = state["calls"] * per_call
        gaps = np.diff(np.asarray(times)) * 1e3
        print("port_bench: %d calls; step ms (callback to callback) p10 %.3f "
              "p50 %.3f p90 %.3f max %.3f" % (state["calls"], *np.percentile(
                  gaps, [10, 50, 90, 100])), file=sys.stderr)
        peak = (torch.cuda.max_memory_allocated()
                if torch.device(self.device).type == "cuda" else 0)
        return {"units": steps,
                "metrics": {"step_ms": wall / steps * 1e3,
                            "peak_mem_gib": peak / 2**30}}

    def check(self) -> dict:
        """``loss_gap``, ``grad_gap``, ``step_gap`` of the followed steps
        against the reference's."""
        n = self.mix["ref_steps"]
        got = {"losses": self.result.losses[:n].numpy().astype(np.float64),
               "grad": (self.state["m1"] / (1.0 - BETAS[0])).cpu().numpy(),
               "change": (self.state["p_follow"].cpu().numpy()
                          - self.init)}
        self.result = self.state = None
        release(self.device)
        self.got, self.want = got, self.reference()
        return self.compare(got, self.want)

    def look(self) -> dict:
        """What the calibration prints beside the numbers (after
        ``check``): each followed step's loss on both sides, and the first
        gradient's slots whose sign differs between them (Adam moves such
        a slot by the learning rate either way)."""
        g, w = self.got["grad"], self.want["grad"]
        flip = np.nonzero(np.sign(g) != np.sign(w))[0]
        change = leaf_gaps(self.got["change"], self.want["change"],
                           leaves(self.ref_spec), w)
        return {"losses_program": self.got["losses"].tolist(),
                "step_gap_worst_leaf": float(np.max(change)),
                "losses_reference": self.want["losses"].tolist(),
                "sign_flips": int(flip.size),
                "flip_max_abs_grad": float(np.abs(w[flip]).max())
                if flip.size else 0.0,
                "median_abs_grad": float(np.median(np.abs(w[w != 0])))}

    def control(self) -> dict:
        """The check's numbers with the reference in bfloat16 in the
        program's place (after ``check``)."""
        return self.compare(self.reference(lowered=True), self.want)

    def compare(self, got: dict, want: dict) -> dict:
        """The numbers compared: the first step's loss, the first gradient
        by its worst leaf, and the followed steps' change by its median
        leaf.  The later steps' losses and the change's worst leaf move
        with the slots whose gradient is round-off in both (Adam steps
        each by the learning rate, in the sign the round-off gives): they
        are printed beside (``look``), not compared."""
        groups = leaves(self.ref_spec)
        return {
            "loss_gap": float(abs(got["losses"][0] - want["losses"][0])
                              / abs(want["losses"][0])),
            "grad_gap": float(np.max(leaf_gaps(got["grad"], want["grad"],
                                               groups, want["grad"]))),
            "step_gap": float(np.median(leaf_gaps(
                got["change"], want["change"], groups, want["grad"]))),
        }

    @functools.cached_property
    def step_work(self):
        """``(operations, bytes)`` of one step's launch: the work of the
        step at its first parameters over the sampled rows, counted on the
        reference and scaled to the frame; bytes the target read and the
        image written once."""
        c = self.config
        tally = {}
        self.ref.job_step(
            self.ref_spec, torch.as_tensor(self.init, device=self.device),
            self.target, options=self.mix["options"], width=c["width"],
            height=c["height"], bounces=c["bounces"], fov=c["fov"],
            rows=self.count_rows, count=tally)
        scale = c["height"] / len(self.count_rows)
        return (self.ref.work_ops(tally, self.ref_spec) * scale,
                2.0 * 12 * c["width"] * c["height"])

    def reference(self, lowered: bool = False, fault: str = None) -> dict:
        """The followed steps on the reference: each step's loss, the first
        (masked) gradient, and the change of the parameters.  ``fault``
        plants one in it: ``"half"`` renders half the rows and takes the
        mean over them, ``"altered"`` alters each step's loss where it is
        produced."""
        from ..reference.tracer import precision

        c = self.config
        p = torch.as_tensor(self.init, device=self.device).clone()
        mask = torch.as_tensor(self.mask, device=self.device)
        p.requires_grad_()
        opt = torch.optim.Adam([p], lr=self.kwargs["learning_rate"],
                               betas=BETAS, eps=EPS)
        rows = np.arange(c["height"] // 2) if fault == "half" else None
        losses, first = [], None
        ctx = precision.lowered() if lowered else contextlib.nullcontext()
        with ctx:
            for _ in range(self.mix["ref_steps"]):
                loss, grad = self.ref.job_step(
                    self.ref_spec, p.detach(), self.target,
                    options=self.mix["options"], width=c["width"],
                    height=c["height"], bounces=c["bounces"], fov=c["fov"],
                    rows=rows)
                if fault == "half":
                    loss, grad = loss * 2.0, grad * 2.0
                if fault == "altered":
                    loss = loss * 1.01
                grad = grad * mask
                if first is None:
                    first = grad.cpu().numpy()
                p.grad = grad
                opt.step()
                losses.append(float(loss))
        return {"losses": np.asarray(losses, np.float64), "grad": first,
                "change": p.detach().cpu().numpy() - self.init}
