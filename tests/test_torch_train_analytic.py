"""Port parity: the fused step with ``analytic_all`` (K1's closed form in
phase 1) and the edge term, on benchmark_scene(8), against the JAX fused
kernel (tests/test_train_fused.py:441).

The loss is exact (within 1e-5 relative, as JAX holds its own to the
megakernel's image), and the image equals the port's K1 frame bit for bit.
The gradient is the smooth part, equal to JAX's to rounding, plus the edge
term, whose signed march JAX culls per (32, 128) tile and the port not at
all.  On this scene that moves the gradient measurably: cosine 0.9673 with
the 20 largest slots up to 1.9x apart (measured), so the first test holds
the cosine above 0.96 and the top slot's sign.  The last test puts JAX's
tile cull back into the port's signed march and then holds the gradient to
tests/test_torch_train_winner.py's tolerance: the cull is the whole
difference.
"""

import numpy as np
import torch

from compute_path_tracer_tpu_torch.kernels.megakernel import (
    render_frame_megakernel_plain)
from test_torch_train_winner import jax_step, port_step, scenes

KW = (("analytic_all", True), ("bounces", 1), ("edge_grad", True))


def test_analytic_all_edge_against_jax():
    lj, gj, ij = jax_step("bench8", 32, 16, "noise", KW)
    lt, gt, it = port_step("bench8", 32, 16, "noise", **dict(KW))
    assert np.isfinite(gt).all()
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    np.testing.assert_allclose(it, ij, rtol=0, atol=1e-5)
    cos = float(gt @ gj / (np.linalg.norm(gt) * np.linalg.norm(gj)))
    assert cos > 0.96
    top = int(np.argmax(np.abs(gj)))
    assert np.sign(gt[top]) == np.sign(gj[top])


def test_analytic_all_image_is_k1_frame():
    _, tc = scenes("bench8")
    _, _, img = port_step("bench8", 32, 16, "noise", **dict(KW))
    k1 = render_frame_megakernel_plain(
        tc.spec, torch.from_numpy(tc.params), width=32, height=16, bounces=1,
        geometry="baked", analytic_all=True)
    np.testing.assert_array_equal(img, k1.numpy())


def _tile_continue_march(spec, bv, width, height, fov, aspect):
    """JAX's signed march of the analytic edge term (train.py:610-687) with
    its per-tile cull: the image padded to one (16, 128) tile, the
    interval of each guarded shape's box reduced over the tile's lanes, the
    shape active while the tile's front is inside it, the step clamped at
    the nearest entry ahead.  A stand-in for kernels/train.py's
    ``_continue_march`` in the test below."""
    from compute_path_tracer_tpu_torch.constants import BIG, FP, MHD
    from compute_path_tracer_tpu_torch.render.baked import (
        boxed_shapes, make_bounds_baked)
    from compute_path_tracer_tpu_torch.render.reference import camera_rays

    def cont(map_fn, ro, rd, chk, t0, cap):
        ys, xs = torch.meshgrid(torch.arange(16, dtype=torch.int32),
                                torch.arange(128, dtype=torch.int32),
                                indexing="ij")
        _, pro, prd = camera_rays(xs, ys, 0, fov, aspect, width=width,
                                  height=height)
        checks, tns, tfs, _ = make_bounds_baked(spec, with_t=True)(pro, prd, bv)
        sids = [bs.shape_id for bs in boxed_shapes(spec)]
        ivals = [(bool(checks[s].any()),
                  float(torch.where(checks[s], torch.clamp(tns[s], min=0.0),
                                    torch.tensor(BIG)).min()),
                  float(torch.where(checks[s], tfs[s],
                                    torch.tensor(-BIG)).max())) for s in sids]
        guard = torch.stack([checks[s] for s in sids], 1)
        n = pro.x.shape[0]
        t = torch.zeros(n)
        done = torch.zeros(n, dtype=torch.bool)
        was_neg = done.clone()
        d_min, t_min = torch.full((n,), BIG), torch.zeros(n)
        for _ in range(cap):
            if bool(done.all()):
                break
            t_hi = float(torch.where(done, torch.tensor(-BIG), t).max())
            t_lo = float(torch.where(done, torch.tensor(BIG), t).min())
            active = torch.tensor([a and not tn > t_hi and tf >= t_lo
                                   for a, tn, tf in ivals])
            m = min([tn for a, tn, _ in ivals if a and tn > t_hi] + [BIG])
            d, _ = map_fn(pro + prd * t, guard & active[None, :])
            better = ~done & (d < d_min)
            d_min = torch.where(better, d, d_min)
            t_min = torch.where(better, t, t_min)
            step = torch.minimum(torch.clamp(d.abs(), min=2e-3),
                                 torch.clamp(m - t, min=MHD))
            nt = torch.where(done, t, t + step)
            done = done | (was_neg & (d > 0.0)) | (nt > FP)
            was_neg = was_neg | (d < 0.0)
            t = nt
        real = ((ys < height) & (xs < width)).reshape(-1)
        return d_min[real], t_min[real]

    return cont


def test_analytic_edge_with_jax_tile_cull_matches_jax(monkeypatch):
    """With JAX's per-tile cull put back into the signed march, the port's
    analytic edge step is JAX's to rounding: the whole difference measured
    above is the cull."""
    from compute_path_tracer_tpu_torch.kernels import train as tt
    from compute_path_tracer_tpu_torch.render.baked import bake

    _, tc = scenes("bench8")
    bv = bake(tc.spec, torch.from_numpy(tc.params))
    monkeypatch.setattr(tt, "_continue_march", _tile_continue_march(
        tc.spec, bv, 32, 16, 1.0, 2.0))
    lj, gj, _ = jax_step("bench8", 32, 16, "noise", KW)
    lt, gt, _ = port_step("bench8", 32, 16, "noise", **dict(KW))
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    np.testing.assert_allclose(gt, gj, rtol=1e-3, atol=1e-4 * np.abs(gj).max())
