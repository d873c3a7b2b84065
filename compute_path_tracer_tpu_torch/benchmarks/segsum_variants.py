"""What sets the segment sum's pace on the card: variants of
``csrc/grad_probes.cu:segsum``, each one edit of the source, built beside
the package's kernel and timed against it in one process on the inputs
of ``probe_inkernel_segsum`` (the probe's shape, K4's with uniform and
clustered ids), each launch queued behind a sleep.

* ``kernel``: the source as it is;
* ``stream``: no products (a tile's work is one read of its ids): the
  staged stream of the inputs alone;
* ``products``: the loads of the first ring of tiles only, the products
  then taken over and over on them: the split, the one-hot and the
  tensor-core products alone;
* ``tensor``: as ``products``, with the split and the one-hot's compares
  replaced by one integer add each: the HMMA stream alone;
* ``no_flush``: the products accumulated across all of a warp's tiles
  (no float32 sums after each tile);
* ``cvt_rna``: the TF32 rounding by ``cvt.rna.tf32.f32`` instead of integer
  operations;
* ``other_tile``: the kernel with the tile the plan does not take (512
  lanes at the probe's shape, 256 at K4's);
* ``no_pdl``: the reduce launched after the sum ends, not as its
  programmatic dependent.

Prints one JSON line a variant and row: ms (median of 3 runs of 20
launches), max |kernel - float64 sum| over max |ref| (meaningless for
``stream``, ``products`` and ``tensor``, which compute no sum) and whether
two launches agree bit for bit.  Run on a machine with an NVIDIA GPU and
the CUDA toolkit:

    python -m compute_path_tracer_tpu_torch.benchmarks.segsum_variants
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
from pathlib import Path

import torch

from ..kernels import build
from ..kernels import grad_probes as gp
from . import probe_inkernel_segsum as sgm
from .common import queued_ms, require_card

SRC = Path(build.__file__).parent / "csrc" / "grad_probes.cu"
OUT = Path(__file__).resolve().parents[2] / "build" / "segsum_variants"
PAIRS = """    seg_pair<MT, TS, true>(s_ids, stage + (1 << TS), L0, rows, s0, g, t, acc, sc);
#pragma unroll
    for (int p = 1; p < kWarpLanes / 16; ++p)
      seg_pair<MT, TS, false>(s_ids, stage + (1 << TS), L0 + 16 * p, rows, s0, g, t, acc, sc);"""
STAGE = "    if (next < mine) {\n      seg_stage<TS>("
FLUSH = "        for (int i = 0; i < 4; ++i) sum[m][j][i] += acc[m][j][i];"
NO_LOADS = [(STAGE, "    if (next < mine && next < kSegStages) {\n      seg_stage<TS>(")]
CHEAP = [("      b0[j] = d0 == 8 * j ? one : 0u;\n      b1[j] = d1 == 8 * j ? one : 0u;",
          "      b0[j] = d0 + j;\n      b1[j] = d1 + j;"),
         ("        hi[m][h][q] = tf32_bits(x[m][h][q]);",
          "        hi[m][h][q] = __float_as_uint(x[m][h][q]);"),
         ("lo[m][h][q] = tf32_bits(x[m][h][q] - __uint_as_float(hi[m][h][q]));",
          "lo[m][h][q] = hi[m][h][q] + 1;")]
# (variant, source edits, whether the plan's tile is swapped)
VARIANTS = (
    ("kernel", [], False),
    ("stream", [(PAIRS, "    acc[0][0][0] += s_ids[L0 + lane] * 1e-30f;")], False),
    ("products", NO_LOADS, False),
    ("tensor", NO_LOADS + CHEAP, False),
    ("no_flush", [("seg_pair<MT, TS, true>(", "seg_pair<MT, TS, false>("),
                  (FLUSH, FLUSH.replace("+=", "=")),
                  ("for (int i = 0; i < 4; ++i) sum[m][j][i] = 0.0f;",
                   "for (int i = 0; i < 4; ++i) sum[m][j][i] = acc[m][j][i] = 0.0f;")],
     False),
    ("cvt_rna", [("  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
                  "  uint32_t r;\n  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(r) : \"f\"(x));\n"
                  "  return r;")], False),
    ("other_tile", [], True),
    ("no_pdl", [("  return static_cast<int>(cudaLaunchKernelEx(&cfg, segsum_reduce,",
                 "  cfg.numAttrs = 0;\n  return static_cast<int>(cudaLaunchKernelEx(&cfg, "
                 "segsum_reduce,")], False),
)


def _edit(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) < 1:
            raise ValueError(f"variant edit not found in {SRC.name}: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build_variants() -> dict:
    """Builds each variant's grad_probes.cu into its own library (one nvcc a
    variant, all at once); {variant: its cpt_segsum}."""
    OUT.mkdir(parents=True, exist_ok=True)
    base = SRC.read_text()
    procs = {}
    for name, edits, _ in VARIANTS:
        src = OUT / f"{name}.cu"
        src.write_text(_edit(base, edits))
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(SRC.parent), "-shared",
             "-o", str(OUT / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc {name} failed:\n{log[-4000:]}")
        figs = {k: v for k, v in build.parse_ptxas(log).items() if "segsumILi1ELi9" in k}
        print(json.dumps({"variant": name, "ptxas segsum<1,9>": list(figs.values())}))
        fn = ctypes.CDLL(str(OUT / f"{name}.so")).cpt_segsum
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, i, i, i, p, p, i, i, i, p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def run(fn, idx, cot, n_seg, swap=False):
    """One call of a variant's cpt_segsum on the plan the wrapper takes
    (with the other tile size if ``swap``); the (S, C) sums."""
    n_b, n_ch, n = cot.shape
    plan = gp.segsum_plan(n_b, n, n_seg, n_ch, gp.sm_count(idx.device))
    if swap:
        tile = gp.SEG_TILES[plan.tile == gp.SEG_TILES[0]]
        tpp = -(-n // tile)
        plan = plan._replace(tile=tile, tiles_per_plane=tpp, tiles=n_b * tpp,
                             blocks=min(plan.blocks, n_b * tpp))
    part = torch.empty(plan.passes * plan.blocks * gp.SEG_GROUP * plan.cp,
                       device=idx.device)
    out = torch.empty((n_seg, n_ch), device=idx.device)
    err = fn(idx.data_ptr(), cot.data_ptr(), n_b, n, n_seg, n_ch, part.data_ptr(),
             out.data_ptr(), plan.tile, plan.blocks, 4,
             torch.cuda.current_stream(idx.device).cuda_stream)
    if err:
        raise RuntimeError(f"segsum variant launch failed: CUDA error {err}")
    return out


def measure(device="cuda") -> list:
    fns = build_variants()
    k4 = sgm.k4_shape()
    rows = []
    for label, shape, make in (("probe", sgm.PROBE, sgm.inputs),
                               ("K4", k4, sgm.inputs),
                               ("K4 clustered", k4, sgm.inputs_clustered)):
        idx, cot = make(shape, device)
        n_seg = shape["n_seg"]
        ref = gp.segsum_plain(idx, cot.double(), n_seg)
        ms = {name: [] for name, _, _ in VARIANTS}
        for rnd in range(3):
            order = VARIANTS if rnd % 2 == 0 else VARIANTS[::-1]
            for name, _, swap in order:
                ms[name].append(queued_ms(
                    lambda: run(fns[name], idx, cot, n_seg, swap), 20))
        for name, _, swap in VARIANTS:
            a = run(fns[name], idx, cot, n_seg, swap)
            b = run(fns[name], idx, cot, n_seg, swap)
            rows.append({"variant": name, "row": label,
                         "ms": statistics.median(ms[name]),
                         "rel_err": float((a.double() - ref).abs().max()
                                          / ref.abs().max()),
                         "repeats": bool(torch.equal(a, b))})
        del idx, cot, ref
    return rows


def main() -> int:
    gpu = require_card("segsum_variants")
    for row in measure():
        print(json.dumps(dict(row, gpu=gpu)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
