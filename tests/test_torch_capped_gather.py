"""Port parity: the capped march probe on K3's per-warp walk, and the
gather probe's replicated rows, index conversion and root domain
(kernels/csrc/march_probes.cu: march_capped; kernels/csrc/hw_probes.cu:
gather_chain_smem, sqrt_rn_dom).

* The capped kernel is K3's t-culled kernel over the capped program
  (``kernels/probes.py:capped_program``): a block of 4 warps stages the
  program (``walk_smem_bytes(prog, 4)``, which must fit a block for every
  program the probe takes), and each warp of 32 consecutive rays walks its
  list, whose plain model is ``capped_list_lengths``; on a scene with no
  guard-less shape the capped program is the full one, and the lists are
  K3's.  On the CPU ``march_capped`` is its plain version, and
  ``walk_stats`` takes the model.
* The shared-memory chains stage 32 replicas of a 128-entry row and
  ``GATHER_REPLICAS[512]`` of a 512-entry one (``hw_probes.gather_word``):
  with 32 every lane reads its own bank; with fewer, a lane only meets the
  lanes of its replica.  The chain through that layout, with the index by
  one add rounded toward zero on rows in [0, 2**23) and by truncation on
  the others (``gather_chain_model``), is ``gather_chain_plain`` bit for
  bit; ``rz_whole`` models the add in float64 and equals truncation on
  every float32 it is used on, and the range test rejects what it must.
* Every root argument of the arithmetic tap at the driver's inputs lies in
  ``hw_probes.ROOT_DOMAIN``, where the card checks the branch-free root
  (chip_smoke.py: ``gather_root_check``).

The kernels run on the card; chip_smoke.py holds them to these models."""

import numpy as np
import pytest
import torch

from compute_path_tracer_tpu_torch.benchmarks import gather_probe as gp
from compute_path_tracer_tpu_torch.benchmarks.common import probe_rays
from compute_path_tracer_tpu_torch.kernels import hw_probes as hp
from compute_path_tracer_tpu_torch.kernels import probes as pr
from compute_path_tracer_tpu_torch.render import program as tp
from compute_path_tracer_tpu_torch.scene import (
    compile_scene,
    library,
    params_from_numpy,
)
from compute_path_tracer_tpu_torch.vecmath import Vec3

SCENES = ["benchmark_64", "sphere_and_plane", "csg_demo", "blend_demo",
          "glass_demo", "edge_demo"]
N = 21 * 97            # 64 warps of 32 rays, the last one partial


def _scene(name):
    scene = (library.benchmark_scene(64) if name == "benchmark_64"
             else getattr(library, name)())
    cs = compile_scene(scene)
    return cs.spec, params_from_numpy(cs.params, cs.spec, "cpu")


def _rays():
    ro, rd = probe_rays(48, 43, "cpu")
    return (Vec3(*(c[:N].contiguous() for c in v)) for v in (ro, rd))


def _capped(name):
    spec, params = _scene(name)
    prog = pr.capped_program(spec)
    return spec, params, prog, tp.program_table(prog, params, True)


@pytest.mark.parametrize("name", SCENES)
def test_capped_walk_fits_a_block(name):
    """Four warps' lists and the staged program and leaf table: 16 bytes a
    record five times over, then the table, within a block's shared
    memory."""
    _, _, prog, _ = _capped(name)
    smem = tp.walk_smem_bytes(prog, pr.WARPS)
    n_ops = prog.ops.shape[0]
    assert smem >= 16 * n_ops * (1 + pr.WARPS) + 4 * prog.f_box
    assert smem <= 16 * n_ops * (1 + pr.WARPS) + 4 * prog.f_box + 28
    assert smem <= tp.SMEM_PER_BLOCK


@pytest.mark.parametrize("name", ["benchmark_64", "csg_demo",
                                  "sphere_and_plane"])
def test_capped_list_lengths_in_bounds(name):
    """Each warp's list holds every ENTER, LEAVE and guard-less shape and
    at most every record: between 1 and n_ops, one list a 32 rays."""
    _, _, prog, table = _capped(name)
    ro, rd = _rays()
    lengths = pr.capped_list_lengths(prog, table, ro, rd)
    assert lengths.shape == (-(-N // 32),)
    assert int(lengths.min()) >= 1
    assert int(lengths.max()) <= prog.ops.shape[0]
    fixed = int((np.where(prog.ops[:, 0] == tp.OPC_SHAPE, prog.ops[:, 3],
                          -1) < 0).sum())
    assert int(lengths.min()) >= fixed


def test_capped_lists_are_k3s_without_guardless_shapes():
    """edge_demo has no guard-less shape: the capped program is the baked
    program, and its lists are K3's warps' (32 consecutive rays,
    warp_records over the t-culled guards)."""
    spec, params, prog, table = _capped("edge_demo")
    full = tp.build_program(spec, "baked")
    assert np.array_equal(prog.ops, full.ops) and prog.caps.shape[0] == 0
    ro, rd = _rays()
    ftable = tp.program_table(full, params, True)
    checks, _ = tp.program_bounds(full, ftable, ro, rd, True)
    k3 = tp.warp_records(full, checks[0], torch.arange(N) // 32).sum(1)
    assert torch.equal(pr.capped_list_lengths(prog, table, ro, rd), k3)


@pytest.mark.parametrize("name", ["benchmark_64", "csg_demo"])
def test_march_capped_on_cpu_is_its_plain_version(name):
    """No launch; t is march_capped_plain's bit for bit, and walk_stats
    takes the model's summed length and list count."""
    _, _, prog, table = _capped(name)
    ro, rd = _rays()
    before = dict(pr.LAUNCHES)
    walk = torch.zeros(2, dtype=torch.int64)
    t = pr.march_capped(prog, table, ro, rd, walk_stats=walk)
    assert torch.equal(t, pr.march_capped_plain(prog, table, ro, rd))
    lengths = pr.capped_list_lengths(prog, table, ro, rd)
    assert walk.tolist() == [int(lengths.sum()), lengths.numel()]
    assert pr.LAUNCHES == before


def test_march_capped_checks_walk_stats():
    _, _, prog, table = _capped("csg_demo")
    ro, rd = _rays()
    for bad in (torch.zeros(3, dtype=torch.int64),
                torch.zeros(2, dtype=torch.int32)):
        with pytest.raises(ValueError):
            pr.march_capped(prog, table, ro, rd, walk_stats=bad)


# -- the gather probe ---------------------------------------------------------


@pytest.mark.parametrize("entries", [hp.LANES, hp.GRID_ENTRIES])
def test_replicated_layout_banks(entries):
    """Replica r holds every entry once, the replicas' words are disjoint
    and fill the staged block; lane l reads replica l mod R, so it stays on
    the banks congruent to l mod R: with R = 32 (the 128-entry row) on bank
    l for every entry, and two lanes of different replicas never meet in a
    bank."""
    r = hp.GATHER_REPLICAS[entries]
    j = np.arange(entries)[:, None]
    lane = np.arange(hp.LANES)[None, :]
    word = hp.gather_word(entries, j, lane)
    assert sorted(set(word.ravel().tolist())) == list(range(entries * r))
    bank = word % hp.SMEM_BANKS
    assert (bank % r == lane % r).all()
    if r == hp.SMEM_BANKS:
        assert (bank == lane % hp.SMEM_BANKS).all()
    assert 4 * entries * r <= 16 * 1024


def _mixed(entries, seed):
    """(1, 8, entries) rows: even ones in [0, 2**23), odd ones with a
    negative entry and one of 2**23 or more; int32 indices."""
    rng = np.random.default_rng(seed)
    tab = rng.uniform(0.0, hp.RZ_LIMIT, (1, 8, entries)).astype(np.float32)
    tab[0, 1::2, 3] = -5.5
    tab[0, 1::2, 11] = 1.0e8
    idx = rng.integers(0, entries, (1, 8, hp.LANES)).astype(np.int32)
    return tab, idx


@pytest.mark.parametrize("entries", [hp.LANES, hp.GRID_ENTRIES])
@pytest.mark.parametrize("rows", ["driver", "mixed"])
def test_chain_model_is_the_plain_chain(entries, rows):
    """The chain through the replicated layout and both index conversions
    is gather_chain_plain's bit for bit: the driver's rows (all in range)
    and rows half of which fail the range test."""
    if rows == "driver":
        inp = gp.inputs(1, "cpu", h=8)
        key = "" if entries == hp.LANES else "512"
        tab, idx = inp["tab" + key].numpy(), inp["idx" + key].numpy()
        assert hp.gather_rows_in_rz(tab[0]).all()
    else:
        tab, idx = _mixed(entries, entries)
        rz = hp.gather_rows_in_rz(tab[0])
        assert rz[0::2].all() and not rz[1::2].any()
    got = hp.gather_chain_model(tab, idx, 96)
    want = hp.gather_chain_plain(torch.from_numpy(tab), torch.from_numpy(idx),
                                 96)
    assert np.array_equal(got, want.numpy())


@pytest.mark.parametrize("lo, hi", [(0.0, 1.0), (1.0, 4096.0),
                                    (4096.0, hp.RZ_LIMIT)])
def test_rz_conversion_is_truncation(lo, hi):
    """On a grid of float32 bit patterns of [lo, hi), every 7th pattern and
    the edges (each integer and its neighbours), the add rounded toward
    zero gives int(g) exactly."""
    a, b = (np.array([lo, hi], np.float32).view(np.int32)).tolist()
    bits = np.arange(a, b, 7, dtype=np.int64)
    g = bits.astype(np.int32).view(np.float32)
    ints = np.arange(np.ceil(lo), min(hi, 2.0 ** 16), dtype=np.float32)
    edges = np.concatenate([ints, np.nextafter(ints, np.float32(0)),
                            np.nextafter(ints, np.float32(hi))])
    g = np.concatenate([g, edges[(edges >= lo) & (edges < hi)],
                        np.float32([np.nextafter(np.float32(hi),
                                                 np.float32(0))])])
    assert np.array_equal(hp.rz_whole(g), np.trunc(g.astype(np.float64))
                          .astype(np.int64))


@pytest.mark.parametrize("value, ok", [
    (-0.0, True), (0.0, True), (float(np.float32(hp.RZ_LIMIT - 1)), True),
    (-1e-30, False), (-1.0, False), (hp.RZ_LIMIT, False), (3e9, False),
    (float("inf"), False), (float("nan"), False)],
    ids=["minus0", "0", "max", "tiny-neg", "neg", "2^23", "big", "inf", "nan"])
def test_range_test(value, ok):
    """A row passes only with every entry in [0, 2**23): a negative entry,
    2**23 or above, infinity or NaN sends it to the exact conversion."""
    rows = np.full((2, hp.LANES), 3.0, np.float32)
    rows[1, 77] = value
    assert hp.gather_rows_in_rz(rows).tolist() == [True, ok]


def test_arith_roots_lie_in_the_domain():
    """Every argument (x - s)^2 + s + 1 that gather_arith takes the root
    of, at the driver's 16 tiles and GATHER_ITERS, lies in ROOT_DOMAIN; the
    least is 1 (x = s = 0)."""
    args = hp.gather_arith_roots(gp.inputs(gp.TILES, "cpu")["idx"],
                                 hp.GATHER_ITERS)
    lo, hi = hp.ROOT_DOMAIN
    assert float(args.min()) == 1.0 == lo
    assert float(args.max()) <= hi
    x_max = hp.LANES - 1 + hp.GATHER_ITERS - 1
    assert float(args.max()) == float(np.float32(x_max) ** 2 + 1)
