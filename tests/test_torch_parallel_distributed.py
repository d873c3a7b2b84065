"""The port's parallel/distributed.py and the CLI's ``info``.

* ``initialize_distributed`` returns False without the CPT_* variables;
  ``run_with_checkpoint_recovery`` restarts from the checkpoint on a
  ``DistError`` or a kernel's "CUDA error", gives up after
  ``max_restarts`` and lets the caller's ``ValueError`` through at once;
  ``local_device_info`` has the JAX package's keys, and ``info --device
  cpu`` prints them.
"""

import json

import pytest
import torch.distributed as dist

from compute_path_tracer_tpu_torch.app.cli import main as cli_main
from compute_path_tracer_tpu_torch.io.checkpoint import save_checkpoint
from compute_path_tracer_tpu_torch.parallel import (
    initialize_distributed,
    local_device_info,
    make_mesh,
    run_with_checkpoint_recovery,
)

INFO_KEYS = {"process_index", "process_count", "local_devices",
             "global_devices", "platform"}


def test_initialize_distributed_single_process(monkeypatch):
    for var in ("CPT_COORDINATOR", "CPT_NUM_PROCESSES", "CPT_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_distributed(device="cpu") is False
    assert not dist.is_initialized()
    monkeypatch.setenv("CPT_COORDINATOR", "localhost:1")
    monkeypatch.setenv("CPT_NUM_PROCESSES", "1")
    assert initialize_distributed(device="cpu") is False
    mesh = make_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.size) == (None, 0, 1)
    with pytest.raises(ValueError, match="n_devices"):
        make_mesh(8, device="cpu")


def _work(tmp_path, failures):
    """A job that checkpoints its step count and fails ``failures`` times
    after its first step; returns (work, the calls' starting steps)."""
    starts = []

    def work(state):
        step = int(state.get("frame", 0))
        starts.append(step)
        step += 1
        save_checkpoint(str(tmp_path), frame=step, last_clear=step)
        if len(starts) <= len(failures):
            raise failures[len(starts) - 1]
        return step

    return work, starts


def test_recovery_restarts_from_the_checkpoint(tmp_path):
    restarts = []
    work, starts = _work(tmp_path, [dist.DistError("peer lost"),
                                    RuntimeError("launch failed: CUDA error 700")])
    assert run_with_checkpoint_recovery(
        work, str(tmp_path), on_restart=restarts.append) == 3
    assert starts == [0, 1, 2] and restarts == [1, 2]


def test_recovery_gives_up_after_max_restarts(tmp_path):
    work, starts = _work(tmp_path, [dist.DistError("down")] * 3)
    with pytest.raises(dist.DistError):
        run_with_checkpoint_recovery(work, str(tmp_path), max_restarts=2)
    assert starts == [0, 1, 2]


@pytest.mark.parametrize("err", [ValueError("bad"), TypeError("bad"),
                                 NotImplementedError("not ported")],
                         ids=["ValueError", "TypeError", "NotImplementedError"])
def test_recovery_passes_caller_errors(tmp_path, err):
    work, starts = _work(tmp_path, [err])
    with pytest.raises(type(err)):
        run_with_checkpoint_recovery(work, str(tmp_path))
    assert starts == [0]


def test_local_device_info_and_cli(capsys):
    info = local_device_info("cpu")
    assert set(info) == INFO_KEYS
    assert info["platform"] == "cpu" and info["process_count"] == 1
    assert cli_main(["info", "--device", "cpu"]) == 0
    printed = json.loads(capsys.readouterr().out)
    assert set(printed) == INFO_KEYS | {"devices"}
    assert printed["devices"] == ["cpu"]
