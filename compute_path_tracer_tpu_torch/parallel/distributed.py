"""Multi-process bring-up, failure recovery and topology info (JAX package:
``parallel/distributed.py``).

Every process runs the same program on one device, as PyTorch has it:
``initialize_distributed`` joins the processes into the default
``torch.distributed`` group (NCCL between cards, gloo where the caller
asks for the CPU), and ``parallel/mesh.py:make_mesh`` then spans all of
them.  Nothing tells a process of its cluster, so the coordinator's
address, the process count and this process's index come from the
arguments or from ``CPT_COORDINATOR`` (``host:port``),
``CPT_NUM_PROCESSES`` and ``CPT_PROCESS_ID``.  Failure recovery is a
restart from the last checkpoint (io/checkpoint.py); a resume is exact,
since the RNG is a pure function of (pixel, frame).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: str = "cuda",
) -> bool:
    """Join the default process group if more than one process is
    configured; returns True when running distributed (also when the group
    was initialised already) and False on one process.

    On ``device="cuda"`` the process takes card ``process_id`` modulo the
    cards it sees and the group runs NCCL; ``device="cpu"`` runs gloo."""
    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or os.environ.get(
        "CPT_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("CPT_NUM_PROCESSES", "0")) or None
    if process_id is None:
        pid = os.environ.get("CPT_PROCESS_ID")
        process_id = int(pid) if pid is not None else None
    if not coordinator_address or not num_processes or num_processes <= 1:
        return False
    if process_id is None:
        raise ValueError("a distributed run needs process_id (CPT_PROCESS_ID)")
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def _device_failure(err: RuntimeError) -> bool:
    """A failure of a device or a collective, which a restart may outlive:
    ``torch.distributed.DistError``, a CUDA error (torch's, or the port's
    kernel wrappers' "CUDA error N"), or NCCL's; not
    ``NotImplementedError``."""
    if isinstance(err, NotImplementedError):
        return False
    accel = getattr(torch, "AcceleratorError", ())
    text = str(err)
    return (isinstance(err, (dist.DistError, accel)) or "CUDA error" in text
            or "NCCL" in text)


def run_with_checkpoint_recovery(
    work,
    checkpoint_dir: str,
    *,
    max_restarts: int = 3,
    on_restart=None,
):
    """Run ``work(state) -> result`` and restart it from the last checkpoint
    after a device or collective failure, at most ``max_restarts`` times.

    ``work`` receives the checkpoint's state (``io.checkpoint.
    load_checkpoint``; an empty dict before the first checkpoint) and is
    expected to call ``io.checkpoint.save_checkpoint(checkpoint_dir, ...)``
    at its own cadence.  ``on_restart(attempt)`` is called before each
    restart.  Any other exception (the caller's ``ValueError``,
    ``TypeError``, ``NotImplementedError``) passes through at once."""
    from ..io.checkpoint import load_checkpoint

    attempts = 0
    while True:
        state = {}
        if os.path.isdir(checkpoint_dir):
            state = load_checkpoint(checkpoint_dir)
        try:
            return work(state)
        except RuntimeError as err:
            if not _device_failure(err):
                raise
            attempts += 1
            if attempts > max_restarts:
                raise
            if on_restart is not None:
                on_restart(attempts)


def local_device_info(device: str = "cuda") -> dict:
    """Topology summary for logging and perf accounting, with the JAX
    package's keys: this process's index and the process count (the
    default group's rank and size; 0 and 1 without one), the devices it
    sees, the devices of the run (one a process when distributed), and the
    platform ("gpu" or "cpu")."""
    gpu = torch.device(device).type == "cuda"
    if gpu and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu'")
    local = torch.cuda.device_count() if gpu else 1
    distributed = dist.is_available() and dist.is_initialized()
    count = dist.get_world_size() if distributed else 1
    return {
        "process_index": dist.get_rank() if distributed else 0,
        "process_count": count,
        "local_devices": local,
        "global_devices": count if distributed else local,
        "platform": "gpu" if gpu else "cpu",
    }
