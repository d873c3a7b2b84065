"""K4's share of its roofline: the least time the card could take for a
step's counted work (port_bench/reference/count.py:fused_ops) over K4's
device ms per step, in %."""
import torch

from port_bench.kernels import is_k4
from port_bench.stats import bound_ms


def read(view, run):
    if not view.count(is_k4):
        return None
    ops, n_bytes = run.step_work
    bound = bound_ms(ops, n_bytes, torch.cuda.get_device_name())
    return bound / view.device_ms(is_k4) * 100.0
