"""K2's share of its roofline: the least time the card could take for a
frame's work (counted on the frozen renderer, port_bench/reference/count.py)
over K2's device ms per frame, in %."""
import torch

from port_bench.kernels import is_k2
from port_bench.stats import bound_ms


def read(view, run):
    if not view.count(is_k2):
        return None
    ops, n_bytes = run.frame_work
    bound = bound_ms(ops, n_bytes, torch.cuda.get_device_name())
    return bound / view.device_ms(is_k2) * 100.0
