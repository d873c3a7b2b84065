"""K4's device ms per step of the fused inverse job."""
from port_bench.kernels import is_k4


def read(view, run):
    return view.device_ms(is_k4) if view.count(is_k4) else None
