"""K2's device ms per frame or edit (every ``k2_ms.<cell>``)."""
from port_bench.kernels import is_k2


def read(view, run):
    return view.device_ms(is_k2) if view.count(is_k2) else None
