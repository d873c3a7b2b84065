"""Device ms per step of every op of the fused step other than K4: the
bake and its vjp, the tables, the material and geometry scatters, Adam."""
from port_bench.kernels import is_k4


def read(view, run):
    return view.device_ms(lambda name: not is_k4(name))
