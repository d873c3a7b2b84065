"""The program's kernels as the device trace names them."""


def is_k2(name: str) -> bool:
    """K2, the marching megakernel (``megakernel_march.cu``)."""
    return "megakernel_walk" in name


def is_k4(name: str) -> bool:
    """K4, the fused training step (``train_fused.cu``: the step and its
    row sums)."""
    return "train_fused" in name or "sum_rows" in name
