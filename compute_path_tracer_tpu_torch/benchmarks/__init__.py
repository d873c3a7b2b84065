"""Measurements on the card (JAX package: ``benchmarks/``): the march
diagnostics (``diagnose``), the march probes (``dense_probe``,
``analytic_probe``, ``ilp_probe``) and the hardware probes (``vpu_peak``,
``gather_probe``, ``bf16_probe``, ``mxu_transform_probe``); ``kernel_ab``
times the marching kernels of this checkout against another's.  Each runs as ``python -m
compute_path_tracer_tpu_torch.benchmarks.<name>`` on a machine with an
NVIDIA GPU and exits non-zero without one."""
