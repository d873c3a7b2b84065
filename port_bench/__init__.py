"""The benchmark of the PyTorch / CUDA port (``compute_path_tracer_tpu_torch``)
on NVIDIA cards: ``python -m port_bench --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` (run.py).  It imports nothing of the JAX
package; its plain reference (``reference/``) imports nothing of the
program either."""
