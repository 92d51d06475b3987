"""The benchmark of the PyTorch and CUDA port (``crfconv_tpu_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on one card and
prints one JSON line. Nothing here imports JAX or the JAX package.
"""
