"""The benchmark of the PyTorch/CUDA port (``csa_tpu_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line.  Everything that belongs to one configuration, traffic mix or
per-layer metric is a file of its own, found by its name in
``BENCHMARK.json`` (:mod:`perfbench.manifest`).
"""
