"""portbench: the benchmark of the PyTorch/H100 port (``rendernet_tpu_torch``).

``python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and prints one
JSON line. Everything the cell needs is found by name: the cell in
``workloads/<cell>.json``, its model configuration in ``configs/``, the way
it drives the port in ``modes/<mode>.py`` and each per-layer metric's reader
in ``metrics/<metric>.py``. The yardstick (traffic, weights, work and byte
counts, trace reduction, the plain reference, the comparison) lives here and
imports nothing of the port; only the modes and the launch-counter reader
touch ``rendernet_tpu_torch``.
"""
