"""cardbench: the end-to-end benchmark of ``repro_torch`` on one NVIDIA card.

One command runs one cell of ``BENCHMARK.json`` once::

    python cardbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: a cell's configuration in ``configs/``, its
traffic mix in ``traffic/``, its correctness limits in ``limits/``, the
driver of its traffic's kind in ``drivers/``, each per-layer metric's
reader in ``metrics/`` and each configuration's plain reference in
``reference/``. Nothing here imports JAX or the JAX package.
"""
