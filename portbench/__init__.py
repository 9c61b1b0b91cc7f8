"""The benchmark of ``distributed_training_tpu_torch`` on NVIDIA cards.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` from the root of a
checkout. Everything a cell needs is found by name under this folder:
``workloads/<cell>.json``, ``configs/<config>.json``,
``traffic/<mix>.json`` (parameters) read by ``traffic/<generator>.py``, and
``metrics/<metric>.py`` for each per-layer metric. ``yardstick/`` holds
the arithmetic the numbers are read with, ``reference/`` the plain
PyTorch model that decides ``correct``.
"""
