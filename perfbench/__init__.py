"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one card.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``.  Everything a cell
needs is found by name: its traffic in ``workloads/<cell>.json``, its
configuration in ``configs/<config>.json``, its driver in
``drivers/<kind>.py`` and each per-layer metric's reader in
``metrics/<metric>.py``.  The plain reference that decides ``correct``
lives in ``reference/`` and imports nothing of the program.
"""
