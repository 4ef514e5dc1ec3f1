"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card it is
started on and prints one JSON line. Everything that belongs to one
configuration, traffic mix, per-cell limit or metric lives in a file of
its own (``configs/``, ``traffic/``, ``limits/``, ``metrics/``), found by
the name the manifest gives; ``harness/`` is the general code and
``reference/`` the plain PyTorch reference that decides ``correct``.
"""
