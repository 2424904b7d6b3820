"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

``python perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout; ``BENCHMARK.json`` names
the cells and metrics, and the files under ``configs/``, ``traffic/``,
``metrics/``, ``counts/``, ``reference/`` and ``limits/`` are found by
the names it gives.
"""
