"""The benchmark of the PyTorch and CUDA port (``xiangqi_alphazero_torch``).

``python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once; see ``run.py``.
"""
