"""The benchmark of the PyTorch and CUDA port (``nerfca_tpu_torch``).

``python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell once and prints one JSON line; see ``harness.py``.
"""
