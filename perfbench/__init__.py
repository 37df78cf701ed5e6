"""Benchmark of the PyTorch/CUDA triad-census port (``repro_torch``).

Run from the root of a checkout: ``python3 perfbench/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>``.
"""
