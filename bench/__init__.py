"""Benchmark of the PyTorch / H100 port: ``python3 bench/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>``.  See ``bench/README.md``."""
