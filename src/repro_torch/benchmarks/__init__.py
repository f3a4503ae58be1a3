"""repro_torch.benchmarks — the paper's B-AlexNet experiment on the port:
the measured per-layer profile, the Fig. 4 / Fig. 5 sweeps of the
partitioner over it, and Fig. 6 (exit probability under blur, after
training).  Each module runs as ``python -m
repro_torch.benchmarks.<name>``."""
