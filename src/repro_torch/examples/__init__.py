"""repro_torch.examples — the reference's example scripts as port entry
points, each run as ``python -m repro_torch.examples.<name>`` (on the
current CUDA device by default, ``--device cpu`` on the CPU)."""
