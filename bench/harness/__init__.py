"""The benchmark harness of the PyTorch / H100 port (``repro_torch``)."""
