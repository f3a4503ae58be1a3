"""repro_torch.models — the BranchyModel (layers, attention with the ring KV
cache and its training backward, the layer stack, the serving and training
entry points) on the dense GQA, Mamba2 and Zamba2 trunks, and B-AlexNet,
the paper's own evaluation network."""
