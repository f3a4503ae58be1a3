"""repro_torch.models — the dense GQA BranchyModel (layers, attention with
the ring KV cache, the layer stack, model entry points), the Mamba2 mixer,
and B-AlexNet, the paper's own evaluation network."""
