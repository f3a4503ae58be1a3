"""repro_torch.models — the dense GQA BranchyModel (layers, attention with
the ring KV cache, the layer stack, model entry points)."""
