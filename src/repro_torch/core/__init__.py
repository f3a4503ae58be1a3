"""repro_torch.core — the parts of the reference's cost/solver layer the
port's serving path needs so far: the exit metric and the bucket ladder."""
