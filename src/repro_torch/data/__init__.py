"""repro_torch.data — the reference's synthetic data pipeline."""
