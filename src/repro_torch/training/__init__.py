"""repro_torch.training — the reference's training substrate: the AdamW and
Adafactor optimizers over dicts of tensors, the train step with gradient
accumulation and the BranchyNet joint loss, and checkpoints in the
reference's ``.npz`` format."""
