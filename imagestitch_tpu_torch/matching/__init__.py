"""imagestitch_tpu_torch.matching (see the modules)."""
