"""imagestitch_tpu_torch.exposure (see the modules)."""
