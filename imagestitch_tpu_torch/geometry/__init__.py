"""imagestitch_tpu_torch.geometry (see the modules)."""
