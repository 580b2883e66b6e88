"""imagestitch_tpu_torch.utils (see the modules)."""
