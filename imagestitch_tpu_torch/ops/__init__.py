"""imagestitch_tpu_torch.ops (see the modules)."""
