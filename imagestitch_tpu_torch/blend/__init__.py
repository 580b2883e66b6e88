"""imagestitch_tpu_torch.blend (see the modules)."""
