"""imagestitch_tpu_torch.seam (see the modules)."""
