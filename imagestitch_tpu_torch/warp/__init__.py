"""imagestitch_tpu_torch.warp (see the modules)."""
