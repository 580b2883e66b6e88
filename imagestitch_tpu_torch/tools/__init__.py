"""Measurement tools of imagestitch_tpu_torch (run on the card)."""
