"""imagestitch_tpu_torch.exposure: the gain compensators of
`imagestitch_tpu.exposure` (OpenCV GAIN, GAIN_BLOCKS, CHANNELS and
CHANNELS_BLOCKS)."""

from imagestitch_tpu_torch.exposure.gain import (channels_compensate,
                                                 channels_compensate_blocks,
                                                 gain_compensate,
                                                 gain_compensate_blocks)

__all__ = ["gain_compensate", "gain_compensate_blocks",
           "channels_compensate", "channels_compensate_blocks"]
