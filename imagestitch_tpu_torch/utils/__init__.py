"""imagestitch_tpu_torch.utils: image I/O, the synthetic and real-photo
fixtures, logging and the stage timer of `imagestitch_tpu.utils`."""

from imagestitch_tpu_torch.utils.io import (imread, imwrite, load_photo,
                                            photo_rotation_pair,
                                            photo_translation_pair,
                                            synthetic_pair,
                                            synthetic_sequence)
from imagestitch_tpu_torch.utils.log import StageTimer, get_logger

__all__ = [
    "imread",
    "imwrite",
    "load_photo",
    "photo_rotation_pair",
    "photo_translation_pair",
    "synthetic_pair",
    "synthetic_sequence",
    "StageTimer",
    "get_logger",
]
