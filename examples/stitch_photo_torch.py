"""Runnable demo of the PyTorch port: stitch two real-photo views with the
default pipeline on the CUDA card.

Uses the port's vendored photograph (imagestitch_tpu_torch/utils/data/
china.jpg, CC-BY 2.0), so it works offline on a bare install:

    python examples/stitch_photo_torch.py [out.png] [--device cpu]

Writes the pano and prints the registration metrics. It runs on the card
by default and raises without one; `--device cpu` asks for the kernels'
plain versions on the CPU.
"""

import argparse

import numpy as np


def summary(pano, metrics, focal_true: float) -> str:
    """The metrics line of examples/stitch_photo.py."""
    return (f"pano {pano.shape[1]}x{pano.shape[0]}  "
            f"h_valid={metrics['h_valid']}  "
            f"inliers={metrics['num_inliers']}  "
            f"focal={metrics['focal']:.1f} (true {focal_true:.1f})")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out_path", nargs="?", default="pano_photo.png")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from imagestitch_tpu_torch import stitch_pair
    from imagestitch_tpu_torch.utils.io import imwrite, photo_rotation_pair

    img1, img2, H_true, focal_true = photo_rotation_pair()
    pano, metrics = stitch_pair(img1, img2, device=args.device)

    print(summary(pano, metrics, focal_true))
    imwrite(args.out_path, np.asarray(pano))
    print(f"wrote {args.out_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
