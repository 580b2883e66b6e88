"""Command line of the port (`imagestitch_tpu.cli`):

    python -m imagestitch_tpu_torch.cli stitch a.png b.png ... -o pano.png
    python -m imagestitch_tpu_torch.cli demo -o pano.png     # synthetic pair

Two images go through `stitch_pair`, more through `stitch`. The options
and their choices are the JAX package's (the host seams `--seam graphcut`,
`graphcut_colorgrad`, `--full_seam_components` and `--seam_megapix`, and
`--mode scans`, among them), plus `--device` (default: the CUDA card;
without one it raises unless `--device cpu`).
"""

from __future__ import annotations

import argparse
import json
import sys


def _build_config(args):
    from imagestitch_tpu_torch.config import (
        BlendConfig, CameraConfig, ExposureConfig, PipelineConfig,
        SeamConfig, WarpConfig)
    return PipelineConfig().replace(
        mode=args.mode,
        warp=WarpConfig(kind=args.warp),
        seam=SeamConfig(kind=args.seam,
                        full_components=args.full_seam_components,
                        seam_megapix=args.seam_megapix),
        blend=BlendConfig(kind=args.blend),
        exposure=ExposureConfig(kind=args.exposure),
        camera=CameraConfig(ba_kind=args.ba),
        work_megapix=args.work_megapix,
        compose_megapix=args.compose_megapix,
        crop=args.crop,
    )


def main(argv=None):
    p = argparse.ArgumentParser(prog="imagestitch_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("stitch", help="stitch image files into a panorama")
    ps.add_argument("images", nargs="+")
    ps.add_argument("-o", "--output", default="pano.png")
    pd = sub.add_parser("demo", help="stitch a synthetic 2-image scene")
    pd.add_argument("-o", "--output", default="pano.png")
    pd.add_argument("--size", default="480x640")

    for q in (ps, pd):
        q.add_argument("--mode", default="panorama",
                       choices=["panorama", "scans"],
                       help="panorama: the rotation model; scans: the "
                            "affine model (flatbed or drone scans)")
        q.add_argument("--warp", default="cylindrical",
                       choices=["cylindrical", "spherical", "plane",
                                "fisheye", "stereographic"])
        q.add_argument("--seam", default="dp_color",
                       choices=["dp_color", "dp_colorgrad", "voronoi",
                                "graphcut", "graphcut_colorgrad", "none"])
        q.add_argument("--blend", default="feather",
                       choices=["feather", "multiband", "ramp", "none"])
        q.add_argument("--exposure", default="gain",
                       choices=["gain", "gain_blocks", "channels",
                                "channels_blocks", "none"])
        q.add_argument("--ba", default="ray", choices=["ray", "reproj"],
                       help="bundle adjuster: ray or reproj")
        q.add_argument("--work_megapix", type=float, default=-1.0,
                       help="registration at this many megapixels "
                            "(<=0: full resolution)")
        q.add_argument("--full_seam_components", action="store_true",
                       help="full DP seam component machinery on the "
                            "host (dp_* seam kinds)")
        q.add_argument("--compose_megapix", type=float, default=-1.0,
                       help="composite at this many megapixels in the "
                            "N-image Stitcher (<=0: full resolution)")
        q.add_argument("--seam_megapix", type=float, default=-1.0,
                       help="resolve host seams at this many megapixels "
                            "(<=0: full resolution)")
        q.add_argument("--crop", default="bbox",
                       choices=["bbox", "interior"],
                       help="final crop: bounding box of the valid pixels, "
                            "or the largest all-valid rectangle")
        q.add_argument("--seed", type=int, default=0)
        q.add_argument("--metrics", action="store_true",
                       help="print the metrics dict as JSON")
        q.add_argument("--device", default=None,
                       help="torch device (default: the CUDA card)")

    args = p.parse_args(argv)

    from imagestitch_tpu_torch.pipeline import stitch, stitch_pair
    from imagestitch_tpu_torch.utils.io import imread, imwrite, synthetic_pair

    cfg = _build_config(args)
    if args.cmd == "demo":
        h, w = (int(x) for x in args.size.split("x"))
        img1, img2, _ = synthetic_pair(h, w)
        pano, metrics = stitch_pair(img1, img2, cfg, args.seed, args.device)
    else:
        imgs = [imread(f) for f in args.images]
        if len(imgs) == 2:
            pano, metrics = stitch_pair(imgs[0], imgs[1], cfg, args.seed,
                                        args.device)
        else:
            pano, metrics = stitch(imgs, cfg, args.seed, args.device)

    imwrite(args.output, pano)
    print(f"wrote {args.output} ({pano.shape[1]}x{pano.shape[0]})")
    if args.metrics:
        print(json.dumps(metrics, default=float, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
