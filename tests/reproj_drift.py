"""How far float32 rounding alone moves the reprojection bundle adjuster.

The adjuster's first damped normal matrix has a condition number near
1.5e8, so the two libraries' solves, rounding each step differently, may
end its 25 steps far apart on some inputs. This module measures that
spread inside each package: the same package run on correspondences moved
by one float32 ulp (each coordinate to its upper or lower neighbour, a
seeded choice), beside the port against the JAX package on the unmoved
ones. `tests/test_torch_bundle_options.py` holds the port against JAX
within the spread it measures here.

Run it on the CPU for the readings:

    JAX_PLATFORMS=cpu python tests/reproj_drift.py
"""

import numpy as np
import torch

import jax.numpy as jnp

from imagestitch_tpu.geometry import bundle as jbundle
from imagestitch_tpu.types import CameraParams as JCams
from imagestitch_tpu_torch.config import PipelineConfig
from imagestitch_tpu_torch.features import detect_batched
from imagestitch_tpu_torch.geometry import bundle as tbundle
from imagestitch_tpu_torch.geometry.rotation import estimate_cameras_host
from imagestitch_tpu_torch.matching.matcher import match_all, pair_list
from imagestitch_tpu_torch.ops.image import rgb_to_gray
from imagestitch_tpu_torch.types import CameraParams
from imagestitch_tpu_torch.utils.io import synthetic_pan_sequence

FIELDS = ("focal", "aspect", "ppx", "ppy", "R", "t")


def pan_inputs(n: int, h: int, w: int) -> dict:
    """The port's registration of an n-view (h, w) panning sequence, as
    numpy: cameras and the adjuster's correspondence inputs."""
    views = synthetic_pan_sequence(n, h, w)
    cfg = PipelineConfig()
    imgs = torch.as_tensor(np.stack(views)).float()
    feats = detect_batched(rgb_to_gray(imgs), cfg.detector)
    gen = torch.Generator().manual_seed(0)
    ms = match_all(feats, cfg.matcher, cfg.ransac, None, gen)
    keep = (ms.confidence > cfg.matcher.conf_thresh).numpy()
    sizes = np.asarray([[h, w]] * n, np.int32)
    cams, _, reach = estimate_cameras_host(
        ms.H.numpy(), ms.src_idx.numpy(), ms.dst_idx.numpy(),
        ms.num_inliers.numpy(), ms.h_valid.numpy() & keep, sizes,
        return_tree=True)
    assert all(reach)
    pairs = pair_list(n)
    src = torch.stack([feats.xy[i][ms.pairs[p, :, 0].long()]
                       for p, (i, _) in enumerate(pairs)])
    dst = torch.stack([feats.xy[j][ms.pairs[p, :, 1].long()]
                       for p, (_, j) in enumerate(pairs)])
    return dict(
        cams={f: getattr(cams, f).numpy() for f in FIELDS},
        args=[a.numpy() for a in (src, dst, ms.inliers & ms.valid,
                                  ms.src_idx, ms.dst_idx,
                                  torch.as_tensor(keep) & ms.h_valid)])


def one_ulp(inputs: dict, seed: int) -> dict:
    """`inputs` with every point coordinate moved to its upper or lower
    float32 neighbour (a seeded choice per coordinate)."""
    rng = np.random.default_rng(seed)
    args = list(inputs["args"])
    for k in (0, 1):
        pts = args[k].astype(np.float32)
        up = rng.random(pts.shape) < 0.5
        args[k] = np.where(up, np.nextafter(pts, np.float32(np.inf)),
                           np.nextafter(pts, np.float32(-np.inf)))
    return dict(cams=inputs["cams"], args=args)


def run_jax(inputs: dict, kind: str = "reproj"):
    c = JCams(**{k: jnp.asarray(v) for k, v in inputs["cams"].items()})
    out = jbundle.bundle_adjust(c, *[jnp.asarray(x) for x in inputs["args"]],
                                kind=kind)
    return {f: np.asarray(getattr(out, f)) for f in FIELDS}


def run_port(inputs: dict, kind: str = "reproj"):
    c = CameraParams(**{k: torch.as_tensor(v)
                        for k, v in inputs["cams"].items()})
    out = tbundle.bundle_adjust(c, *[torch.as_tensor(x)
                                     for x in inputs["args"]], kind=kind)
    return {f: getattr(out, f).numpy() for f in FIELDS}


def focal_rel(a: dict, b: dict) -> float:
    """The largest relative focal difference over the cameras."""
    return float(np.max(np.abs(a["focal"] - b["focal"]) / np.abs(b["focal"])))


def readings(n: int, h: int, w: int, seeds=(0, 1, 2)) -> dict:
    """Focal spreads on one sequence: port against JAX, and each package
    against itself on one-ulp moves of the correspondences."""
    base = pan_inputs(n, h, w)
    j0, t0 = run_jax(base), run_port(base)
    moved = [one_ulp(base, s) for s in seeds]
    return dict(
        port_vs_jax=focal_rel(t0, j0),
        jax_vs_jax_ulp=[focal_rel(run_jax(m), j0) for m in moved],
        port_vs_port_ulp=[focal_rel(run_port(m), t0) for m in moved],
        focal_jax=j0["focal"].tolist(), focal_port=t0["focal"].tolist())


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(2)
    for hw in ((160, 224), (192, 256)):
        print(hw, readings(3, *hw))
