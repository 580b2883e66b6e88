"""imagestitch_tpu_torch's image I/O and real-photo loaders against
`imagestitch_tpu.utils.io`, and the port's `stitch_pair` on the real
photograph, on the CPU (the kernels' plain versions).

- The loaders give the same arrays (bit for bit), the same H_true, focal
  and shift; the port reads its own copy of the photograph, byte for byte
  the JAX package's. `imwrite` / `imread` round-trip losslessly through
  PNG, and each package reads the other's file to the same array.
- `stitch_pair` on `photo_rotation_pair()` with the JAX key-0 RANSAC
  draws injected, held to the committed golden of the JAX package
  (`tests/data/golden_photo_pano.{png,json}`) with `tests/test_golden.py`'s
  tolerances: focal within 2%, inliers >= 0.7x, corner and bbox within
  8 px, PSNR > 30 dB on the 4x box-downsampled pano over the pixels valid
  in both; and to JAX's `stitch_pair_core` on the same pair: equal corner
  and counts, focal within 1e-3, valid-mask IoU >= 0.999 and PSNR >=
  40 dB (`tests/test_torch_pipeline.py`'s tolerances).
- The real-pixel translation pair's homography is the exact shift within
  1 px, the scale within 1% and the shear within 0.01
  (`tests/test_golden.py:124`).
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import imagestitch_tpu as jist  # noqa: E402
from imagestitch_tpu.pipeline import stitch_pair_core  # noqa: E402
from imagestitch_tpu.utils import io as jio  # noqa: E402
import imagestitch_tpu_torch as tist  # noqa: E402
from imagestitch_tpu_torch.features import detect  # noqa: E402
from imagestitch_tpu_torch.matching.matcher import match_pair  # noqa: E402
from imagestitch_tpu_torch.ops.image import rgb_to_gray  # noqa: E402
from imagestitch_tpu_torch.pipeline import stitch_pair_impl  # noqa: E402
from imagestitch_tpu_torch.utils import io as tio  # noqa: E402

from test_torch_pipeline import _draws  # noqa: E402

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
DOWN = 4


def test_port_reads_its_own_photo_copy():
    here = os.path.dirname(os.path.abspath(tio.__file__))
    assert os.path.dirname(tio.DATA_DIR) == here
    jdir = os.path.join(os.path.dirname(os.path.abspath(jio.__file__)),
                        "data")
    with open(os.path.join(tio.DATA_DIR, "china.jpg"), "rb") as f:
        ours = f.read()
    with open(os.path.join(jdir, "china.jpg"), "rb") as f:
        theirs = f.read()
    assert len(ours) == 196653 and ours == theirs
    assert os.path.exists(os.path.join(tio.DATA_DIR, "ATTRIBUTION.txt"))


@pytest.mark.parametrize("name", ["load_photo", "photo_rotation_pair",
                                  "photo_rotation_pair_yaw12",
                                  "photo_translation_pair",
                                  "photo_translation_pair_0.3",
                                  "synthetic_affine_pair",
                                  "synthetic_affine_pair_small"])
def test_loaders_match_jax(name):
    calls = {
        "load_photo": ("load_photo", ()),
        "photo_rotation_pair": ("photo_rotation_pair", ()),
        "photo_rotation_pair_yaw12": ("photo_rotation_pair", (12.0, 1.0,
                                                              0.5)),
        "photo_translation_pair": ("photo_translation_pair", ()),
        "photo_translation_pair_0.3": ("photo_translation_pair", (0.3,)),
        "synthetic_affine_pair": ("synthetic_affine_pair", ()),
        "synthetic_affine_pair_small": ("synthetic_affine_pair",
                                        (160, 224, 4.0, 0.97, None, -6.0,
                                         3)),
    }
    fn, args = calls[name]
    j = getattr(jio, fn)(*args)
    t = getattr(tio, fn)(*args)
    if fn == "load_photo":
        j, t = (j,), (t,)
    assert len(j) == len(t)
    for a, b in zip(j, t):
        if isinstance(a, np.ndarray) and a.dtype == np.uint8:
            assert b.dtype == np.uint8 and np.array_equal(a, b)
        else:
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


@pytest.mark.parametrize("ndim", [2, 3])
def test_imwrite_imread_round_trip(tmp_path, ndim):
    rng = np.random.default_rng(ndim)
    img = rng.integers(0, 256, (37, 53, 3)[:ndim]).astype(np.uint8)
    pt, pj = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    tio.imwrite(pt, img)
    jio.imwrite(pj, img)
    want = img if ndim == 3 else np.repeat(img[..., None], 3, axis=2)
    for path in (pt, pj):
        assert np.array_equal(tio.imread(path), want)
        assert np.array_equal(tio.imread(path), jio.imread(path))
    # floats are clipped to 0..255 and truncated, as in the JAX package
    f = img.astype(np.float32) * 1.5 - 20.0
    tio.imwrite(pt, f)
    jio.imwrite(pj, f)
    assert np.array_equal(tio.imread(pt), jio.imread(pj))


def _crop_down(pano, valid):
    ys, xs = np.nonzero(valid)
    bbox = (int(ys.min()), int(xs.min()), int(ys.max()) + 1,
            int(xs.max()) + 1)
    crop = pano[bbox[0]:bbox[2], bbox[1]:bbox[3]]
    vcrop = valid[bbox[0]:bbox[2], bbox[1]:bbox[3]]
    return bbox, _box_down(crop), _box_down(
        vcrop[..., None].astype(np.float32))[..., 0]


def _box_down(img):
    h, w = img.shape[0] // DOWN * DOWN, img.shape[1] // DOWN * DOWN
    img = img[:h, :w].astype(np.float32)
    return img.reshape(h // DOWN, DOWN, w // DOWN, DOWN, -1).mean(
        axis=(1, 3))


@pytest.fixture(scope="module")
def photo():
    """The photo rotation pair stitched by JAX (key 0) and by the port with
    the same draws."""
    a, b, _, f_true = tio.photo_rotation_pair()
    key = jax.random.key(0)
    pj, vj, cj, mj = stitch_pair_core(jnp.asarray(a, jnp.float32),
                                      jnp.asarray(b, jnp.float32), key,
                                      jist.PipelineConfig())
    pt, vt, ct, mt = stitch_pair_impl(torch.as_tensor(a),
                                      torch.as_tensor(b),
                                      tist.PipelineConfig(),
                                      draws=_draws(key))
    return dict(j=(np.asarray(pj), np.asarray(vj), np.asarray(cj),
                   {k: np.asarray(v) for k, v in mj.items()}),
                t=(pt.numpy(), vt.numpy(), ct.numpy(),
                   {k: v.numpy() for k, v in mt.items()}),
                f_true=f_true)


def test_photo_stitch_matches_golden(photo):
    with open(os.path.join(DATA, "golden_photo_pano.json")) as f:
        meta = json.load(f)
    gpng = tio.imread(os.path.join(DATA, "golden_photo_pano.png")).astype(
        np.float32)
    pano, valid, corner, m = photo["t"]
    assert bool(m["h_valid"])
    assert abs(float(m["focal"]) - meta["focal"]) / meta["focal"] < 0.02
    assert abs(float(m["focal"]) - photo["f_true"]) / photo["f_true"] < 0.05
    assert int(m["num_inliers"]) >= int(0.7 * meta["num_inliers"])
    assert abs(int(corner[0]) - meta["corner"][0]) <= 8
    assert abs(int(corner[1]) - meta["corner"][1]) <= 8
    bbox, down, vdown = _crop_down(pano, valid)
    assert np.abs(np.array(bbox) - np.array(meta["bbox"])).max() <= 8
    h = min(down.shape[0], gpng.shape[0])
    w = min(down.shape[1], gpng.shape[1])
    both = vdown[:h, :w] > 0.99
    assert both.mean() > 0.8
    mse = float(np.mean((down[:h, :w][both] - gpng[:h, :w][both]) ** 2))
    psnr = 10 * np.log10(255.0 ** 2 / max(mse, 1e-9))
    assert psnr > 30.0, psnr


def test_photo_stitch_matches_jax(photo):
    pj, vj, cj, mj = photo["j"]
    pt, vt, ct, mt = photo["t"]
    assert sorted(mt) == sorted(mj)
    for k in ("kpts1", "kpts2", "num_matches", "num_inliers", "h_valid",
              "canvas_overflow"):
        assert int(mt[k]) == int(mj[k]), k
    assert abs(float(mt["focal"]) - float(mj["focal"])) \
        <= 1e-3 * float(mj["focal"])
    assert np.array_equal(ct, cj)
    assert pt.shape == pj.shape
    assert (vt & vj).sum() / max((vt | vj).sum(), 1) >= 0.999
    both = vt & vj
    mse = np.mean((pt[both].astype(np.float64) - pj[both]) ** 2)
    assert 10 * np.log10(255.0 ** 2 / max(mse, 1e-12)) >= 40.0


def test_photo_translation_pair_registration():
    a, b, shift = tio.photo_translation_pair()
    cfg = tist.PipelineConfig()
    f1 = detect(rgb_to_gray(torch.as_tensor(a)), cfg.detector)
    f2 = detect(rgb_to_gray(torch.as_tensor(b)), cfg.detector)
    mi = match_pair(f1, f2, 0, 1, cfg.matcher, cfg.ransac,
                    draws=_draws(jax.random.key(0)))
    assert bool(mi.h_valid)
    H = mi.H.numpy().astype(np.float64)
    H = H / H[2, 2]
    assert abs(H[0, 2] + shift) < 1.0, H
    assert abs(H[1, 2]) < 1.0, H
    assert abs(H[0, 0] - 1) < 0.01 and abs(H[1, 1] - 1) < 0.01
    assert abs(H[0, 1]) < 0.01 and abs(H[1, 0]) < 0.01
