"""imagestitch_tpu_torch `stitch_pair` end to end against
`imagestitch_tpu` on the synthetic 192x256 translation and rotation pairs
with the default PipelineConfig, on the CPU (the kernels' plain versions).

With the JAX RANSAC draws injected the two must agree: equal metric keys,
keypoint / match / inlier counts and canvas corner; focal within 1e-3
relative; valid-mask IoU >= 0.999; PSNR >= 40 dB over the pixels both
panoramas cover. Without injected draws (the port's own torch.Generator)
only h_valid, focal within 2% and IoU >= 0.98 are asked: other samples
give a slightly different homography.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import imagestitch_tpu as jist  # noqa: E402
from imagestitch_tpu.pipeline import stitch_pair_core  # noqa: E402
import imagestitch_tpu_torch as tist  # noqa: E402
from imagestitch_tpu_torch.pipeline import stitch_pair_impl  # noqa: E402
from imagestitch_tpu_torch.utils.io import (synthetic_pair,  # noqa: E402
                                            synthetic_rotation_pair)

torch.set_num_threads(2)

PAIRS = ["translation", "rotation"]


def _pair(name):
    if name == "translation":
        return synthetic_pair(192, 256)[:2]
    return synthetic_rotation_pair(192, 256)[:2]


def _draws(key):
    return (np.asarray(jax.random.uniform(key, (2048, 4))),
            np.asarray(jax.random.uniform(jax.random.fold_in(key, 1),
                                          (256, 4))))


@pytest.fixture(scope="module")
def runs():
    """Per pair: the JAX canvas, mask, corner and metrics (one compiled
    program for both pairs), the port's with the JAX draws, and both host
    entry points' metrics."""
    key = jax.random.key(0)
    draws = _draws(key)
    out = {}
    for name in PAIRS:
        a, b = _pair(name)
        pj, vj, cj, mj = stitch_pair_core(jnp.asarray(a), jnp.asarray(b),
                                          key, jist.PipelineConfig())
        pt, vt, ct, mt = stitch_pair_impl(
            torch.as_tensor(a), torch.as_tensor(b), tist.PipelineConfig(),
            draws=draws)
        out[name] = dict(
            j=(np.asarray(pj), np.asarray(vj), np.asarray(cj),
               {k: np.asarray(v) for k, v in mj.items()}),
            t=(pt.numpy(), vt.numpy(), ct.numpy(),
               {k: v.numpy() for k, v in mt.items()}),
            host_j=jist.stitch_pair(a, b, seed=0),
            host_t=tist.stitch_pair(a, b, seed=0, device="cpu"),
            host_t_draws=tist.stitch_pair(a, b, seed=0, device="cpu",
                                          draws=draws))
    return out


def _iou(a, b):
    return (a & b).sum() / max((a | b).sum(), 1)


@pytest.mark.parametrize("name", PAIRS)
def test_stitch_pair_metrics_match_jax(runs, name):
    _, _, cj, mj = runs[name]["j"]
    _, _, ct, mt = runs[name]["t"]
    assert sorted(mt) == sorted(mj)
    for k in ("kpts1", "kpts2", "num_matches", "num_inliers", "h_valid",
              "canvas_overflow"):
        assert int(mt[k]) == int(mj[k]), k
    assert bool(mt["h_valid"])
    assert abs(float(mt["focal"]) - float(mj["focal"])) \
        <= 1e-3 * float(mj["focal"])
    assert np.array_equal(ct, cj)
    # ROI bounds follow the focal: within 1e-3 of the canvas extent
    np.testing.assert_allclose(mt["roi_uv"], mj["roi_uv"], atol=0.5)


@pytest.mark.parametrize("name", PAIRS)
def test_stitch_pair_canvas_matches_jax(runs, name):
    pj, vj, _, _ = runs[name]["j"]
    pt, vt, _, _ = runs[name]["t"]
    assert pt.shape == pj.shape
    assert _iou(vt, vj) >= 0.999
    both = vt & vj
    mse = np.mean((pt[both].astype(np.float64) - pj[both]) ** 2)
    psnr = 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))
    assert psnr >= 40.0, psnr


@pytest.mark.parametrize("name", PAIRS)
def test_host_stitch_pair_matches_jax(runs, name):
    """The host entry points: same metric keys, same cropped pano shape
    with the JAX draws; with the port's own draws h_valid, focal within
    2% and the cropped pano about the same size."""
    pj, mj = runs[name]["host_j"]
    pd, md = runs[name]["host_t_draws"]
    pt, mt = runs[name]["host_t"]
    # the JAX entry's keys, and the stages inside the port's and their
    # counters (tests/test_torch_spans.py)
    inside = {"detect", "match", "cameras", "bundle_adjust", "lm_step",
              "warp", "exposure", "seam_blend", "seam_dp", "readback_crop",
              "lm_iters", "readback_bytes"}
    assert sorted(md) == sorted(mt) == sorted({*mj, *inside})
    assert pd.shape == pj.shape and pd.dtype == np.uint8
    assert mt["h_valid"]
    assert abs(mt["focal"] - mj["focal"]) <= 0.02 * mj["focal"]
    assert abs(pt.shape[0] - pj.shape[0]) <= 0.02 * pj.shape[0]
    assert abs(pt.shape[1] - pj.shape[1]) <= 0.02 * pj.shape[1]


@pytest.mark.parametrize("name", PAIRS)
def test_stitch_pair_own_draws_iou(name):
    """The port's own draws (seeded torch.Generator) against JAX's: valid
    masks of the uncropped canvases overlap with IoU >= 0.98."""
    a, b = _pair(name)
    key = jax.random.key(0)
    _, vj, _, mj = stitch_pair_core(jnp.asarray(a), jnp.asarray(b), key,
                                    jist.PipelineConfig())
    gen = torch.Generator().manual_seed(0)
    _, vt, _, mt = stitch_pair_impl(torch.as_tensor(a), torch.as_tensor(b),
                                    tist.PipelineConfig(), generator=gen)
    assert bool(mt["h_valid"])
    assert abs(float(mt["focal"]) - float(mj["focal"])) \
        <= 0.02 * float(mj["focal"])
    assert _iou(vt.numpy(), np.asarray(vj)) >= 0.98


def test_rotation_pair_recovers_focal():
    """Known geometry: the rotation pair's focal is 0.9 x width."""
    a, b, _, f = synthetic_rotation_pair(192, 256)
    _, m = tist.stitch_pair(a, b, device="cpu")
    assert abs(m["focal"] - f) < 0.05 * f
