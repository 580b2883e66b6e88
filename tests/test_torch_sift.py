"""imagestitch_tpu_torch SIFT path against `imagestitch_tpu` on the CPU:
the octave-seed resize, the plain version of the octave-maps kernel, the
block candidates, `detect_and_compute_sift`, the L2 distance matrix, L2
matching of the JAX detector's features carried across by `convert`, and
`stitch_pair` with DetectorConfig(kind="sift") end to end with the JAX
RANSAC draws injected.

Tolerances, each with its reason:
- resize within 1e-4 (two float32 ulps at 255): the product sums its taps
  in XLA:CPU's order at most shapes, and the column sums of the weight
  matrix may round differently by one ulp.
- octave maps within 1e-4 and the same nonzero score support: XLA:CPU's
  exp differs from torch's by one ulp for some blur taps (ROADMAP Queue C).
- keypoints: count, valid and level equal, xy within 1e-3 px, response
  within 1e-3, size within 1e-3 relative.
- orientations and descriptors: atan2, exp, sin and cos come from other
  libraries in torch and XLA, so a sample may land in the neighbouring
  histogram bin. Angles within 5e-3 rad; descriptor L2 distance < 1e-3 on
  at least 95% of the valid keypoints and < 0.05 on all (the worst seen
  on these images is about 0.01).
- the stitch: equal keypoint / match / inlier counts and canvas corner,
  focal within 1e-3 relative, canvas PSNR >= 40 dB where both are valid.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import imagestitch_tpu as jist  # noqa: E402
from imagestitch_tpu.features import detect as j_detect  # noqa: E402
from imagestitch_tpu.features.sift import (  # noqa: E402
    _octave_maps as j_octave_maps,
    _topk_block_candidates as j_topk_block_candidates)
from imagestitch_tpu.matching import l2_distance_matrix as j_l2  # noqa
from imagestitch_tpu.matching.matcher import (  # noqa: E402
    match_pair_descriptors as j_match_descriptors)
from imagestitch_tpu.types import ImageFeatures as JImageFeatures  # noqa
from imagestitch_tpu.ops.image import resize as j_resize  # noqa: E402
from imagestitch_tpu.pipeline import stitch_pair_core  # noqa: E402
import imagestitch_tpu_torch as tist  # noqa: E402
from imagestitch_tpu_torch.convert import features_from_numpy  # noqa: E402
from imagestitch_tpu_torch.features import detect  # noqa: E402
from imagestitch_tpu_torch.features.sift import (  # noqa: E402
    topk_block_candidates)
from imagestitch_tpu_torch.matching.hamming import (  # noqa: E402
    l2_distance_matrix)
from imagestitch_tpu_torch.matching.matcher import (  # noqa: E402
    match_pair_descriptors)
from imagestitch_tpu_torch.ops import cuda_sift  # noqa: E402
from imagestitch_tpu_torch.ops.image import resize, rgb_to_gray  # noqa
from imagestitch_tpu_torch.pipeline import stitch_pair_impl  # noqa: E402
from imagestitch_tpu_torch.utils.io import synthetic_pair  # noqa: E402

torch.set_num_threads(2)

RESIZES = [((96, 160), (48, 80)), ((97, 161), (48, 80)),
           ((135, 240), (67, 120)), ((256, 128), (128, 64)),
           ((31, 47), (15, 23)), ((20, 30), (40, 60))]
OCTAVE_HW = (96, 160)
CONTRAST = 0.04 * 255.0 / 3          # detect_and_compute_sift's conversion
SIFT_KW = dict(kind="sift", max_keypoints=512, sift_octaves=3)
FEATURE_KEYS = ("xy", "response", "angle", "size", "level", "valid",
                "descriptors", "img_size")


def _blocky(shape, seed):
    """A blocky random texture (8 px cells) plus sub-level noise: DoG
    extrema at several scales."""
    rng = np.random.default_rng(seed)
    h, w = shape
    img = np.kron(rng.uniform(0, 255, (h // 8, w // 8)), np.ones((8, 8)))
    img = img[:h, :w].astype(np.float32)
    return img + rng.uniform(0, 1, (h, w)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_resizes():
    out = {}
    for i, (hw, out_hw) in enumerate(RESIZES):
        x = np.random.default_rng(i).uniform(0, 255, hw).astype(np.float32)
        fn = jax.jit(lambda a, s=out_hw: j_resize(a, s, "linear"))
        out[hw] = (x, np.asarray(fn(jnp.asarray(x))))
    return out


@pytest.fixture(scope="module")
def jax_octaves():
    base = _blocky(OCTAVE_HW, 3)
    out = {}
    for first in (True, False):
        fn = jax.jit(lambda a, f=first: j_octave_maps(a, f, 3, 1.6, CONTRAST,
                                                      False))
        out[first] = [np.asarray(m) for m in fn(jnp.asarray(base))]
    return base, out


@pytest.fixture(scope="module")
def pair_feats():
    """JAX and port SIFT features of both views of synthetic_pair(192,
    256), one compiled JAX detector for both."""
    i1, i2, _ = synthetic_pair(192, 256)
    jdet = jax.jit(j_detect, static_argnames=("cfg",))
    jcfg = jist.DetectorConfig(**SIFT_KW)
    out = []
    for im in (i1, i2):
        g = jnp.asarray(im, jnp.float32) @ jnp.asarray(
            [0.299, 0.587, 0.114], jnp.float32)
        fj = jdet(g, cfg=jcfg)
        ft = detect(rgb_to_gray(torch.as_tensor(im)),
                    tist.DetectorConfig(**SIFT_KW))
        out.append(({k: np.asarray(getattr(fj, k)) for k in FEATURE_KEYS},
                    {k: getattr(ft, k).numpy() for k in FEATURE_KEYS}))
    return out


@pytest.fixture(scope="module")
def stitch_runs():
    """The JAX and the port's SIFT stitch of synthetic_pair(192, 256) with
    the same RANSAC draws: the uncropped canvases with metrics, and both
    host entry points."""
    a, b, _ = synthetic_pair(192, 256)
    key = jax.random.key(0)
    draws = (np.asarray(jax.random.uniform(key, (2048, 4))),
             np.asarray(jax.random.uniform(jax.random.fold_in(key, 1),
                                           (256, 4))))
    jcfg = jist.PipelineConfig(detector=jist.DetectorConfig(**SIFT_KW))
    tcfg = tist.PipelineConfig(detector=tist.DetectorConfig(**SIFT_KW))
    pj, vj, cj, mj = stitch_pair_core(jnp.asarray(a), jnp.asarray(b), key,
                                      jcfg)
    pt, vt, ct, mt = stitch_pair_impl(torch.as_tensor(a),
                                      torch.as_tensor(b), tcfg, draws=draws)
    return dict(
        j=(np.asarray(pj), np.asarray(vj), np.asarray(cj),
           {k: np.asarray(v) for k, v in mj.items()}),
        t=(pt.numpy(), vt.numpy(), ct.numpy(),
           {k: v.numpy() for k, v in mt.items()}),
        host_j=jist.stitch_pair(a, b, jcfg, seed=0),
        host_t=tist.stitch_pair(a, b, tcfg, seed=0, device="cpu",
                                draws=draws))


@pytest.mark.parametrize("hw", [r[0] for r in RESIZES],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_resize_matches_jax_image_resize(jax_resizes, hw):
    """The antialiased `jax.image.resize` "linear", odd and even sizes,
    down and up."""
    x, ref = jax_resizes[hw]
    out = resize(torch.as_tensor(x), ref.shape).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


def test_resize_halving_is_the_antialiased_triangle():
    """A 2x reduction weighs four source pixels [1, 3, 3, 1]/8, not the
    two of a plain bilinear sample: on stripes two pixels wide, where a
    2-tap sample would read 0 or 8, the reduction reads 6 or 2."""
    x = torch.zeros(16, 32)
    x[:, 2::4] = 8.0
    x[:, 3::4] = 8.0
    out = resize(x, (8, 16))
    want = torch.tensor([6.0, 2.0] * 7).expand(8, 14)
    assert torch.allclose(out[:, 1:-1], want)


@pytest.mark.parametrize("first", [True, False], ids=["first", "later"])
def test_plain_octave_maps_match_jax(jax_octaves, first):
    """dog, score, gx, gy and gS of a first and a later octave at 96x160
    against `_octave_maps(use_pallas=False)`."""
    base, ref = jax_octaves
    out = cuda_sift.sift_octave_maps(torch.as_tensor(base), first, 3, 1.6,
                                     CONTRAST)
    names = ("dog", "score", "gx", "gy", "gS")
    for name, o, r in zip(names, out, ref[first]):
        assert o.shape == r.shape, name
        np.testing.assert_allclose(o.numpy(), r, rtol=0, atol=1e-4,
                                   err_msg=name)
    score = out[1].numpy()
    assert np.array_equal(score > 0, ref[first][1] > 0)
    assert (score > 0).sum() >= 10


def _topk_cases():
    cases = []
    score = np.zeros((2, 32, 64), np.float32)
    score[0, 2, 3] = 5.0     # block (0, 0), layer 0: the winner
    score[0, 4, 9] = 4.0     # same block and layer: dropped
    score[1, 3, 5] = 3.0     # same block, layer 1: its own winner
    score[0, 10, 40] = 2.0   # another block
    cases.append((score, 8))
    rng = np.random.default_rng(7)
    for _ in range(3):
        S, H, W = 3, int(rng.integers(17, 41)), int(rng.integers(30, 70))
        score = np.zeros((S, H, W), np.float32)
        n = int(rng.integers(5, 40))
        score[rng.integers(0, S, n), rng.integers(0, H, n),
              rng.integers(0, W, n)] = rng.uniform(1, 100, n).astype(
                  np.float32)
        cases.append((score, 16))
    # equal block maxima and a quota above the block count
    score = np.zeros((1, 16, 32), np.float32)
    score[0, 1, 1] = score[0, 9, 17] = score[0, 2, 20] = 7.0
    cases.append((score, 12))
    return cases


@pytest.mark.parametrize("case", range(5),
                         ids=["contract", "random0", "random1", "random2",
                              "ties"])
def test_topk_block_candidates_match_jax(case):
    """The JAX test's contract cases (tests/test_sift.py), then ties:
    the same scores and flat indices in the same order."""
    score, quota = _topk_cases()[case]
    js, ji = j_topk_block_candidates(jnp.asarray(score), quota)
    ts, ti = topk_block_candidates(torch.as_tensor(score), quota)
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert np.array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("view", [0, 1])
def test_detect_and_compute_sift_matches_jax(pair_feats, view):
    fj, ft = pair_feats[view]
    assert ft["descriptors"].shape == (512, 128)
    assert ft["descriptors"].dtype == np.float32
    assert np.array_equal(ft["valid"], fj["valid"])
    assert np.array_equal(ft["level"], fj["level"])
    v = fj["valid"]
    assert v.sum() > 30
    np.testing.assert_allclose(ft["xy"][v], fj["xy"][v], rtol=0, atol=1e-3)
    np.testing.assert_allclose(ft["response"][v], fj["response"][v],
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(ft["size"][v], fj["size"][v], rtol=1e-3)
    dang = np.angle(np.exp(1j * (ft["angle"][v] - fj["angle"][v])))
    assert np.abs(dang).max() < 5e-3
    dd = np.linalg.norm(ft["descriptors"][v] - fj["descriptors"][v], axis=1)
    assert (dd < 1e-3).mean() >= 0.95, np.sort(dd)[-5:]
    assert dd.max() < 0.05
    norms = np.linalg.norm(ft["descriptors"][v], axis=1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-5)


def test_l2_distance_matrix_matches_jax():
    """bf16-rounded cross term, float32 sums: within 1e-5 of the JAX
    matrix, and within bf16 rounding of the exact distances."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(32, 128)).astype(np.float32)
    b = rng.normal(size=(24, 128)).astype(np.float32)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    d = l2_distance_matrix(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    dj = np.asarray(jax.jit(j_l2)(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(d, dj, rtol=0, atol=1e-5)
    exact = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    np.testing.assert_allclose(d, exact, rtol=0, atol=2e-2)
    assert d.min() >= 0.0


def test_l2_matching_of_jax_sift_features_matches_jax(pair_feats):
    """The JAX detector's SIFT features carried across by `convert` (float
    descriptors stay float32) and matched by the port: the same match list
    as the JAX matcher, distances within 1e-5."""
    fj = [dict(f) for f, _ in pair_feats]
    ft = [features_from_numpy(f) for f in fj]
    assert ft[0].descriptors.dtype == torch.float32
    jf = [JImageFeatures(**{k: jnp.asarray(v) for k, v in f.items()})
          for f in fj]
    cfg = tist.MatcherConfig()
    pj, dj, vj = (np.asarray(a) for a in jax.jit(
        lambda a, b: j_match_descriptors(a, b, jist.MatcherConfig()))(*jf))
    pt, dt, vt = (a.numpy() for a in match_pair_descriptors(*ft, cfg))
    assert np.array_equal(vt, vj)
    assert np.array_equal(pt[vj], pj[vj])
    np.testing.assert_allclose(dt[vj], dj[vj], rtol=0, atol=1e-5)
    assert vj.sum() > 20


def test_sift_stitch_metrics_match_jax(stitch_runs):
    _, _, cj, mj = stitch_runs["j"]
    _, _, ct, mt = stitch_runs["t"]
    assert sorted(mt) == sorted(mj)
    for k in ("kpts1", "kpts2", "num_matches", "num_inliers", "h_valid",
              "canvas_overflow"):
        assert int(mt[k]) == int(mj[k]), k
    assert bool(mt["h_valid"])
    assert abs(float(mt["focal"]) - float(mj["focal"])) \
        <= 1e-3 * float(mj["focal"])
    assert np.array_equal(ct, cj)
    np.testing.assert_allclose(mt["roi_uv"], mj["roi_uv"], atol=0.5)


def test_sift_stitch_canvas_matches_jax(stitch_runs):
    pj, vj, _, _ = stitch_runs["j"]
    pt, vt, _, _ = stitch_runs["t"]
    assert pt.shape == pj.shape
    assert (vt & vj).sum() / max((vt | vj).sum(), 1) >= 0.999
    both = vt & vj
    mse = np.mean((pt[both].astype(np.float64) - pj[both]) ** 2)
    psnr = 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))
    assert psnr >= 40.0, psnr


def test_sift_host_stitch_pair_matches_jax(stitch_runs):
    """The host entry points: same metric keys, same cropped pano shape,
    focal within 1e-3."""
    pj, mj = stitch_runs["host_j"]
    pt, mt = stitch_runs["host_t"]
    # the JAX entry's keys, and the stages inside the port's and their
    # counters (tests/test_torch_spans.py), the SIFT detector's among them
    # (tests/test_torch_sift_plane.py)
    inside = {"detect", "match", "cameras", "bundle_adjust", "lm_step",
              "warp", "exposure", "seam_blend", "seam_dp", "readback_crop",
              "lm_iters", "readback_bytes", "sift_maps", "sift_refine",
              "sift_orient", "sift_describe"}
    assert sorted(mt) == sorted({*mj, *inside})
    assert pt.shape == pj.shape and pt.dtype == np.uint8
    assert mt["h_valid"] and mt["kpts1"] == mj["kpts1"]
    assert abs(mt["focal"] - mj["focal"]) <= 1e-3 * mj["focal"]
