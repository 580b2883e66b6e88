"""imagestitch_tpu_torch's fixed-N chain (`stitch_chain_impl`) and what it
is built from, against `imagestitch_tpu` on the CPU (the kernels' plain
versions), with the JAX RANSAC draws injected per pair.

- The N-view fixtures: `synthetic_sequence` and `synthetic_grid` give the
  same bytes as the JAX package's.
- Batched detect: `detect_batched` on N views equals `detect_and_compute`
  on each view, every field bit for bit (the pyramid and the detector
  maps are per-pixel, so the batch changes no rounding).
- `estimate_cameras_spliced` against JAX's on the same homographies and
  masks, with a broken link the splice bridges and one it cannot: equal
  `reachable`, focal within 1e-5 relative and R within 1e-5 (float32
  3x3 inverses and products, in another order of operations).
- The chain at 160x224 with 4 views, plane warp:
  - strict, `ba_refine=False`, on `synthetic_sequence`: counts, h_valid,
    reachable, overflow and corner equal; focal within 1e-3 relative;
    ROIs within 0.5 px; valid-mask IoU >= 0.999; PSNR >= 40 dB over the
    pixels both canvases cover;
  - the default bundle adjustment on a camera panning 10 degrees a view
    (rendered here from the fixture's scene): the same tolerances (1.3e-4
    apart in focal and 66 dB when written);
  - the default bundle adjustment on the `synthetic_sequence`, a
    near-pure translation: counts, h_valid, reachable and overflow equal,
    focal within 5e-2 relative, IoU >= 0.98. The adjuster walks a flat
    valley there (ROADMAP Queue C, "Translation-pair focal after bundle
    adjustment", where the pair path holds 1e-2): fed the same cameras
    and points, the two adjusters stopped at 848.8 and 847.4 px from an
    initial 384, and a change of 1.2e-7 in the initial rotations moved
    the port's stop to 826.2 px and JAX's to 843.0 (2.7% of spread). The
    end-to-end runs stood 1.8e-2 apart, IoU 0.995, when written;
  - the splice: a noise view in the middle of a 4-view sequence gives
    reachable [T, T, F, F] without `chain_splice` and [T, T, F, T] with
    it, as in JAX;
  - the host `stitch_chain`: the same metric keys, h_valid, reachable
    and cropped pano shape as JAX's.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from imagestitch_tpu import config as jcfg  # noqa: E402
from imagestitch_tpu.geometry import rotation as jrot  # noqa: E402
from imagestitch_tpu.pipeline import stitch_chain_core  # noqa: E402
from imagestitch_tpu.utils import io as jio  # noqa: E402
from imagestitch_tpu_torch.convert import config_from_dict  # noqa: E402
from imagestitch_tpu_torch.features import (  # noqa: E402
    detect_and_compute, detect_batched)
from imagestitch_tpu_torch.geometry.rotation import (  # noqa: E402
    estimate_cameras_spliced)
from imagestitch_tpu_torch.ops.image import rgb_to_gray  # noqa: E402
from imagestitch_tpu_torch.pipeline import stitch_chain_impl  # noqa: E402
from imagestitch_tpu_torch.types import ImageFeatures  # noqa: E402
from imagestitch_tpu_torch.utils import io as tio  # noqa: E402

torch.set_num_threads(2)

# the JAX package's chain test configuration (tests/test_pipeline.py)
FAST_DET = jcfg.DetectorConfig(nfeatures=256, max_keypoints=768)
CHAIN_CFG = jcfg.PipelineConfig(
    detector=FAST_DET,
    matcher=jcfg.MatcherConfig(max_matches=256),
    ransac=jcfg.RansacConfig(num_hypotheses=512),
    camera=jcfg.CameraConfig(ba_refine=False),
    warp=jcfg.WarpConfig(kind="plane", canvas_scale_w=2.2,
                         canvas_scale_h=1.4),
)
BA_CFG = CHAIN_CFG.replace(camera=jcfg.CameraConfig())
CASES = {
    "strict": CHAIN_CFG,
    "rotation_ba": BA_CFG,
    "splice_on": CHAIN_CFG.replace(chain_splice=True),
    # the cases below reuse a program compiled for a case above
    "translation_ba": BA_CFG,
    "splice_off": CHAIN_CFG,
}
DISTINCT = ("strict", "rotation_ba", "splice_on")
# focal (relative), ROI (px), IoU, PSNR (dB); None: not held
TOL = {"strict": (1e-3, 0.5, 0.999, 40.0),
       "rotation_ba": (1e-3, 0.5, 0.999, 40.0),
       "translation_ba": (5e-2, None, 0.98, None)}


def pan_sequence(n, height=160, width=224, step_deg=10.0, seed=7):
    """N views of one planar scene from a camera panning `step_deg` a view
    about its centre, focal 0.9 x width (the N-view counterpart of
    synthetic_rotation_pair): the port's `synthetic_pan_sequence`."""
    return tio.synthetic_pan_sequence(n, height, width, step_deg, seed)


def _views(case):
    if case.startswith("splice"):
        views, _ = jio.synthetic_sequence(4, 160, 224, overlap=0.7, seed=31)
        views = list(views)
        views[2] = np.asarray(np.random.default_rng(0).integers(
            0, 255, views[2].shape), np.uint8)
        return views
    if case == "rotation_ba":
        return pan_sequence(4)
    return jio.synthetic_sequence(4, 160, 224, overlap=0.5, seed=9)[0]


def pair_draws(key, num_hypotheses):
    """JAX match_pair's RANSAC draws under `key`: the first pass's and the
    inlier refit's."""
    return (np.asarray(jax.random.uniform(key, (num_hypotheses, 4))),
            np.asarray(jax.random.uniform(jax.random.fold_in(key, 1),
                                          (min(256, num_hypotheses), 4))))


def chain_draws(key, n, num_hypotheses, splice):
    """Per pair (i, j), the draws JAX's chain gives it: fold_in(key, i) for
    i -> i+1, fold_in(key, N-1+j) for the skip pair j -> j+2."""
    d = {(i, i + 1): pair_draws(jax.random.fold_in(key, i), num_hypotheses)
         for i in range(n - 1)}
    if splice and n >= 3:
        d.update({(j, j + 2): pair_draws(jax.random.fold_in(key, n - 1 + j),
                                         num_hypotheses)
                  for j in range(n - 2)})
    return d


def _jax_chain(case):
    imgs = jnp.asarray(np.stack(_views(case)), jnp.float32)
    p, v, c, m = stitch_chain_core(imgs, jax.random.key(0), CASES[case])
    return (np.asarray(p), np.asarray(v), np.asarray(c),
            {k: np.asarray(x) for k, x in m.items()})


@pytest.fixture(scope="module")
def runs():
    """Per case: the JAX chain (the three distinct programs compiled in
    threads, then the cases that reuse them) and the port's with the same
    per-pair draws."""
    with ThreadPoolExecutor(len(DISTINCT)) as ex:
        jax_out = dict(zip(DISTINCT, ex.map(_jax_chain, DISTINCT)))
    jax_out.update({c: _jax_chain(c) for c in CASES if c not in DISTINCT})
    out = {}
    for case, cfg in CASES.items():
        views = _views(case)
        draws = chain_draws(jax.random.key(0), len(views),
                            cfg.ransac.num_hypotheses, cfg.chain_splice)
        p, v, c, m = stitch_chain_impl(
            torch.as_tensor(np.stack(views)),
            config_from_dict(dataclasses.asdict(cfg)), draws=draws)
        out[case] = dict(j=jax_out[case], t=(
            p.numpy(), v.numpy(), c.numpy(),
            {k: x.numpy() for k, x in m.items()}))
    return out


def _iou(a, b):
    return (a & b).sum() / max((a | b).sum(), 1)


@pytest.mark.parametrize("case", ["sequence", "sequence_wide", "grid"])
def test_fixtures_same_bytes_as_jax(case):
    if case == "grid":
        j = jio.synthetic_grid(2, 2, 160, 224, overlap=0.55, seed=33)
        t = tio.synthetic_grid(2, 2, 160, 224, overlap=0.55, seed=33)
    else:
        args = ((4, 160, 224, 0.5, 9) if case == "sequence"
                else (8, 96, 128, 0.7, 3))
        j = jio.synthetic_sequence(*args)
        t = tio.synthetic_sequence(*args)
    assert j[1:] == t[1:]
    assert len(j[0]) == len(t[0])
    for a, b in zip(j[0], t[0]):
        assert a.dtype == b.dtype == np.uint8
        assert np.array_equal(a, b)


@pytest.mark.parametrize("n", [1, 3])
def test_batched_detect_equals_per_view(n):
    views = tio.synthetic_sequence(n, 160, 224, overlap=0.5, seed=9)[0]
    grays = rgb_to_gray(torch.as_tensor(np.stack(views)))
    cfg = config_from_dict(dataclasses.asdict(CHAIN_CFG)).detector
    batched = detect_batched(grays, cfg)
    for i in range(n):
        one = detect_and_compute(grays[i], cfg)
        for f in dataclasses.fields(ImageFeatures):
            assert torch.equal(getattr(batched, f.name)[i],
                               getattr(one, f.name)), (i, f.name)


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _spliced_inputs(n=5, f=300.0):
    """Center-normalized homographies of a camera panning by 8 degrees a
    step, slightly perturbed: H maps view i's points into view j's."""
    K = np.diag([f, f, 1.0])
    Rs = [_rot_y(np.deg2rad(8.0 * i)) @ _rot_y(1e-3 * i * i).T
          for i in range(n)]
    rng = np.random.default_rng(5)

    def H(i, j):
        h = K @ Rs[j] @ Rs[i].T @ np.linalg.inv(K)
        return (h / h[2, 2] + 1e-4 * rng.standard_normal((3, 3))
                ).astype(np.float32)

    H1 = np.stack([H(i, i + 1) for i in range(n - 1)])
    H2 = np.stack([H(i, i + 2) for i in range(n - 2)])
    return H1, H2


SPLICE_CASES = {
    # link 1 -> 2 broken, bridged by the skip pair 0 -> 2
    "bridged": ([1, 0, 1, 1], [1, 1, 1], [1, 1, 1, 1], [1, 1, 1]),
    # link 1 -> 2 broken and its skip pair 0 -> 2 too: view 2 drops out,
    # view 3 comes back through the skip pair 1 -> 3
    "unbridgeable": ([1, 0, 1, 1], [0, 1, 1], [1, 1, 1, 1], [1, 1, 1]),
    # an invalid H: out of the focal median and of the chain
    "invalid_h": ([1, 1, 0, 1], [1, 0, 1], [1, 1, 0, 1], [1, 0, 1]),
}


@pytest.mark.parametrize("case", list(SPLICE_CASES))
def test_estimate_cameras_spliced_matches_jax(case):
    good1, good2, valid1, valid2 = (np.asarray(x, bool)
                                    for x in SPLICE_CASES[case])
    H1, H2 = _spliced_inputs()
    sizes = np.asarray([[160, 224], [160, 224], [150, 220], [160, 224],
                        [160, 224]], np.int32)
    jc, jr = jrot.estimate_cameras_spliced(
        jnp.asarray(H1), jnp.asarray(valid1), jnp.asarray(good1),
        jnp.asarray(H2), jnp.asarray(valid2), jnp.asarray(good2),
        jnp.asarray(sizes))
    tc, tr = estimate_cameras_spliced(
        torch.as_tensor(H1), torch.as_tensor(valid1), torch.as_tensor(good1),
        torch.as_tensor(H2), torch.as_tensor(valid2), torch.as_tensor(good2),
        torch.as_tensor(sizes))
    assert tr.tolist() == np.asarray(jr).tolist()
    if case == "unbridgeable":
        assert tr.tolist() == [True, True, False, True, True]
    np.testing.assert_allclose(tc.focal.numpy(), np.asarray(jc.focal),
                               rtol=1e-5)
    np.testing.assert_allclose(tc.R.numpy(), np.asarray(jc.R), atol=1e-5)
    for k in ("ppx", "ppy", "aspect", "t"):
        assert np.array_equal(getattr(tc, k).numpy(),
                              np.asarray(getattr(jc, k))), k


@pytest.mark.parametrize("case", list(TOL))
def test_chain_metrics_match_jax(runs, case):
    focal_tol, roi_tol, _, _ = TOL[case]
    _, _, cj, mj = runs[case]["j"]
    _, _, ct, mt = runs[case]["t"]
    assert sorted(mt) == sorted(mj)
    for k in ("num_inliers", "h_valid", "reachable", "canvas_overflow"):
        assert np.array_equal(mt[k], mj[k]), k
    assert mt["h_valid"].all() and mt["reachable"].all()
    assert abs(float(mt["focal"]) - float(mj["focal"])) \
        <= focal_tol * float(mj["focal"])
    np.testing.assert_allclose(mt["confidence"], mj["confidence"],
                               rtol=1e-6)
    if roi_tol is not None:
        assert np.array_equal(ct, cj)
        np.testing.assert_allclose(mt["roi_uv"], mj["roi_uv"], atol=roi_tol)


@pytest.mark.parametrize("case", list(TOL))
def test_chain_canvas_matches_jax(runs, case):
    _, _, iou_tol, psnr_tol = TOL[case]
    pj, vj, _, _ = runs[case]["j"]
    pt, vt, _, _ = runs[case]["t"]
    assert pt.shape == pj.shape
    assert _iou(vt, vj) >= iou_tol
    if psnr_tol is not None:
        both = vt & vj
        mse = np.mean((pt[both].astype(np.float64) - pj[both]) ** 2)
        psnr = 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))
        assert psnr >= psnr_tol, psnr


@pytest.mark.parametrize("case,want", [
    ("splice_off", [True, True, False, False]),
    ("splice_on", [True, True, False, True])])
def test_chain_splice_reachable_matches_jax(runs, case, want):
    _, vj, _, mj = runs[case]["j"]
    _, vt, _, mt = runs[case]["t"]
    assert mt["reachable"].tolist() == mj["reachable"].tolist() == want
    assert np.array_equal(mt["h_valid"], mj["h_valid"])
    assert _iou(vt, vj) >= 0.999


def test_host_stitch_chain_matches_jax():
    """The host entry points on the strict case's views (JAX's program is
    the fixture's, cached): the same metric keys (the port's with its
    spans), h_valid and reachable, and the same cropped pano shape."""
    from imagestitch_tpu.pipeline import stitch_chain as jax_stitch_chain
    from imagestitch_tpu_torch import stitch_chain
    views = _views("strict")
    pj, mj = jax_stitch_chain(views, CHAIN_CFG)
    pt, mt = stitch_chain(views, config_from_dict(dataclasses.asdict(
        CHAIN_CFG)), device="cpu", draws=chain_draws(
            jax.random.key(0), 4, CHAIN_CFG.ransac.num_hypotheses, False))
    # the JAX entry's keys, and the stages inside the port's and their
    # counter (no bundle adjustment here; tests/test_torch_spans.py)
    inside = {"detect", "match", "cameras", "warp", "exposure",
              "seam_blend", "seam_dp", "readback_crop", "readback_bytes"}
    assert sorted(mt) == sorted({*mj, *inside})
    assert mt["h_valid"] == mj["h_valid"] and all(mt["h_valid"])
    assert mt["reachable"] == mj["reachable"]
    assert pt.dtype == np.uint8 and pt.shape == pj.shape
