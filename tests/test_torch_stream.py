"""imagestitch_tpu_torch's `StreamStitcher` against `imagestitch_tpu.
stream.StreamStitcher` on the CPU (the kernels' plain versions), with the
JAX RANSAC draws injected per matched pair, at 160x224 with the JAX
package's Stitcher test configuration (plane warp, no bundle adjustment).

- The JAX package's own case (`tests/test_pipeline.py:621`): `compose` of
  the calibration frames is within 1.0 mean of the calibration pano, and
  frames brightened by 12 compose brighter, in the same pano shape.
- Against JAX on four frame sets: that 4-view sequence, a camera panning
  10 degrees a view (`test_torch_chain.pan_sequence`) given in a shuffled
  order (`tests/test_pipeline.py:655`), a sequence whose last view is
  noise (`:684`: reachable [T, T, T, F], the noise view left out of every
  compose), and four unrelated scenes (`:424`: every pair's confidence
  under the threshold). Asked: the same metric keys, the same confident
  pairs, pair confidences within 0.05 (`test_torch_stitcher`'s tolerance:
  the JAX batched detector's Harris differs in the last bit on some
  levels, which can swap near-tied keypoints), equal reachable; the
  cached cameras' focal within 1e-3 relative and R within 1e-3, and the
  frozen seam masks equal on all but 0.1% of the canvas (the seams follow
  i -> i+1 in both, on the shuffled order too, where the spanning tree's
  edges differ). On the two translation sequences the focal comes from
  near-pure translations, where such a keypoint swap moves it by percents
  (1.04% apart on the JAX package's case when written): there the focal
  is held within 2e-2 and R within 1e-2, and the seam masks, which lie in
  frames of other focal, are not compared. The calibration and compose
  panos have the same shape within 2%; for the shuffled order the compose
  canvas's valid pixels have IoU >= 0.999 against JAX's.
- SCANS mode and the graph-cut seam (once refused) calibrate and compose
  a panning rig; without a card the default device raises.
- The stream crops to the bbox with crop="interior" too, in both
  packages (the JAX stream's quirk, followed).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from imagestitch_tpu.stream import StreamStitcher as JStream  # noqa: E402
from imagestitch_tpu.utils import io as jio  # noqa: E402
import imagestitch_tpu_torch as tist  # noqa: E402
from imagestitch_tpu_torch.convert import config_from_dict  # noqa: E402
from imagestitch_tpu_torch.pipeline import (  # noqa: E402
    _apply_exposure, _blend_resolved, _crop_valid)
from imagestitch_tpu_torch.utils.crop import autocrop  # noqa: E402

from test_torch_chain import pan_sequence  # noqa: E402
from test_torch_stitcher import ST_CFG, all_pair_draws  # noqa: E402

torch.set_num_threads(2)

CASES = ("sequence", "shuffled", "noise", "unrelated")
# focal (relative), R (absolute), seam-mask pixels apart (share); the
# translation sequences' focal comes from near-pure translations, where a
# last-bit change of a keypoint moves it by percents (ROADMAP Queue C)
TOL = {"sequence": (2e-2, 1e-2, None), "noise": (2e-2, 1e-2, None),
       "shuffled": (1e-3, 1e-3, 1e-3), "unrelated": (1e-3, 1e-3, 1e-3)}


def _views(case):
    if case == "sequence":
        return list(jio.synthetic_sequence(4, 160, 224, overlap=0.5,
                                           seed=14)[0])
    if case == "shuffled":
        views = pan_sequence(4)
        return [views[i] for i in (2, 0, 3, 1)]
    if case == "noise":
        views = list(jio.synthetic_sequence(4, 160, 224, overlap=0.5,
                                            seed=41)[0])
        rng = np.random.default_rng(3)
        views[3] = rng.integers(0, 255, views[3].shape).astype(np.uint8)
        return views
    return [jio.synthetic_pair(160, 224, seed=30 + i)[0] for i in range(4)]


def _brighter(views):
    return [np.clip(v.astype(np.int32) + 12, 0, 255).astype(np.uint8)
            for v in views]


def _jax_compose_valid(ss, views):
    """JAX's uncropped compose canvas valid mask."""
    imgs = jnp.asarray(np.stack(views), jnp.float32)
    _, valid, _ = ss._compose(imgs, ss._cams, ss._scale, ss._seam_masks,
                              ss.cfg, ss._canvas_hw)
    return np.asarray(valid)


@pytest.fixture(scope="module")
def runs():
    tcfg = config_from_dict(dataclasses.asdict(ST_CFG))
    out = {}
    for case in CASES:
        views = _views(case)
        js = JStream(ST_CFG)
        pj, mj = js.calibrate(views)
        ts = tist.StreamStitcher(tcfg, device="cpu")
        pt, mt = ts.calibrate(views, draws=all_pair_draws(
            0, len(views), ST_CFG.ransac.num_hypotheses))
        r = dict(j=(pj, mj, js.compose(views)), t=(pt, mt, ts.compose(views)),
                 js=js, ts=ts)
        if case == "sequence":
            r["bright"] = (js.compose(_brighter(views)),
                           ts.compose(_brighter(views)))
        if case == "shuffled":
            r["valid_j"] = _jax_compose_valid(js, views)
        out[case] = r
    return out


def test_compose_reuses_registration(runs):
    """tests/test_pipeline.py:621 on the port."""
    pano_cal, _, pano_same = runs["sequence"]["t"]
    _, pano2 = runs["sequence"]["bright"]
    assert pano_cal.shape == pano_same.shape
    assert np.abs(pano_cal.astype(np.int32)
                  - pano_same.astype(np.int32)).mean() < 1.0
    assert pano2.shape == pano_cal.shape
    assert pano2.astype(np.float32).mean() > \
        pano_cal.astype(np.float32).mean()
    assert runs["sequence"]["bright"][0].shape == pano2.shape


@pytest.mark.parametrize("case", CASES)
def test_stream_matches_jax(runs, case):
    pj, mj, cj = runs[case]["j"]
    pt, mt, ct = runs[case]["t"]
    js, ts = runs[case]["js"], runs[case]["ts"]
    thresh = ST_CFG.matcher.conf_thresh
    assert set(mj) <= set(mt)
    assert mt["n_images"] == mj["n_images"]
    kj = np.asarray(mj["pair_confidences"])
    kt = np.asarray(mt["pair_confidences"])
    assert np.array_equal(kt > thresh, kj > thresh)
    np.testing.assert_allclose(kt, kj, atol=0.05)
    assert mt["reachable"] == np.asarray(js._reachable).tolist()
    f_tol, r_tol, sm_tol = TOL[case]
    cams = ts.frozen("cams")
    np.testing.assert_allclose(cams.focal.numpy(),
                               np.asarray(js._cams.focal), rtol=f_tol)
    np.testing.assert_allclose(cams.R.numpy(), np.asarray(js._cams.R),
                               atol=r_tol)
    assert ts.frozen("canvas_hw") == tuple(js._canvas_hw)
    smt = ts.frozen("seam_masks").numpy()
    smj = np.asarray(js._seam_masks)
    assert smt.shape == smj.shape
    if sm_tol is not None:
        assert (smt != smj).mean() <= sm_tol
    for a, b in ((pt, pj), (ct, cj)):
        assert a.dtype == np.uint8
        for ax in (0, 1):
            assert abs(a.shape[ax] - b.shape[ax]) <= 0.02 * b.shape[ax]


def test_stream_topologies(runs):
    """The noise view is left out of the seam masks (so of every compose),
    the unrelated scenes are all flagged, and on the shuffled order the
    seams follow i -> i+1: consecutive views share no seam-mask pixel."""
    noise = runs["noise"]
    assert noise["t"][1]["reachable"] == [True, True, True, False]
    assert not bool(noise["ts"].frozen("seam_masks")[3].any())
    assert 224 + 112 <= noise["t"][2].shape[1] <= 224 + 3 * 112
    thresh = ST_CFG.matcher.conf_thresh
    unrel = runs["unrelated"]["t"][1]
    assert all(c <= thresh for c in unrel["pair_confidences"])
    assert sum(unrel["reachable"]) == 1
    sm = runs["shuffled"]["ts"].frozen("seam_masks")
    for i in range(3):
        assert not bool((sm[i] & sm[i + 1]).any())


def test_shuffled_compose_valid_matches_jax(runs):
    ts = runs["shuffled"]["ts"]
    views = _views("shuffled")
    imgs = torch.as_tensor(np.stack(views)).float()
    warped, masks = ts._warp(imgs)
    warped = _apply_exposure(warped, masks, ts.cfg)
    _, valid = _blend_resolved(warped, ts.frozen("seam_masks"), masks,
                               ts.cfg)
    vj = runs["shuffled"]["valid_j"]
    vt = valid.numpy()
    assert vt.shape == vj.shape
    assert (vt & vj).sum() / max((vt | vj).sum(), 1) >= 0.999


def test_compose_keeps_its_stages_and_its_pano(runs):
    """`compose` under its active timer: the same stages as before it read
    back through the one helper (upload, warp, exposure, blend,
    readback_crop), and the pano of the frozen registration's canvas read
    back, cropped to the bbox and clipped on the host, step by step."""
    ts = runs["sequence"]["ts"]
    views = _views("sequence")
    pano = ts.compose(views)
    assert set(ts.stages_ms) == {"upload", "warp", "exposure", "blend",
                                 "readback_crop"}
    warped, masks = ts._warp(torch.as_tensor(np.stack(views)).float())
    warped = _apply_exposure(warped, masks, ts.cfg)
    p, v = _blend_resolved(warped, ts.frozen("seam_masks"), masks, ts.cfg)
    want, _ = _crop_valid(p.numpy(), v.numpy())
    assert np.array_equal(pano, np.clip(want, 0, 255).astype(np.uint8))
    assert np.array_equal(pano, runs["sequence"]["t"][2])


@pytest.mark.parametrize("change,item", [
    ({"mode": "scans"}, 16),
    ({"seam": tist.SeamConfig(kind="graphcut")}, 15),
])
def test_unported_options_raise_with_roadmap_item(change, item):
    """The options this test once refused (ROADMAP items 15 and 16) run:
    calibrate registers every view of a panning rig, and compose of the
    calibration frames gives the calibration pano. Held against JAX in
    test_torch_host_seams.py and test_torch_scans.py."""
    cfg = tist.PipelineConfig().replace(**change)
    ss = tist.StreamStitcher(cfg, device="cpu")
    assert ss.cfg.warp.kind == ("plane" if item == 16 else "cylindrical")
    views = pan_sequence(3)
    draws = (all_pair_draws(0, 3, 2048) if item == 15 else None)
    pano, m = ss.calibrate(views, draws=draws)
    assert m["reachable"] == [True] * 3 and pano.std() > 20
    same = ss.compose(views)
    assert same.shape == pano.shape
    assert np.abs(same.astype(np.float64) - pano).mean() < 1.0


@pytest.mark.parametrize("change", [
    {"work_megapix": 0.02},
    {"camera": tist.CameraConfig(wave_correct=True)},
    {"seam": tist.SeamConfig(kind="voronoi")},
])
def test_item13_options_run(change):
    """The three options this file once refused (ROADMAP item 13) run on
    the CPU: calibrate registers every view of a panning rig, compose of
    the calibration frames gives the calibration pano. Held against JAX
    in tests/test_torch_options_pipeline.py."""
    views = pan_sequence(3)
    ss = tist.StreamStitcher(tist.PipelineConfig().replace(**change),
                             device="cpu")
    pano, m = ss.calibrate(views, draws=all_pair_draws(0, 3, 2048))
    assert m["reachable"] == [True] * 3 and pano.std() > 20
    same = ss.compose(views)
    assert same.shape == pano.shape
    assert np.abs(same.astype(np.float64) - pano).mean() < 1.0


def test_stream_needs_calibrate_and_a_card():
    ss = tist.StreamStitcher(device="cpu")
    with pytest.raises(RuntimeError, match="calibrate"):
        ss.compose([np.zeros((32, 32, 3), np.uint8)] * 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tist.StreamStitcher()


def test_stream_crops_to_the_bbox_whatever_crop_says(runs):
    """The stream ignores `cfg.crop`, as the JAX stream does
    (`imagestitch_tpu/stream.py:142`, `:157`; ROADMAP Watch list): with
    crop="interior" the port's calibrate and compose give crop="bbox"'s
    panos bit for bit, and so does JAX's compose on the same registration.
    An interior crop of that pano would be smaller, so the two modes
    differ on these views."""
    r = runs["shuffled"]
    views = _views("shuffled")
    ts = tist.StreamStitcher(r["ts"].cfg.replace(crop="interior"),
                             device="cpu")
    pt, _ = ts.calibrate(views, draws=all_pair_draws(
        0, len(views), ST_CFG.ransac.num_hypotheses))
    assert np.array_equal(pt, r["t"][0])
    assert np.array_equal(ts.compose(views), r["t"][2])
    js = JStream(ST_CFG.replace(crop="interior"))
    for name in ("_cams", "_scale", "_seam_masks", "_canvas_hw"):
        setattr(js, name, getattr(r["js"], name))
    assert np.array_equal(js.compose(views), r["j"][2])
    pano = r["t"][0]
    _, (_, _, h, w) = autocrop(pano, pano.any(axis=-1))
    assert 0 < h * w < pano.shape[0] * pano.shape[1]
