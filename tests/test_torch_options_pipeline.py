"""imagestitch_tpu_torch's pipelines with the options of ROADMAP item 13
against `imagestitch_tpu` on the CPU (the kernels' plain versions), with
the JAX RANSAC draws injected.

- `stitch_pair_impl` on synthetic_rotation_pair(192, 256) with the ramp
  blend and the colour-gradient DP seam, with the Voronoi seam, and with
  `work_megapix=0.02` (the views are 0.049 MP, so the work scale is 0.64
  and K1's views shrink to 123x164), against JAX's jitted
  `stitch_pair_front_impl` + `_seam_and_blend`.
- OpenCV stitching_detailed's defaults (work_megapix, horizontal wave
  correction, spherical warp, GAIN_BLOCKS, the DP colour seam, multi-band
  blend) through `Stitcher` and `StreamStitcher` on a 3-view 160x224
  `synthetic_pan_sequence`, with `work_megapix` scaled to 0.02: at the
  1080p path's proportion (0.6 of 2.07 MP) the work views would be
  86x121, too small for ORB's 31-px border on five levels, and the
  registration would fail in both packages. The Stitcher also with
  `compose_megapix=0.02` and `crop="interior"`.
- One `stitch_pairs_batched` call with GAIN_BLOCKS and `work_megapix`
  equal to `stitch_pair_impl` pair by pair with the same draws, bit for
  bit (the same operations in the same order).

Held against JAX (with the port's re-anchor of the adjusted cameras on
the nearest rotation to view 0's sheared start, a declared difference:
`test_torch_bundle_options.jax_reanchored`; the port's cameras are
rotations, checked beside): h_valid and reachable equal, focal within 1e-3
relative, the valid masks' IoU >= 0.999 and the panos within 0.5 mean
absolute difference where both are valid (the two libraries' float32
trig, exp and reductions differ in the last bits, and a wave-corrected
rotation carries the eigen-decomposition's).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import imagestitch_tpu as jist  # noqa: E402
from imagestitch_tpu import pipeline as jpipe  # noqa: E402
from imagestitch_tpu import stream as jstream  # noqa: E402
from imagestitch_tpu.geometry import bundle as jbundle  # noqa: E402
from imagestitch_tpu.stream import StreamStitcher as JStream  # noqa: E402
import imagestitch_tpu_torch as tist  # noqa: E402
from imagestitch_tpu_torch.convert import config_from_dict  # noqa: E402
from imagestitch_tpu_torch.parallel.batch import (  # noqa: E402
    stitch_pairs_batched_impl)
from imagestitch_tpu_torch.pipeline import stitch_pair_impl  # noqa: E402
from imagestitch_tpu_torch.utils.io import (  # noqa: E402
    synthetic_pan_sequence, synthetic_rotation_pair)

from test_torch_bundle_options import jax_reanchored  # noqa: E402
from test_torch_stitcher import all_pair_draws  # noqa: E402

torch.set_num_threads(2)

PAIR_CASES = {
    "ramp_colorgrad": dict(seam=jist.SeamConfig(kind="dp_colorgrad"),
                           blend=jist.BlendConfig(kind="ramp")),
    "voronoi": dict(seam=jist.SeamConfig(kind="voronoi")),
    "work_megapix": dict(work_megapix=0.02),
}
DETAILED = jist.PipelineConfig(
    work_megapix=0.02,
    camera=jist.CameraConfig(wave_correct=True, wave_kind="horiz"),
    warp=jist.WarpConfig(kind="spherical"),
    exposure=jist.ExposureConfig(kind="gain_blocks"),
    seam=jist.SeamConfig(kind="dp_color"),
    blend=jist.BlendConfig(kind="multiband"))
COMPOSED = DETAILED.replace(compose_megapix=0.02, crop="interior")


def _tcfg(cfg):
    return config_from_dict(dataclasses.asdict(cfg))


def _draws(key):
    return (np.asarray(jax.random.uniform(key, (2048, 4))),
            np.asarray(jax.random.uniform(jax.random.fold_in(key, 1),
                                          (256, 4))))


def _held(pj, vj, pt, vt):
    """Valid IoU and the mean absolute difference where both are valid."""
    assert pt.shape == pj.shape, (pt.shape, pj.shape)
    vj, vt = np.asarray(vj, bool), np.asarray(vt, bool)
    iou = (vj & vt).sum() / max((vj | vt).sum(), 1)
    both = vj & vt
    diff = np.abs(np.asarray(pt, np.float64) - np.asarray(pj, np.float64))
    return iou, float(diff[both].mean())


@pytest.fixture(scope="module")
def pair_runs():
    key = jax.random.key(0)
    draws = _draws(key)
    a, b = synthetic_rotation_pair(192, 256)[:2]
    front = jax.jit(jpipe.stitch_pair_front_impl, static_argnames=("cfg",))
    back = jax.jit(jpipe._seam_and_blend,
                   static_argnames=("cfg", "src_w", "src_h"))
    out = {}
    for case, change in PAIR_CASES.items():
        cfg = jist.PipelineConfig().replace(**change)
        fcfg = cfg.replace(seam=jist.SeamConfig(), blend=jist.BlendConfig())
        warped, masks, cj, mj = front(jnp.asarray(a), jnp.asarray(b), key,
                                      cfg=fcfg)
        pj, vj = back(warped, masks, cfg=cfg, src_w=256, src_h=192)
        pt, vt, ct, mt = stitch_pair_impl(torch.as_tensor(a),
                                          torch.as_tensor(b), _tcfg(cfg),
                                          draws=draws)
        out[case] = dict(j=(np.asarray(pj), np.asarray(vj), np.asarray(cj),
                            {k: np.asarray(v) for k, v in mj.items()}),
                         t=(pt.numpy(), vt.numpy(), ct.numpy(),
                            {k: v.numpy() for k, v in mt.items()}))
    return out


@pytest.mark.parametrize("case", list(PAIR_CASES))
def test_stitch_pair_options_match_jax(pair_runs, case):
    pj, vj, cj, mj = pair_runs[case]["j"]
    pt, vt, ct, mt = pair_runs[case]["t"]
    assert bool(mt["h_valid"]) and bool(mj["h_valid"])
    for k in ("kpts1", "kpts2", "num_matches", "num_inliers"):
        assert int(mt[k]) == int(mj[k]), k
    assert abs(float(mt["focal"]) - float(mj["focal"])) \
        <= 1e-3 * float(mj["focal"])
    assert np.array_equal(ct, cj)
    iou, mad = _held(pj, vj, pt, vt)
    assert iou >= 0.999 and mad <= 0.5, (iou, mad)


def test_work_megapix_registers_at_work_scale(pair_runs):
    """The work scale shrinks the detector's views: fewer keypoints than
    at full resolution, and the focal, scaled back up, within 5% of the
    pair's true 0.9 x 256 px."""
    mt = pair_runs["work_megapix"]["t"][3]
    mv = pair_runs["voronoi"]["t"][3]
    assert int(mt["kpts1"]) < int(mv["kpts1"])
    assert abs(float(mt["focal"]) - 230.4) < 0.05 * 230.4


@pytest.fixture(scope="module")
def detailed_runs(tmp_path_factory):
    """The JAX Stitcher and stream with the port's re-anchor of the
    adjusted cameras (a declared difference: `jax_reanchored`), and the
    port's."""
    views = synthetic_pan_sequence(3)
    draws = all_pair_draws(0, 3, 2048)
    base = tmp_path_factory.mktemp("detailed")
    out = {"views": views}
    with pytest.MonkeyPatch.context() as mp:
        cured = jax_reanchored(jbundle.bundle_adjust)
        mp.setattr(jpipe, "bundle_adjust", cured)
        mp.setattr(jstream, "bundle_adjust", cured)
        for name, cfg in (("detailed", DETAILED), ("composed", COMPOSED)):
            pj, mj = jist.Stitcher(cfg).stitch(
                views, dump_stages=str(base / name / "j"))
            pt, mt = tist.Stitcher(_tcfg(cfg), device="cpu").stitch(
                views, draws=draws, dump_stages=str(base / name / "t"))
            dj = np.load(base / name / "j" / "pano.npz")
            dt = np.load(base / name / "t" / "pano.npz")
            out[name] = dict(j=(pj, mj, dj["pano"], dj["valid"]),
                             t=(pt, mt, dt["pano"], dt["valid"]),
                             cams=np.load(base / name / "t" / "cameras.npz"))
        sj = JStream(DETAILED)
        pj, mj = sj.calibrate(views)
        st = tist.StreamStitcher(_tcfg(DETAILED), device="cpu")
        pt, mt = st.calibrate(views, draws=draws)
        out["stream"] = dict(j=(pj, mj, sj.compose(views)),
                             t=(pt, mt, st.compose(views)),
                             cams=st.frozen("cams").R.numpy())
    return out


@pytest.mark.parametrize("name", ["detailed", "composed"])
def test_stitcher_detailed_matches_jax(detailed_runs, name):
    _, mj, pj, vj = detailed_runs[name]["j"]
    pt_u8, mt, pt, vt = detailed_runs[name]["t"]
    # the JAX Stitcher's keys, and the port's LM steps inside its
    # bundle_adjust, its DP seam stage, its readback stage, its counters
    # and its start rotations' defect (tests/test_torch_spans.py)
    assert sorted(mt) == sorted({*mj, "lm_step", "seam_dp", "readback_crop",
                                 "lm_iters", "readback_bytes",
                                 "pairs_matched", "pairs_kept",
                                 "start_defect"})
    assert mt["reachable"] == mj["reachable"] == [True] * 3
    assert abs(mt["focal"] - mj["focal"]) <= 1e-3 * mj["focal"]
    iou, mad = _held(pj, vj, pt, vt)
    assert iou >= 0.999 and mad <= 0.5, (iou, mad)
    assert pt_u8.dtype == np.uint8 and pt_u8.std() > 20


@pytest.mark.parametrize("name", ["detailed", "composed", "stream"])
def test_the_detailed_cameras_are_rotations(detailed_runs, name):
    """Beside the declared difference: the 3-view pan's start rotations
    are sheared (view 0 is not the spanning tree's root), and the port's
    adjusted, wave-corrected cameras are rotations within 1e-5 (float32
    products of a few rotations)."""
    run = detailed_runs[name]
    R = np.asarray(run["cams"]["R"] if name != "stream" else run["cams"],
                   np.float64)
    defect = np.linalg.norm(np.swapaxes(R, -1, -2) @ R - np.eye(3),
                            axis=(-2, -1)).max()
    assert defect < 1e-5
    if name != "stream":
        assert run["t"][1]["start_defect"] > 1e-3


def test_compose_megapix_and_interior_crop(detailed_runs):
    """compose_megapix shrinks the pano by the compose scale (0.747 here);
    the interior crop leaves no invalid pixel."""
    full = detailed_runs["detailed"]["t"][2]
    pt, mt, pano, valid = detailed_runs["composed"]["t"]
    assert valid.all()
    assert pano.shape[1] < 0.8 * full.shape[1]
    assert abs(mt["focal"] - 0.747 * detailed_runs["detailed"]["t"][1][
        "focal"]) < 0.01 * mt["focal"]


def test_stream_detailed_matches_jax(detailed_runs):
    pj, mj, cj = detailed_runs["stream"]["j"]
    pt, mt, ct = detailed_runs["stream"]["t"]
    assert abs(mt["focal"] - mj["focal"]) <= 1e-3 * mj["focal"]
    for a, b in ((pt, pj), (ct, cj)):
        assert a.shape == b.shape
        diff = np.abs(a.astype(np.float64) - b.astype(np.float64))
        assert diff.mean() <= 0.5, diff.mean()


def test_batched_gain_blocks_work_megapix_equal_single():
    """One batch of two distinct pairs against stitch_pair_impl pair by
    pair with the same draws: equal bit for bit."""
    cfg = tist.PipelineConfig(
        work_megapix=0.03,
        exposure=tist.ExposureConfig(kind="gain_blocks"),
        seam=tist.SeamConfig(orient="vertical"))
    pairs = [synthetic_rotation_pair(160, 224, seed=s)[:2] for s in (3, 4)]
    g = torch.Generator().manual_seed(5)
    draws = [(torch.rand((2048, 4), generator=g),
              torch.rand((256, 4), generator=g)) for _ in pairs]
    x = torch.as_tensor(np.stack([np.stack(p) for p in pairs])).float()
    panos, valids, corners, metrics = stitch_pairs_batched_impl(
        x, cfg, draws=draws)
    for b, (a, c) in enumerate(pairs):
        p, v, cn, m = stitch_pair_impl(torch.as_tensor(a),
                                       torch.as_tensor(c), cfg,
                                       draws=draws[b])
        assert bool(m["h_valid"])
        assert torch.equal(panos[b], p) and torch.equal(valids[b], v)
        assert torch.equal(corners[b], cn)
        assert torch.equal(metrics["focal"][b], m["focal"])
