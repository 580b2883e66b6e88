"""The `stitcher_pano_1080p` deployment (OpenCV's cv::Stitcher PANORAMA
preset) on the CPU at 432x768, and the re-anchor of the bundle adjusters
and the homography polish's guard that it needs.

- `Stitcher.stitch` on 4-view pans at both ends of the cell's step range
  (20 and 30 deg) and `StreamStitcher.calibrate` + `compose` on a rig of
  4 cameras 25 deg apart (calibrated on one frame set, composing
  another), each judged by the benchmark's plain reference
  (`stitchbench/reference.py`, spherical, levelled) at the
  configuration's own limits, resized with the views
  (`harness.resized`): the limits are the tolerance. At 432x768 the
  work views are 233x415, where the focal reads 0.006-0.011 against the
  limit 0.018; at 360x640 it reached 0.0175 and at 270x480 0.039, as
  ORB's 31-px border over five levels eats the smaller work views. The
  entries' counters
  `pairs_matched` (all 6 pairs), `pairs_kept`, and `start_defect`, which
  is far from 0 on a pan (view 0 is never the spanning tree's root).
- `geometry.bundle`: `nearest_rotation` on sheared, scaled and negated
  rotations (OpenCV's SVD rule), the adjusters from a sheared start
  returning rotations within 1e-5 (float32 products of three rotations)
  with camera 0 on its start's nearest rotation within 1e-6, and from an
  orthonormal start the cameras bit for bit what the plain re-anchor on
  R0 gives (the pair and chain fronts start at the identity).
- The homography's LM polish: a step whose system `solve_ex` reports
  singular, or whose solution is not finite, is no step (the JAX
  package's guard), and a regular system is solved bit for bit as the
  plain solve does.
- `register_views` measures `start_defect` only where the ray
  adjustment runs.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import imagestitch_tpu_torch as tist  # noqa: E402
from imagestitch_tpu_torch import pipeline  # noqa: E402
from imagestitch_tpu_torch.geometry import bundle, homography  # noqa
from imagestitch_tpu_torch.testing import bundle_problem  # noqa: E402
from imagestitch_tpu_torch.utils import log  # noqa: E402
from stitchbench import find, harness, reference, scenes  # noqa: E402

torch.set_num_threads(2)

HW = (432, 768)
CPU = torch.device("cpu")
SEED = 2**31 + 26
STEPS = {"step20": 20.0, "step30": 30.0}
CHAIN = [(0, 1), (1, 2), (2, 3), (0, 2), (1, 3)]
STAGES = ("detect", "match", "cameras", "bundle_adjust", "warp",
          "exposure", "seam_blend", "readback_crop")


@pytest.fixture(scope="module")
def config():
    conf = harness.load_json(harness.BENCH_DIR / "configs"
                             / "stitcher_pano_1080p.json")
    return harness.resized(conf, HW)


@pytest.fixture(scope="module")
def cfg(config):
    return harness.pipeline_config(tist, config["pipeline"])


def _pan(step, seed):
    rots, half_span = find.part("poses", "pan").cameras((step,), 4)
    views = scenes.render_views(rots, half_span, *HW, 0.9 * HW[1],
                                np.random.default_rng(seed), CPU)
    return views, rots


def _judge(config, views, rots, pano, focal):
    f = float(config["focal_px"])
    ref, valid = reference.render(views, rots, f, "spherical", True)
    return reference.judge(pano, focal, {"f": f}, ref, valid, True)


@pytest.fixture(scope="module")
def stitched(cfg):
    out = {}
    for name, step in STEPS.items():
        views, rots = _pan(step, SEED)
        pano, m = tist.Stitcher(cfg, device="cpu").stitch(
            list(views.numpy()), seed=5)
        out[name] = (views, rots, pano, m)
    return out


@pytest.fixture(scope="module")
def rig(cfg):
    """Calibrated on one frame set of the rig, composing another."""
    v0, rots = _pan(25.0, SEED + 1)
    v1, _ = _pan(25.0, SEED + 2)
    stream = tist.StreamStitcher(cfg, device="cpu")
    _, mc = stream.calibrate(list(v0.numpy()), seed=5)
    pano = stream.compose(list(v1.numpy()))
    return v1, rots, pano, mc, dict(stream.stages_ms)


def test_the_cell_config_is_the_panorama_preset(config, cfg):
    assert config["reduced"] == [] and config["view_hw"] == [432, 768]
    d, m, c = cfg.detector, cfg.matcher, cfg.camera
    assert (d.kind, d.nfeatures, d.grid_rows, d.grid_cols) == ("orb", 1500,
                                                               1, 3)
    assert (d.scale_factor, d.nlevels) == (1.3, 5)
    assert d.max_keypoints >= d.nfeatures
    assert (m.match_conf, m.num_matches_thresh1, m.num_matches_thresh2,
            m.conf_thresh, m.range_width) == (0.3, 6, 6, 1.0, -1)
    # OpenCV keeps every ratio-tested match of both directions: the cap
    # holds both directions' candidates, so it never binds
    assert m.max_matches >= 2 * d.max_keypoints
    assert (c.ba_refine, c.ba_kind, c.wave_correct, c.wave_kind) == (
        True, "ray", True, "horiz")
    assert cfg.warp.kind == "spherical"
    assert (cfg.exposure.kind, cfg.exposure.block_size) == ("gain_blocks",
                                                            32)
    assert (cfg.seam.kind, cfg.blend.kind, cfg.blend.num_bands) == (
        "graphcut", "multiband", 5)
    assert cfg.compose_megapix == -1.0
    # 0.6 MP of a 1080p view, scaled with the area
    assert cfg.work_megapix == pytest.approx(0.6 * 0.16)
    assert config["reference"] == {"surface": "spherical",
                                   "wave_correct": True}


@pytest.mark.parametrize("pan", list(STEPS))
def test_the_stitcher_is_within_the_limits(config, stitched, pan):
    views, rots, pano, m = stitched[pan]
    assert all(m["reachable"])
    got = _judge(config, views, rots, pano, m["focal"])
    for key, limit in config["limits"].items():
        assert got[key] <= limit, (key, got)


@pytest.mark.parametrize("pan", list(STEPS))
def test_the_stitcher_counts_its_pairs_and_start(stitched, pan):
    m = stitched[pan][3]
    assert all(m[s] > 0 for s in STAGES)
    assert m["pairs_matched"] == 6
    # the pan's neighbours at least, the far pairs where they overlap
    assert 3 <= m["pairs_kept"] <= 6
    assert m["start_defect"] > 1e-3


def test_the_rig_composes_within_the_limits(config, rig):
    views, rots, pano, mc, _ = rig
    assert all(mc["reachable"])
    got = _judge(config, views, rots, pano, mc["focal"])
    for key, limit in config["limits"].items():
        assert got[key] <= limit, (key, got)


def test_the_rig_keeps_its_stages_and_counts_its_calibration(rig):
    _, _, _, mc, stages = rig
    assert set(stages) == {"upload", "warp", "exposure", "blend",
                           "readback_crop"}
    assert mc["pairs_matched"] == 6 and 3 <= mc["pairs_kept"] <= 6
    assert mc["start_defect"] > 1e-3


def _rotation(yaw, pitch, roll):
    return torch.as_tensor(scenes.rot_ypr(yaw, pitch, roll),
                           dtype=torch.float64)


@pytest.mark.parametrize("case", ["sheared", "scaled", "negated"])
def test_nearest_rotation(case):
    R = _rotation(0.4, -0.1, 0.05)
    M = {"sheared": R @ torch.tensor([[1.0, 0.2, 0.0], [0.0, 1.1, -0.1],
                                      [0.05, 0.0, 0.9]], dtype=torch.float64),
         "scaled": 1.3 * R,
         "negated": -R}[case]
    P = bundle.nearest_rotation(M.to(torch.float32)).to(torch.float64)
    assert torch.linalg.det(P) == pytest.approx(1.0, abs=1e-6)
    assert bundle.rotation_defect(P) < 1e-6
    if case != "sheared":
        # a scaled rotation's polar factor is the rotation; a negated one
        # (a homography's sign) is turned back, as OpenCV does
        assert torch.allclose(P, R, atol=1e-6)
    else:
        # the nearest rotation: no other candidate is closer to M
        for other in (R, _rotation(0.41, -0.1, 0.05)):
            assert torch.linalg.norm(M - P) <= torch.linalg.norm(M - other)


def test_rotation_defect_reads_float32_rotations_under_the_anchor_cut():
    cams = bundle_problem(4, CHAIN, T=64, seed=3)[0]
    assert bundle.rotation_defect(cams.R) < bundle.ANCHOR_DEFECT
    assert bundle.rotation_defect(1.01 * cams.R) > bundle.ANCHOR_DEFECT


def _sheared(problem):
    cams = problem[0]
    S = torch.tensor([[1.0, 0.08, 0.0], [0.0, 1.05, 0.03],
                      [-0.04, 0.0, 0.97]])
    return (cams.replace(R=cams.R.clone().index_put_(
        (torch.tensor(0),), cams.R[0] @ S)), *problem[1:])


@pytest.mark.parametrize("kind", ["ray", "reproj"])
def test_a_sheared_start_comes_back_as_rotations(monkeypatch, kind):
    problem = _sheared(bundle_problem(4, CHAIN, T=128, seed=5))
    R0 = problem[0].R[0]
    assert bundle.rotation_defect(R0) > 1e-2
    out = bundle.bundle_adjust(*problem, 10, kind)
    assert bundle.rotation_defect(out.R) < 1e-5
    assert torch.allclose(out.R[0], bundle.nearest_rotation(R0), atol=1e-6)
    # the re-anchor on the start as it is shears every camera
    monkeypatch.setattr(bundle, "_anchor", lambda r: r)
    sheared = bundle.bundle_adjust(*problem, 10, kind)
    assert bundle.rotation_defect(sheared.R) > 1e-2
    assert torch.equal(sheared.focal, out.focal)


@pytest.mark.parametrize("start", ["identity", "rotation"])
@pytest.mark.parametrize("kind", ["ray", "reproj"])
def test_an_orthonormal_start_is_adjusted_bit_for_bit(monkeypatch, kind,
                                                      start):
    problem = bundle_problem(4, CHAIN, T=128, seed=7)
    if start == "identity":
        cams = problem[0]
        problem = (cams.replace(R=cams.R.clone().index_put_(
            (torch.tensor(0),), torch.eye(3))), *problem[1:])
    out = bundle.bundle_adjust(*problem, 10, kind)
    monkeypatch.setattr(bundle, "_anchor", lambda r: r)
    before = bundle.bundle_adjust(*problem, 10, kind)
    for f in ("focal", "ppx", "ppy", "aspect", "R"):
        assert torch.equal(getattr(out, f), getattr(before, f)), f


def _polish_problem(seed=11, n=64):
    """A homography and n noisy correspondences of it, for the LM polish."""
    g = torch.Generator().manual_seed(seed)
    H = torch.tensor([[1.02, 0.01, 30.0], [-0.02, 0.99, -12.0],
                      [1e-5, -2e-5, 1.0]])
    src = torch.rand((n, 2), generator=g) * torch.tensor([960.0, 540.0])
    p = torch.cat([src, torch.ones(n, 1)], 1) @ H.T
    dst = p[:, :2] / p[:, 2:] + 0.5 * torch.randn((n, 2), generator=g)
    return H, src, dst, torch.ones(n, dtype=torch.bool)


def test_the_polish_solves_as_before():
    """`solve_ex` and the plain solve of a regular system agree bit for
    bit (the same LU), so the polish is what it was."""
    H, src, dst, mask = _polish_problem()
    got = homography.lm_refine_homography(H, src, dst, mask, 5)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.linalg, "solve_ex", lambda A, b: (
            torch.linalg.solve(A, b), torch.zeros((), dtype=torch.int32)))
        want = homography.lm_refine_homography(H, src, dst, mask, 5)
    assert torch.equal(got, want)
    assert not torch.equal(got, H / H[2, 2])


@pytest.mark.parametrize("fault", ["singular", "not_finite"])
def test_a_step_the_polish_cannot_solve_is_no_step(monkeypatch, fault):
    """All-pairs matching hands RANSAC pairs that do not overlap, whose
    polish can meet a singular system: on the card the plain solve raised
    there (one pan in 192 of the cell's calibration); the JAX package's
    solve returns inf or NaN, which its guard turns into no step. Every
    step unsolvable: the homography comes back as it went in."""
    H, src, dst, mask = _polish_problem()

    def solve_ex(A, b):
        if fault == "singular":      # LAPACK's info: a zero pivot
            return torch.ones_like(b), torch.ones((), dtype=torch.int32)
        return torch.full_like(b, float("inf")), torch.zeros(
            (), dtype=torch.int32)

    monkeypatch.setattr(torch.linalg, "solve_ex", solve_ex)
    out = homography.lm_refine_homography(H, src, dst, mask, 5)
    assert torch.equal(out, H / H[2, 2])


def test_start_defect_only_where_the_ray_adjustment_runs(cfg):
    views, _ = _pan(25.0, SEED + 3)
    no_ba = cfg.replace(camera=dataclasses.replace(cfg.camera,
                                                   ba_refine=False))
    timer = log.StageTimer()
    with timer.active():
        *_, start_defect = pipeline.register_views(
            views.to(torch.float32), no_ba,
            generator=torch.Generator().manual_seed(5))
    assert start_defect is None
    assert timer.counts()["pairs_matched"] == 6
    assert "bundle_adjust" not in timer.summary()
