"""The `sift_plane_1080p` deployment on the CPU at 540x960: the SIFT
detector with the plane warp through `stitch_pair`, judged against the
benchmark's plain reference on the plane surface; that surface against
the port's `PlaneProjector`; and the SIFT detector's spans
(`features/sift.py`) on the active timer, which count nothing.

Tolerances, each with its reason:
- the stitch: the configuration's own limits (`stitchbench/configs/
  sift_plane_1080p.json`), on pairs at both ends of the cell's yaw range,
  the wider with the pitch and roll that make its plane panorama tallest;
- the surface's round trip within 1e-9 px: float64 throughout;
- the port's float32 forward map within 1e-3 px of the reference's
  float64 surface: coordinates up to about 1000 px carry float32 steps
  of 6e-5 px, and the map rounds a handful of times;
- the detector with and without an active timer: bit for bit, since the
  spans only time.
"""

import math
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import imagestitch_tpu_torch as tist  # noqa: E402
from imagestitch_tpu_torch.features.sift import (  # noqa: E402
    detect_and_compute_sift)
from imagestitch_tpu_torch.ops.image import rgb_to_gray  # noqa: E402
from imagestitch_tpu_torch.utils import log  # noqa: E402
from imagestitch_tpu_torch.warp.projectors import PlaneProjector  # noqa
from stitchbench import find, harness, reference, scenes  # noqa: E402

torch.set_num_threads(2)

HW = (540, 960)
CPU = torch.device("cpu")
SIFT_SPANS = ("sift_maps", "sift_refine", "sift_orient", "sift_describe")
# (yaw, pitch, roll) in degrees: the ends of the cell's yaw range
PAIRS = {"yaw15": (15.0, -0.5, 1.0), "yaw30": (30.0, 1.5, 2.0)}


@pytest.fixture(scope="module")
def config():
    conf = harness.load_json(harness.BENCH_DIR / "configs"
                             / "sift_plane_1080p.json")
    return harness.resized(conf, HW)


def _pair(angles, seed=2**31 + 21):
    rots, half_span = find.part("poses", "pair").cameras(angles, 2)
    views = scenes.render_views(rots, half_span, *HW,
                                0.9 * HW[1], np.random.default_rng(seed), CPU)
    return views, rots


@pytest.fixture(scope="module")
def stitched(config):
    """Each pair of PAIRS stitched with the cell's PipelineConfig."""
    cfg = harness.pipeline_config(tist, config["pipeline"])
    out = {}
    for name, angles in PAIRS.items():
        views, rots = _pair(angles)
        pano, m = tist.stitch_pair(views[0].numpy(), views[1].numpy(), cfg,
                                   seed=5, device="cpu")
        out[name] = (views, rots, pano, m)
    return out


def test_the_cell_config_is_sift_on_the_plane(config):
    cfg = harness.pipeline_config(tist, config["pipeline"])
    assert cfg.detector.kind == "sift" and cfg.warp.kind == "plane"
    assert cfg.warp.canvas_scale_h == 1.8
    # OpenCV's ratio 0.7 on L2 distances is 0.49 on the port's squared ones
    assert 1.0 - cfg.matcher.match_conf == pytest.approx(0.7 ** 2)
    assert cfg.replace(detector=tist.DetectorConfig(),
                       matcher=tist.MatcherConfig(),
                       warp=tist.WarpConfig()) == tist.PipelineConfig()
    assert config["reference"] == {"surface": "plane",
                                   "wave_correct": False}


@pytest.mark.parametrize("pair", list(PAIRS))
def test_stitch_pair_is_within_the_limits(config, stitched, pair):
    views, rots, pano, m = stitched[pair]
    assert m["h_valid"]
    f = float(config["focal_px"])
    ref, valid = reference.render(views, rots, f, "plane")
    got = reference.judge(pano, m["focal"], {"f": f}, ref, valid, True)
    for key, limit in config["limits"].items():
        assert got[key] <= limit, (key, got)


@pytest.mark.parametrize("pair", list(PAIRS))
def test_the_sift_spans_and_counter_come_back(stitched, pair):
    _, _, _, m = stitched[pair]
    assert all(m[s] > 0 for s in SIFT_SPANS)
    assert sum(m[s] for s in SIFT_SPANS) <= m["detect"]
    assert m["kpts1"] > 0 and m["kpts2"] > 0


def test_orb_keeps_no_sift_span():
    views, _ = _pair(PAIRS["yaw15"])
    cfg = tist.PipelineConfig(warp=tist.WarpConfig(kind="plane",
                                                   canvas_scale_h=1.8))
    _, m = tist.stitch_pair(views[0].numpy(), views[1].numpy(), cfg,
                            seed=5, device="cpu")
    assert "detect" in m
    assert not set(SIFT_SPANS) & set(m)


def test_the_detector_is_the_same_with_and_without_a_timer():
    views, _ = _pair(PAIRS["yaw15"])
    gray = rgb_to_gray(views[0].to(torch.float32))[::2, ::2].contiguous()
    cfg = tist.DetectorConfig(kind="sift", max_keypoints=512)
    plain = detect_and_compute_sift(gray, cfg)
    timer = log.StageTimer(sync=False)
    with timer.active():
        timed = detect_and_compute_sift(gray, cfg)
    for name in ("xy", "response", "angle", "size", "level", "valid",
                 "descriptors", "img_size"):
        assert torch.equal(getattr(plain, name), getattr(timed, name)), name
    assert set(timer.summary()) == set(SIFT_SPANS)
    assert timer.counts() == {}


def test_the_plane_surface_round_trip():
    plane = find.part("surfaces", "plane")
    u, v = torch.meshgrid(torch.linspace(-2500.0, 2500.0, 41,
                                         dtype=torch.float64),
                          torch.linspace(-900.0, 900.0, 31,
                                         dtype=torch.float64),
                          indexing="ij")
    r = plane.to_ray(u, v, 1728.0)
    assert torch.equal(r[..., 2], torch.ones_like(u))
    u2, v2 = plane.from_ray(3.0 * r, 1728.0)
    assert torch.allclose(u2, u, rtol=0, atol=1e-9)
    assert torch.allclose(v2, v, rtol=0, atol=1e-9)


@pytest.mark.parametrize("angles", [(0.0, 0.0, 0.0), (15.0, -0.5, 1.0),
                                    (30.0, 1.5, 2.0), (-22.0, 1.0, -2.0)])
def test_the_plane_surface_is_the_port_projectors(angles):
    """A view turned by `angles` from the panorama's frame: the reference
    maps a pixel's ray onto the surface as the port's forward map does."""
    h, w = HW
    f = 0.9 * w
    yaw, pitch, roll = (math.radians(a) for a in angles)
    rot = scenes.rot_ypr(yaw, pitch, roll)     # pano ray -> camera ray
    k = scenes.intrinsics(f, h, w)
    ys, xs = np.meshgrid(np.linspace(0, h - 1, 7), np.linspace(0, w - 1, 9),
                         indexing="ij")
    pts = np.stack([xs, ys, np.ones_like(xs)], -1).reshape(-1, 3)
    rays = torch.as_tensor(pts @ np.linalg.inv(k).T @ rot)
    u_ref, v_ref = find.part("surfaces", "plane").from_ray(rays, f)
    proj = PlaneProjector(torch.as_tensor(k, dtype=torch.float32),
                          torch.as_tensor(rot.T, dtype=torch.float32), f)
    u, v = proj.forward(torch.as_tensor(pts[:, 0], dtype=torch.float32),
                        torch.as_tensor(pts[:, 1], dtype=torch.float32))
    assert (u.double() - u_ref).abs().max() < 1e-3
    assert (v.double() - v_ref).abs().max() < 1e-3
