"""The `sift_plane_1080p` configuration and the serve cell: K3's bound at
the 1080p octave shapes against a hand count, its reader on a summary
with and without K3's launches, the plane surface's extent, and both new
cells run small on the CPU (`small.py`), correct."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import imagestitch_tpu_torch as ist
from stitchbench import find, harness, reference, roofline, scenes
from stitchbench.tests.small import run_small, small_cell

SIFT = "sift_plane_1080p.pair_closed1"
SERVE = "default_1080p.serve_b8_closed8"


@pytest.fixture(scope="module")
def k3():
    return find.part("metrics", "k3_sift_roofline")


@pytest.fixture(scope="module")
def sift_cfg():
    conf = harness.resolve_cell(harness.load_benchmark(), SIFT)["config"]
    return harness.pipeline_config(ist, conf["pipeline"])


def test_k3_bound_at_1080p_is_the_hand_count(k3, sift_cfg):
    # octaves of one 1080p view: 1080x1920, 540x960, 270x480, 135x240
    px = [1080 * 1920, 540 * 960, 270 * 480, 135 * 240]
    assert k3.octave_hw((1080, 1920), 4) == [(1080, 1920), (540, 960),
                                             (270, 480), (135, 240)]
    # per pixel: the base read (4 B), 17 float32 planes written (68 B)
    nbytes = 2 * 72 * sum(px)
    assert nbytes == 396_576_000
    # blurs of 7 (first octave), 9, 11, 13, 15, 15 taps: 2 (2k - 1) each;
    # 5 DoG differences; 4 gradient planes of 2 operations
    first = 2 * (13 + 17 + 21 + 25 + 29 + 29) + 5 + 16
    assert (first, k3.ops_per_px(3, 1.6, False)) == (289, 263)
    ops = 2 * (first * px[0] + 263 * sum(px[1:]))
    assert k3.k3_bytes_ops((1080, 1920), sift_cfg.detector) == (
        nbytes // 2, ops // 2)
    bound = k3.k3_bound_s(2, (1080, 1920), sift_cfg)
    assert bound == pytest.approx(nbytes / roofline.HBM_BYTES_PER_S)
    assert bound == pytest.approx(1.1838e-4, rel=1e-4)
    assert ops / roofline.FP32_FLOPS_PER_S < bound


def test_k3_reader_reads_its_kernel_only(k3, sift_cfg):
    ctx = harness.Context(
        traffic={"poses": "pair"}, cfg=sift_cfg, view_hw=(1080, 1920),
        requests=[None] * 3,
        trace={"kernel_s": {
            "void (anonymous namespace)::sift_octave_kernel<64, 64, 512, "
            "33>(float const*, Outs, int, int, Plan)": 0.002,
            "void (anonymous namespace)::sift_octave_kernel<32, 32, 256, "
            "33>(float const*, Outs, int, int, Plan)": 0.0005,
            "warp_kernel": 0.001}})
    want = 100.0 * k3.k3_bound_s(6, (1080, 1920), sift_cfg) / 0.0025
    assert k3.read(ctx) == pytest.approx(want)
    ctx.trace = {"kernel_s": {"warp_kernel": 0.001}}
    assert k3.read(ctx) is None


def test_plane_reference_extent_is_the_tangent_span():
    """A pure yaw pair on the plane in view 0's frame spans from view 0's
    far edge, (w - 1) / 2 from the centre, to f tan(yaw + the half field
    of view) on the other side."""
    h, w, f, yaw = 120, 200, 180.0, 20.0
    rots, half_span = find.part("poses", "pair").cameras((yaw, 0.0, 0.0), 2)
    views = scenes.render_views(rots, half_span, h, w, f,
                                np.random.default_rng(3), torch.device("cpu"))
    pano, valid = reference.render(views, rots, f, "plane")
    half = (w - 1) / 2
    span = half + f * math.tan(math.radians(yaw) + math.atan(half / f))
    assert abs(pano.shape[1] - span) <= 3
    assert valid[:, 0].any() and valid[:, -1].any()


def test_sift_cell_runs_small_and_reads_its_spans():
    out = run_small(small_cell(SIFT), trace=True)
    assert out["attempted"] == 1 and out["failed"] == 0
    assert out["correct"] is True, out["checks"]
    got = out["metrics"]
    assert got["sift_maps_ms"]["value"] > 0
    assert got["sift_describe_ms"]["value"] > 0
    # no K3 launch on the CPU: its roofline reads nothing
    assert "k3_sift_roofline" not in got


@pytest.mark.parametrize("workload", [SIFT, SERVE])
def test_new_cell_runs_small_and_is_correct(workload):
    out = run_small(small_cell(workload))
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["correct"] is True, out["checks"]
    assert {"latency_p50_ms", "panos_per_s", "setup_s"} <= set(
        out["metrics"])
    assert "latency_p90_ms" not in out["metrics"]


def test_a_sift_run_without_the_bundle_adjustment_is_not_correct():
    """The configuration's control: its own path without the ray bundle
    adjustment, over four pool items, all compared."""
    cell = small_cell(SIFT, pool=4, traced_requests=4)
    cell["config"]["pipeline"]["camera"] = {"ba_refine": False}
    out = run_small(cell, trace=True)
    assert out["failed"] == 0 and out["correct"] is False
    assert out["checks"]["focal_rel_err"]["value"] > \
        out["checks"]["focal_rel_err"]["limit"]
