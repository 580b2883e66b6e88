"""The `stitcher_pano_1080p` configuration's two cells run small on the CPU
(`small.py`): each correct against the plain reference, its readers
reading its stages (its kernels' rooflines, read from the card's trace,
reading nothing here), and its controls not correct: the pans without the
bundle adjustment, and with the adjusted cameras re-anchored on view 0's
sheared start (the re-anchor the program had before it took the nearest
rotation)."""

from __future__ import annotations

import pytest

from imagestitch_tpu_torch.geometry import bundle
from stitchbench import harness
from stitchbench.tests.small import run_small, small_cell

PAN = "stitcher_pano_1080p.pan4_closed1"
RIG = "stitcher_pano_1080p.rig4_compose"
READERS = {PAN: ("match_ms.pan4", "bundle_adjust_ms.pan4",
                 "seam_blend_ms.pan4", "graph_cut_ms.pan4"),
           RIG: ("exposure_ms.rig", "blend_ms.rig", "readback_crop_ms.rig")}
# the kernels' shares: read from the card's trace, nothing on the CPU
ROOFLINES = {PAN: ("k1_detect_roofline.pan4", "k2_warp_roofline.pan4"),
             RIG: ("k2_warp_roofline.rig",)}


def test_the_cells_and_their_readers_are_entered():
    bench = harness.load_benchmark()
    for cell, readers in READERS.items():
        got = harness.resolve_cell(bench, cell)
        assert got["workload"]["chips"] == 1
        assert got["config"]["name"] == "stitcher_pano_1080p"
        assert set(readers) | set(ROOFLINES[cell]) <= {
            m["name"] for m in got["per_layer"]}
        assert {m["name"] for m in got["end_to_end"]} == {
            "latency_p50_ms", "panos_per_s", "setup_s"}


@pytest.mark.parametrize("cell", [PAN, RIG])
def test_the_cell_runs_small_and_reads_its_stages(cell):
    out = run_small(small_cell(cell), trace=True)
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["correct"] is True, out["checks"]
    for name in READERS[cell]:
        assert out["metrics"][name]["value"] > 0, name
    for name in ROOFLINES[cell]:
        assert name not in out["metrics"], name


@pytest.mark.parametrize("cell", [PAN, RIG])
def test_the_cell_runs_small_untraced(cell):
    out = run_small(small_cell(cell))
    assert out["failed"] == 0 and out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {"latency_p50_ms", "panos_per_s",
                                   "setup_s"}


def test_the_pans_without_the_bundle_adjustment_are_not_correct():
    cell = small_cell(PAN, traced_requests=2)
    cell["config"]["pipeline"]["camera"]["ba_refine"] = False
    out = run_small(cell, trace=True)
    assert out["failed"] == 0 and out["correct"] is False


def test_the_sheared_re_anchor_is_not_correct(monkeypatch):
    monkeypatch.setattr(bundle, "_anchor", lambda r0: r0)
    out = run_small(small_cell(PAN, traced_requests=2), trace=True)
    assert out["failed"] == 0 and out["correct"] is False
    assert out["checks"]["extent_rel_err"]["value"] > \
        out["checks"]["extent_rel_err"]["limit"]
