"""The per-layer metrics that read the program's spans and counters
inside its entries (`metrics/match_ms.py` and the others of the
`stages` layer), in traced runs of both cells on the CPU at a small
size: each prints a value, and each value is above 0."""

from __future__ import annotations

import pytest

from stitchbench.tests.small import run_small, small_cell

SPANS = {
    "default_1080p.pair_closed1": {
        "match_ms", "bundle_adjust_ms", "lm_step_ms", "seam_blend_ms.pair",
        "readback_crop_ms", "readback_mb"},
    "detailed_1080p.chain4_closed1": {
        "match_ms", "bundle_adjust_ms", "lm_step_ms", "graph_cut_ms.chain4",
        "readback_crop_ms", "readback_mb"},
}


@pytest.mark.parametrize("workload", list(SPANS))
def test_traced_run_reads_the_stages_inside_the_entry(workload):
    out = run_small(small_cell(workload), trace=True)
    assert out["attempted"] == 1 and out["failed"] == 0
    got = out["metrics"]
    assert SPANS[workload] <= set(got)
    assert all(got[k]["value"] > 0 for k in SPANS[workload])
    assert got["readback_mb"]["unit"] == "MB"
    # the outer stages keep their readers beside the inner ones
    if workload.startswith("detailed"):
        assert {"front_ms.chain4", "host_seam_blend_ms.chain4"} <= set(got)
        assert got["graph_cut_ms.chain4"]["value"] < \
            got["host_seam_blend_ms.chain4"]["value"]
    assert got["lm_step_ms"]["value"] < got["bundle_adjust_ms"]["value"]
