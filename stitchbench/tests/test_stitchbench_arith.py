"""The end-to-end arithmetic: percentiles over every request, the rate
over the whole window with the last request's overrun, attempted and
failed."""

from __future__ import annotations

import statistics
import time

import numpy as np
import pytest

from stitchbench import harness, scenes


def test_percentiles_over_all_requests():
    lat = [0.1 * (i + 1) for i in range(100)]        # 0.1 .. 10.0 s
    assert harness.percentile(lat, 50) == pytest.approx(5.05)
    p90 = harness.percentile(lat, 90)
    assert p90 == pytest.approx(statistics.quantiles(
        lat, n=10, method="inclusive")[8])
    assert sum(1 for v in lat if v > p90) == 10
    assert harness.end_to_end("latency_p90_ms", lat, 100, 1.0, 0.0) == \
        pytest.approx(p90 * 1e3)
    assert harness.end_to_end("latency_p50_ms", [0.2], 1, 1.0, 0.0) == \
        pytest.approx(200.0)


def test_rate_and_setup():
    assert harness.end_to_end("panos_per_s", [], 12, 4.0, 0.0) == 3.0
    assert harness.end_to_end("setup_s", [], 0, 1.0, 21.5) == 21.5
    with pytest.raises(KeyError):
        harness.end_to_end("tokens_per_s", [], 0, 1.0, 0.0)


class _Slow(harness.ClosedLoop):
    """0.05 s a request; item 1 raises, item 2 returns an invalid answer."""

    def call(self, item, seed):
        time.sleep(0.05)
        if item == 1:
            raise RuntimeError("boom")
        return np.zeros((2, 2, 3), np.uint8), 1.0, {}, item != 2


def test_window_counts_the_overrun_and_failures():
    loop = _Slow(None, None, {}, {}, [None] * 4, None,
                 harness.request_seeds(7))
    reqs, t0, t1, lat = loop.window(0.12)
    # requests start until 0.12 s have passed; the one in flight finishes
    assert len(reqs) == 3 and t1 - t0 >= 0.15
    assert [r.item for r in reqs] == [0, 1, 2]
    assert reqs[1].error == "RuntimeError: boom" and reqs[1].pano is None
    assert not reqs[2].ok and reqs[0].ok
    assert len(lat) == 3 and all(v >= 0.05 for v in lat)
    reqs, _, _, _ = loop.window(None, count=5, start_item=3)
    assert [r.item for r in reqs] == [3, 0, 1, 2, 3]


def test_same_seed_same_sizes_other_order():
    a = scenes.spread((15.0, 30.0), 16, np.random.default_rng(1))
    b = scenes.spread((15.0, 30.0), 16, np.random.default_rng(2))
    assert sorted(a) == sorted(b) and a != b
    assert min(a) == 15.0 and max(a) == 30.0
