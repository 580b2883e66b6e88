"""The port's serving loop (`imagestitch_tpu_torch.tools.serve_demo`) on the
CPU (the kernels' plain versions), at `tests/test_torch_batch.py`'s size
and configuration: 144x192 pairs, TINY.

- Against JAX: the three pairs served in one dispatch by the batcher,
  each pair's RANSAC draws its key of `jax.random.split(jax.random.key(0),
  3)`, against `imagestitch_tpu.parallel.stitch_pairs_batched` plus the
  JAX demo's bbox crop (`tools/serve_demo.py:118-125`):
  `test_torch_batch`'s tolerances, equal crop shapes, corners and
  h_valid, each crop within 0.5 on average and its 0.999 quantile within
  30 (JAX's vmapped linear algebra rounds differently from a single
  pair's program).
- Against the port: every served crop equals, bit for bit,
  `stitch_pairs_batched(seed=k)` on its dispatch's pairs with the demo's
  crop, with several producers on the loop.
- Batching: a partial batch (n < B), dispatched when the stop sentinel
  comes and when the linger deadline passes, equals the same pairs in a
  full batch (no padding: the draws of the first n pairs are the same).
- The all-zero warm-up batch gives JAX's h_valid (all false) and crops
  of JAX's shapes; without a card the default device raises.
"""

import queue
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from imagestitch_tpu.parallel import stitch_pairs_batched as jbatched  # noqa
from imagestitch_tpu_torch.parallel.batch import (  # noqa: E402
    stitch_pairs_batched)
from imagestitch_tpu_torch.tools import serve_demo  # noqa: E402

from test_torch_batch import TINY, _pairs, _tcfg  # noqa: E402
from test_torch_chain import pair_draws  # noqa: E402

torch.set_num_threads(2)

B = 3


def _index_of(pair, pairs):
    return next(b for b in range(len(pairs))
                if np.array_equal(pair, pairs[b]))


def _run_batcher(reqs, batch, linger_ms=20.0, record=None):
    """The batcher in this thread over `reqs` put in order, then stop."""
    reqq, stop = queue.Queue(), object()
    for r in reqs:
        reqq.put(r)
    reqq.put(stop)
    serve_demo.batcher(reqq, stop, _tcfg(TINY), batch, linger_ms, "cpu",
                       record)


def _crops(out):
    panos, valids = out[0].numpy(), out[1].numpy()
    return [serve_demo.crop(panos[b], valids[b]) for b in range(len(panos))]


@pytest.fixture(scope="module")
def runs():
    pairs = _pairs(B).astype(np.float32)
    keys = jax.random.split(jax.random.key(0), B)
    draws = [pair_draws(keys[b], TINY.ransac.num_hypotheses)
             for b in range(B)]
    pj, vj, cj, mj = jbatched(jnp.asarray(pairs), keys, TINY)
    zj = jbatched(jnp.zeros_like(jnp.asarray(pairs)), keys, TINY)
    seen = []

    def with_jax_draws(x, cfg, seed, device):
        """The served dispatch with each pair's JAX draws, found by its
        pixels."""
        out = stitch_pairs_batched(x, cfg, seed=seed, device=device, draws={
            b: draws[_index_of(x[b], pairs)] for b in range(len(x))})
        seen.append((x, out))
        return out

    reqs = [serve_demo.Req(p) for p in pairs]
    record = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(serve_demo, "stitch_pairs_batched", with_jax_draws)
        _run_batcher(reqs, B, record=record)
    return dict(pairs=pairs, reqs=reqs, record=record, seen=seen,
                j=(np.asarray(pj), np.asarray(vj), np.asarray(cj),
                   np.asarray(mj["h_valid"])),
                zeros=(np.asarray(zj[0]), np.asarray(zj[1]),
                       np.asarray(zj[3]["h_valid"])))


def test_served_crops_match_jax(runs):
    pj, vj, cj, hj = runs["j"]
    assert [(e["seed"], e["n"]) for e in runs["record"]] == [(0, B)]
    (x, out), = runs["seen"]
    assert np.array_equal(x, runs["pairs"])
    assert np.array_equal(out[2].numpy(), cj)
    for b, r in enumerate(runs["reqs"]):
        assert r.ok == bool(hj[b]) and r.ok
        want = serve_demo.crop(pj[b], vj[b])
        assert r.pano.shape == want.shape
        d = np.abs(r.pano - want)
        assert d.mean() < 0.5
        assert np.quantile(d, 0.999) < 30.0


def test_served_crops_are_float_canvas_bbox(runs):
    """The crop is the float32 canvas itself, not clipped to uint8."""
    (x, out), = runs["seen"]
    for b, r in enumerate(runs["reqs"]):
        assert r.pano.dtype == np.float32
        assert np.array_equal(r.pano, _crops(out)[b])


@pytest.fixture(scope="module")
def partial():
    """Two of three pairs dispatched as a partial batch (B = 3), once when
    the stop sentinel comes and once when the linger deadline passes, and
    the three in one full batch, all seed 0."""
    pairs = _pairs(B).astype(np.float32)
    full = _crops(stitch_pairs_batched(pairs, _tcfg(TINY), seed=0,
                                       device="cpu"))
    by_stop = [serve_demo.Req(p) for p in pairs[:2]]
    rec_stop = []
    _run_batcher(by_stop, B, linger_ms=60e3, record=rec_stop)

    by_linger = [serve_demo.Req(p) for p in pairs[:2]]
    rec_linger = []
    reqq, stop = queue.Queue(), object()
    bt = threading.Thread(target=serve_demo.batcher, args=(
        reqq, stop, _tcfg(TINY), B, 50.0, "cpu", rec_linger))
    bt.start()
    for r in by_linger:
        reqq.put(r)
    served = all(r.event.wait(timeout=120) for r in by_linger)
    reqq.put(stop)
    bt.join(timeout=120)
    return dict(full=full, by_stop=by_stop, rec_stop=rec_stop,
                by_linger=by_linger, rec_linger=rec_linger, served=served,
                joined=not bt.is_alive())


def test_stop_sentinel_dispatches_what_it_holds(partial):
    assert [(e["seed"], e["n"]) for e in partial["rec_stop"]] == [(0, 2)]
    assert all(r.event.is_set() and r.ok for r in partial["by_stop"])


def test_linger_deadline_dispatches_a_partial_batch(partial):
    assert partial["served"] and partial["joined"]
    assert [(e["seed"], e["n"]) for e in partial["rec_linger"]] == [(0, 2)]


@pytest.mark.parametrize("how", ["by_stop", "by_linger"])
def test_partial_batch_equals_full_batch(partial, how):
    for b, r in enumerate(partial[how]):
        assert np.array_equal(r.pano, partial["full"][b])


def test_several_producers_equal_the_batched_call():
    """Three producers of two requests each through `serve`: every request
    served ok, each dispatch's crops equal stitch_pairs_batched(seed=k)
    on its pairs bit for bit, seeds 0, 1, ... in dispatch order."""
    pairs = _pairs(6, seed=20).astype(np.float32)
    record = []
    lat, wall = serve_demo.serve([pairs[0:2], pairs[2:4], pairs[4:6]],
                                 _tcfg(TINY), B, 200.0, "cpu", record)
    assert len(lat) == 6 and wall > 0
    assert [e["seed"] for e in record] == list(range(len(record)))
    assert sum(e["n"] for e in record) == 6
    assert all(e["n"] <= B for e in record)
    served = set()
    for e in record:
        x = np.stack([r.pair for r in e["reqs"]])
        want = _crops(stitch_pairs_batched(x, _tcfg(TINY), seed=e["seed"],
                                           device="cpu"))
        for r, w in zip(e["reqs"], want):
            assert r.ok and np.array_equal(r.pano, w)
            served.add(_index_of(r.pair, pairs))
    assert served == set(range(6))


def test_zero_warm_up_batch_matches_jax_h_valid(runs):
    out = serve_demo.dispatch(np.zeros_like(runs["pairs"]), _tcfg(TINY), 0,
                              "cpu")
    pj, vj, hj = runs["zeros"]
    assert np.array_equal(out[2].numpy(), hj) and not hj.any()
    for b, c in enumerate(_crops(out)):
        w = serve_demo.crop(pj[b], vj[b])
        assert (c is None) == (w is None)
        assert c is None or c.shape == w.shape


def test_failed_dispatch_raises_and_frees_every_producer(monkeypatch):
    def boom(*a, **kw):
        raise RuntimeError("dispatch failed")

    monkeypatch.setattr(serve_demo, "stitch_pairs_batched", boom)
    pairs = _pairs(2).astype(np.float32)
    with pytest.raises(RuntimeError, match="dispatch failed"):
        serve_demo.serve([pairs[:1], pairs[1:]], _tcfg(TINY), B, 20.0,
                         "cpu")


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_demo.main(["--requests", "1", "--producers", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_demo.warm(_tcfg(TINY), 1, 144, 192, None)


def test_demo_runs_on_the_cpu(capsys):
    """The demo's own configuration, size and lines, asked for the CPU."""
    assert serve_demo.main(["--requests", "4", "--batch", "2", "--producers",
                            "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "compile+warm:" in out and "device=cpu batch=2" in out
    assert "served 4 requests in" in out and "latency p50" in out
    assert "SOME INVALID" not in out
