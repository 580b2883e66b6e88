"""imagestitch_tpu_torch's N-image host driver (`Stitcher`, `stitch()`) and
what it is built from, against `imagestitch_tpu` on the CPU (the kernels'
plain versions), with the JAX RANSAC draws injected per pair.

- `max_spanning_tree` on the same weighted pair lists: equal edges (BFS
  order from the center), center and reachable, with a view no pair
  reaches and with tied weights.
- `estimate_cameras_host` on the same homographies: equal edges and
  reachable, focal within 1e-6 relative (the same float32 median of the
  same candidates; the 3x3 inverses differ in the last bit), R within
  1e-5, principal points equal.
- `match_all` on the same features (the JAX batched detector's, carried
  over with `convert.features_from_numpy`), all pairs and with
  `range_width=1`: the same pair list; per pair equal matches, inliers,
  counts and h_valid, confidence within 1e-6 relative and H within 1e-3
  relative and absolute (the float32 rounding of the DLT refit and its
  LM polish; 6e-4 relative at most when written).
- `stitch()` / `Stitcher` at 160x224 on a 4-view `synthetic_sequence`, a
  3-view sequence whose middle view is cropped to 144x200, and a 2x2
  `synthetic_grid`: the same metric keys, the same seam edges (the
  spanning tree's, recorded at `_seam_and_blend`), equal reachable and
  canvas overflow, the same confident pairs, pair confidences within
  0.05 (one inlier of about 40 moves a confidence by about 0.02: the JAX
  batched detector's Harris differs from the port's in the last bit on
  some pyramid levels, which can swap near-tied keypoints), focal within
  1e-3 relative and the cropped pano's height and width within 2%. The
  panos extend as the JAX package's own tests ask.
- The JAX package's topology cases: a panning camera's 4 views in a
  shuffled order (the seams follow the spanning tree, edges with u > v),
  a 4-view sequence whose last view is noise (left out of the canvas,
  reachable [T, T, T, F]) and three unrelated scenes (every pair flagged
  under the confidence threshold): the same metric keys, seam edges,
  reachable and confident pairs, confidences within 0.05, focal within
  1e-3 (2e-2 on the noise case's near-pure translation) and the pano's
  shape within 2%.
- `dump_stages` writes the JAX package's .npz names with the same arrays'
  shapes; the host seams and SCANS mode (once refused) run through
  `Stitcher`, `stitch()` and `stitch_chain`; the entry points raise
  without a card by default.
"""

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import imagestitch_tpu as jist  # noqa: E402
from imagestitch_tpu import config as jcfg  # noqa: E402
from imagestitch_tpu import pipeline as jpipe  # noqa: E402
from imagestitch_tpu.features import detect as jdetect  # noqa: E402
from imagestitch_tpu.ops.image import rgb_to_gray  # noqa: E402
from imagestitch_tpu.geometry import rotation as jrot  # noqa: E402
from imagestitch_tpu.matching import matcher as jmatch  # noqa: E402
from imagestitch_tpu.utils import io as jio  # noqa: E402
import imagestitch_tpu_torch as tist  # noqa: E402
from imagestitch_tpu_torch import pipeline as tpipe  # noqa: E402
from imagestitch_tpu_torch.convert import (config_from_dict,  # noqa: E402
                                           features_from_numpy)
from imagestitch_tpu_torch.geometry.rotation import (  # noqa: E402
    estimate_cameras_host, max_spanning_tree)
from imagestitch_tpu_torch.matching.matcher import (match_all,  # noqa: E402
                                                    pair_list)
from imagestitch_tpu_torch.types import stack  # noqa: E402

from test_torch_chain import CHAIN_CFG, pair_draws, pan_sequence  # noqa

torch.set_num_threads(2)

# the JAX package's Stitcher test configurations (tests/test_pipeline.py)
ST_CFG = CHAIN_CFG.replace(warp=jcfg.WarpConfig(
    kind="plane", canvas_scale_w=1.8, canvas_scale_h=1.4))
GRID_CFG = ST_CFG.replace(warp=jcfg.WarpConfig(
    kind="plane", canvas_scale_w=1.8, canvas_scale_h=1.8))


def _tcfg(cfg):
    return config_from_dict(dataclasses.asdict(cfg))


def all_pair_draws(seed, n, num_hypotheses, range_width=-1):
    """Per pair (i, j), the draws JAX's match_all gives it under
    key(seed): fold_in(fold_in(key, i), j)."""
    key = jax.random.key(seed)
    return {(i, j): pair_draws(jax.random.fold_in(jax.random.fold_in(
        key, i), j), num_hypotheses)
        for i, j in pair_list(n, range_width)}


def _case_views(case):
    if case == "sequence":
        views, shift = jio.synthetic_sequence(4, 160, 224, overlap=0.5,
                                              seed=26)
        return list(views), ST_CFG, (shift, 0)
    if case == "mixed_sizes":
        views, shift = jio.synthetic_sequence(3, 160, 224, overlap=0.7,
                                              seed=11)
        views = list(views)
        views[1] = np.ascontiguousarray(views[1][:144, :200])
        return views, CHAIN_CFG, (shift, 0)
    if case == "grid":
        views, sx, sy = jio.synthetic_grid(2, 2, 160, 224, overlap=0.55,
                                           seed=33)
        return list(views), GRID_CFG, (sx, sy)
    if case == "shuffled":
        views = pan_sequence(4)
        return [views[i] for i in (2, 0, 3, 1)], ST_CFG, (0, 0)
    if case == "noise":
        views, shift = jio.synthetic_sequence(4, 160, 224, overlap=0.5,
                                              seed=41)
        views = list(views)
        rng = np.random.default_rng(3)
        views[3] = rng.integers(0, 255, views[3].shape).astype(np.uint8)
        return views, ST_CFG, (shift, 0)
    return ([jio.synthetic_pair(160, 224, seed=30 + i)[0] for i in range(3)],
            ST_CFG, (0, 0))


CASES = ("sequence", "mixed_sizes", "grid")
# the JAX package's topology cases (tests/test_pipeline.py:655, :684, :424)
TOPOLOGIES = ("shuffled", "noise", "unrelated")


def _recording(module):
    """Wrap module._seam_and_blend to record the seam edges it is given."""
    seen = []
    inner = module._seam_and_blend

    def spy(*args, **kw):
        seen.append([tuple(int(x) for x in e) for e in kw["edges"]])
        return inner(*args, **kw)

    return spy, seen


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per case: JAX's stitch() and the port's with the same draws, the
    seam edges each used, and (sequence) both stage dumps."""
    out = {}
    base = tmp_path_factory.mktemp("dumps")
    with pytest.MonkeyPatch.context() as mp:
        jspy, jseen = _recording(jpipe)
        tspy, tseen = _recording(tpipe)
        mp.setattr(jpipe, "_seam_and_blend", jspy)
        mp.setattr(tpipe, "_seam_and_blend", tspy)
        for case in CASES + TOPOLOGIES:
            views, cfg, shifts = _case_views(case)
            dump = case == "sequence"
            pj, mj = jist.Stitcher(cfg).stitch(
                views, dump_stages=str(base / "jax") if dump else None)
            pt, mt = tist.Stitcher(_tcfg(cfg), device="cpu").stitch(
                views, draws=all_pair_draws(0, len(views),
                                            cfg.ransac.num_hypotheses),
                dump_stages=str(base / "torch") if dump else None)
            out[case] = dict(j=(pj, mj, jseen.pop()), t=(pt, mt, tseen.pop()),
                             shifts=shifts, cfg=cfg)
    out["dumps"] = base
    return out


@pytest.mark.parametrize("case", CASES)
def test_stitcher_matches_jax(runs, case):
    pj, mj, ej = runs[case]["j"]
    pt, mt, et = runs[case]["t"]
    thresh = runs[case]["cfg"].matcher.conf_thresh
    # the JAX Stitcher's keys, the port's counter of the bytes read back,
    # its DP seam stage, its readback stage and its counters of the pairs
    # matched and kept (no bundle adjustment here, so no start_defect;
    # tests/test_torch_spans.py)
    assert sorted(mt) == sorted({*mj, "seam_dp", "readback_crop",
                                 "readback_bytes", "pairs_matched",
                                 "pairs_kept"})
    assert et == ej
    assert mt["n_images"] == mj["n_images"]
    assert mt["reachable"] == mj["reachable"]
    assert all(mt["reachable"])
    assert mt["canvas_overflow"] == mj["canvas_overflow"]
    ct, cj = np.asarray(mt["pair_confidences"]), \
        np.asarray(mj["pair_confidences"])
    assert np.array_equal(ct > thresh, cj > thresh)
    np.testing.assert_allclose(ct, cj, atol=0.05)
    assert abs(mt["focal"] - mj["focal"]) <= 1e-3 * mj["focal"]
    assert pt.dtype == np.uint8 and pt.ndim == 3
    for ax in (0, 1):
        assert abs(pt.shape[ax] - pj.shape[ax]) <= 0.02 * pj.shape[ax], \
            (pt.shape, pj.shape)


@pytest.mark.parametrize("case", CASES)
def test_stitcher_pano_extends(runs, case):
    """The extents the JAX package's own Stitcher tests ask for."""
    pt, _, edges = runs[case]["t"]
    sx, sy = runs[case]["shifts"]
    n = len(_case_views(case)[0])
    assert len(edges) == n - 1
    assert pt.std() > 20
    if case == "sequence":
        assert pt.shape[1] > 224 + 2 * sx
    elif case == "mixed_sizes":
        assert pt.shape[1] > 224 + sx
    else:
        assert pt.shape[1] > 224 + sx * 0.6
        assert pt.shape[0] > 160 + sy * 0.6


@pytest.mark.parametrize("case", TOPOLOGIES)
def test_stitcher_topology_matches_jax(runs, case):
    """A panning camera's views in a shuffled order: the seams follow the
    spanning tree's edges (u > v among them) as JAX's do, focal within
    1e-3. A noise view: left out of the canvas (reachable [T, T, T, F]),
    the pano spanning the three views, focal within 2e-2 (a near-pure
    translation: see test_torch_stream). Three unrelated scenes: every
    pair flagged under the confidence threshold in both."""
    pj, mj, ej = runs[case]["j"]
    pt, mt, et = runs[case]["t"]
    thresh = ST_CFG.matcher.conf_thresh
    # the port's DP seam stage is entered once per edge of the tree
    seams = {"seam_dp"} if et else set()
    assert sorted(mt) == sorted({*mj, *seams, "readback_crop",
                                 "readback_bytes", "pairs_matched",
                                 "pairs_kept"})
    assert et == ej
    assert mt["reachable"] == mj["reachable"]
    ct, cj = np.asarray(mt["pair_confidences"]), \
        np.asarray(mj["pair_confidences"])
    assert np.array_equal(ct > thresh, cj > thresh)
    np.testing.assert_allclose(ct, cj, atol=0.05)
    f_tol = 2e-2 if case == "noise" else 1e-3
    assert abs(mt["focal"] - mj["focal"]) <= f_tol * mj["focal"]
    for ax in (0, 1):
        assert abs(pt.shape[ax] - pj.shape[ax]) <= 0.02 * pj.shape[ax]
    if case == "shuffled":
        assert all(mt["reachable"]) and any(u > v for u, v in et)
    elif case == "noise":
        shift = runs[case]["shifts"][0]
        assert mt["reachable"] == [True, True, True, False]
        assert 224 + shift <= pt.shape[1] <= 224 + 3 * shift
        assert pt.std() > 20
    else:
        assert (ct <= thresh).all()


def test_stage_dumps_match_jax(runs):
    base = runs["dumps"]
    names = sorted(os.listdir(base / "jax"))
    assert names == ["cameras.npz", "features.npz", "matches.npz",
                     "pano.npz", "warped.npz"]
    assert sorted(os.listdir(base / "torch")) == names
    for name in names:
        j = np.load(base / "jax" / name)
        t = np.load(base / "torch" / name)
        assert sorted(t.files) == sorted(j.files), name
        for k in j.files:
            assert t[k].shape == j[k].shape, (name, k)
            assert t[k].dtype.kind == j[k].dtype.kind, (name, k)


MST_CASES = {
    # 5 views in a chain plus a cross pair; view 5 matches nothing
    "disconnected": (6, [(0, 1), (1, 2), (2, 3), (3, 4), (0, 2), (4, 5)],
                     [40, 35, 50, 45, 12, 0]),
    # ties broken the same way (argsort of the negated weights)
    "ties": (4, [(0, 1), (0, 2), (0, 3), (1, 2), (2, 3), (1, 3)],
             [20, 20, 20, 20, 20, 20]),
    # two components: the larger one is reachable
    "two_components": (5, [(0, 1), (2, 3), (3, 4), (2, 4)],
                       [30, 10, 12, 11]),
}


@pytest.mark.parametrize("case", list(MST_CASES))
def test_max_spanning_tree_matches_jax(case):
    n, pairs, w = MST_CASES[case]
    pf = np.asarray([p[0] for p in pairs])
    pt = np.asarray([p[1] for p in pairs])
    w = np.asarray(w)
    ej, cj, rj = jrot.max_spanning_tree(n, pf, pt, w)
    et, ct, rt = max_spanning_tree(n, pf, pt, w)
    assert et == ej and ct == cj
    assert np.array_equal(rt, rj)


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def test_estimate_cameras_host_matches_jax():
    """6 views panning 9 degrees a view; all pairs within two steps, the
    pairs of view 5 invalid (it stays at R = I, unreachable)."""
    n, f = 6, 320.0
    K = np.diag([f, f, 1.0])
    Rs = [_rot_y(np.deg2rad(9.0 * i)) for i in range(n)]
    rng = np.random.default_rng(2)
    pairs = pair_list(n, 2)
    Hs = []
    for i, j in pairs:
        h = K @ Rs[j] @ Rs[i].T @ np.linalg.inv(K)
        Hs.append(h / h[2, 2] + 1e-4 * rng.standard_normal((3, 3)))
    Hs = np.asarray(Hs, np.float32)
    pf = np.asarray([p[0] for p in pairs])
    pt = np.asarray([p[1] for p in pairs])
    inl = rng.integers(20, 90, len(pairs))
    valid = np.asarray([5 not in p for p in pairs])
    sizes = np.asarray([[240, 320]] * 4 + [[230, 300], [240, 320]], np.int32)
    cj, ej, rj = jrot.estimate_cameras_host(Hs, pf, pt, inl, valid, sizes,
                                            return_tree=True)
    ct, et, rt = estimate_cameras_host(Hs, pf, pt, inl, valid, sizes,
                                       return_tree=True)
    assert et == ej
    assert np.array_equal(rt, rj) and rt.tolist() == [True] * 5 + [False]
    np.testing.assert_allclose(ct.focal.numpy(), np.asarray(cj.focal),
                               rtol=1e-6)
    np.testing.assert_allclose(ct.R.numpy(), np.asarray(cj.R), atol=1e-5)
    assert np.array_equal(ct.R[5].numpy(), np.eye(3, dtype=np.float32))
    for k in ("ppx", "ppy", "aspect", "t"):
        assert np.array_equal(getattr(ct, k).numpy(),
                              np.asarray(getattr(cj, k))), k
    plain = estimate_cameras_host(Hs, pf, pt, inl, valid, sizes)
    assert torch.equal(plain.R, ct.R)


@pytest.fixture(scope="module")
def matched():
    """JAX's batched features of 3 views and JAX's match_all over them,
    all pairs and range_width=1 (compiled in threads)."""
    views = jio.synthetic_sequence(3, 160, 224, overlap=0.5, seed=9)[0]
    grays = jax.vmap(rgb_to_gray)(
        jnp.asarray(np.stack(views), jnp.float32))
    feats = jax.jit(jax.vmap(
        lambda g: jdetect(g, ST_CFG.detector)))(grays)
    mcfgs = {w: dataclasses.replace(ST_CFG.matcher, range_width=w)
             for w in (-1, 1)}

    def run(w):
        fn = jax.jit(lambda f, k: jmatch.match_all(f, k, mcfgs[w],
                                                   ST_CFG.ransac))
        return {k: np.asarray(v) for k, v in
                dataclasses.asdict(fn(feats, jax.random.key(0))).items()}

    with ThreadPoolExecutor(2) as ex:
        out = dict(zip(mcfgs, ex.map(run, mcfgs)))
    fnp = {k: np.asarray(v) for k, v in dataclasses.asdict(feats).items()}
    tfeats = stack([features_from_numpy({k: v[i] for k, v in fnp.items()})
                    for i in range(3)])
    return tfeats, out, mcfgs


@pytest.mark.parametrize("range_width", [-1, 1])
def test_match_all_matches_jax(matched, range_width):
    tfeats, jout, mcfgs = matched
    j = jout[range_width]
    tcfg = _tcfg(ST_CFG)
    mcfg = dataclasses.replace(tcfg.matcher, range_width=range_width)
    t = match_all(tfeats, mcfg, tcfg.ransac,
                  draws=all_pair_draws(0, 3, 512, range_width))
    want = [(0, 1), (0, 2), (1, 2)] if range_width < 0 else [(0, 1), (1, 2)]
    assert pair_list(3, range_width) == want
    assert list(zip(t.src_idx.tolist(), t.dst_idx.tolist())) == want
    assert list(zip(j["src_idx"].tolist(), j["dst_idx"].tolist())) == want
    for k in ("pairs", "valid", "inliers", "num_inliers", "h_valid"):
        assert np.array_equal(getattr(t, k).numpy(), j[k]), k
    np.testing.assert_array_equal(t.distance.numpy(), j["distance"])
    np.testing.assert_allclose(t.confidence.numpy(), j["confidence"],
                               rtol=1e-6)
    np.testing.assert_allclose(t.H.numpy(), j["H"], rtol=1e-3, atol=1e-3)
    assert t.h_valid[0]


def test_stitcher_one_and_two_views():
    """One view comes back as it is; two go through stitch_pair."""
    views = jio.synthetic_sequence(2, 160, 224, overlap=0.5, seed=9)[0]
    cfg = _tcfg(ST_CFG)
    st = tist.Stitcher(cfg, device="cpu")
    p1, m1 = st.stitch(views[:1])
    assert m1 == {"n_images": 1} and np.array_equal(p1, views[0])
    draws = all_pair_draws(0, 2, 512)
    p2, m2 = st.stitch(views, draws=draws)
    pp, mp = tist.stitch_pair(views[0], views[1], cfg, device="cpu",
                              draws=draws[(0, 1)])
    assert np.array_equal(p2, pp)
    assert sorted(m2) == sorted(mp)


@pytest.mark.parametrize("change,item", [
    ({"mode": "scans"}, 16),
    ({"seam": tist.SeamConfig(kind="graphcut")}, 15),
    ({"seam": tist.SeamConfig(full_components=True)}, 15),
])
def test_unported_options_raise_with_roadmap_item(change, item):
    """The options this test once refused (ROADMAP items 15 and 16) run:
    `Stitcher` and `stitch()` give the same pano with every view
    reachable, `stitch_chain` reaches every view, and the host seams add
    their seams.npz dump. Held against JAX in test_torch_host_seams.py
    and test_torch_scans.py."""
    if item == 15:
        cfg = ST_CFG.replace(seam=jcfg.SeamConfig(**dataclasses.asdict(
            change["seam"])))
    else:
        cfg = ST_CFG.replace(**change)
    cfg = _tcfg(cfg)
    views = list(jio.synthetic_sequence(3, 160, 224, overlap=0.5,
                                        seed=9)[0])
    draws = all_pair_draws(0, 3, 512) if item == 15 else None
    p1, m1 = tist.Stitcher(cfg, device="cpu").stitch(views, draws=draws)
    p2, _ = tist.stitch(views, cfg, device="cpu", draws=draws)
    assert np.array_equal(p1, p2) and m1["reachable"] == [True] * 3
    assert p1.std() > 20
    p3, m3 = tist.stitch_chain(views, cfg, device="cpu")
    assert all(m3["reachable"]) and p3.std() > 20


@pytest.mark.parametrize("change", [{"compose_megapix": 0.02},
                                    {"work_megapix": 0.02}])
def test_item13_options_run(change):
    """The two options this file once refused (ROADMAP item 13) run on the
    CPU: every view reachable, and compose_megapix shrinks the pano by
    its scale, work_megapix leaves its size (registration only). Held
    against JAX in tests/test_torch_options_pipeline.py."""
    views = pan_sequence(3)
    cfg = tist.PipelineConfig()
    draws = all_pair_draws(0, 3, 2048)
    p0, _ = tist.Stitcher(cfg, device="cpu").stitch(views, draws=draws)
    p, m = tist.Stitcher(cfg.replace(**change), device="cpu").stitch(
        views, draws=draws)
    assert all(m["reachable"]) and p.std() > 20
    if "compose_megapix" in change:
        s = np.sqrt(0.02e6 / (160 * 224))
        assert abs(p.shape[1] - s * p0.shape[1]) < 0.05 * p0.shape[1]
    else:
        assert abs(p.shape[1] - p0.shape[1]) < 0.05 * p0.shape[1]
    if "work_megapix" in change:
        p2, _ = tist.stitch_chain(views, cfg.replace(**change),
                                  device="cpu")
        assert p2.std() > 20


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    views = jio.synthetic_sequence(3, 64, 96, overlap=0.5, seed=9)[0]
    for call in (lambda: tist.stitch(views),
                 lambda: tist.stitch_chain(views),
                 lambda: tist.Stitcher()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
