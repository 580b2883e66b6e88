"""imagestitch_tpu_torch's SCANS mode against `imagestitch_tpu`'s on the CPU
(the kernels' plain versions), with the JAX RANSAC draws injected: the
affine draws are `jax.random.uniform(key, (num_hypotheses, P))` under the
pair's key (P = 2 for the similarity, 3 for the full affine), one pass.

- The affine solvers on clean points (the minimal 2- and 3-point solves,
  the masked least squares of both models, the transfer error) within
  1e-5 of JAX's (float32 reductions in another order).
- `find_affine` on 50% outliers, partial and full, with JAX's draws:
  equal inlier masks, counts and ok; the transform within 1e-4 relative
  to its largest entry (float32 least-squares normal equations).
- `estimate_affine_host` and `bundle_adjust_affine`: the same NumPy on the
  same inputs, equal edges and reachable and the transforms bit for bit.
- `match_pair` with the affine motion keeps confidences above 3 (the JAX
  package's manufactured case), where the homography zeroes them.
- Pipelines at 160x224 and 192x256 with the JAX package's test
  configurations: `stitch_pairs_batched` on two similarity pairs against
  JAX's batch (each pair equal to the port's `stitch_pair_impl` bit for
  bit), `stitch_chain_impl` with `chain_splice` bridging a noise view,
  `Stitcher` with the affine bundle adjustment on a 4-view sequence, and
  `StreamStitcher` (calibrate, then compose). Held: h_valid, inlier
  counts, reachable and the canvas corner equal; the affine cameras
  within 1e-3 relative (1e-2 px-scale on translations: the least-squares
  refit's float32 sums); ROIs within 0.5 px; valid IoU >= 0.999 and the
  panos within 0.5 mean where both are valid; the cropped panos' shapes
  within 2%.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import imagestitch_tpu as jist  # noqa: E402
from imagestitch_tpu import config as jcfg  # noqa: E402
from imagestitch_tpu import pipeline as jpipe  # noqa: E402
from imagestitch_tpu.geometry import affine as jaff  # noqa: E402
from imagestitch_tpu.geometry import bundle as jbundle  # noqa: E402
from imagestitch_tpu.geometry import rotation as jrot  # noqa: E402
from imagestitch_tpu.matching import matcher as jmatch  # noqa: E402
from imagestitch_tpu.parallel.batch import (  # noqa: E402
    stitch_pairs_batched as jbatched)
from imagestitch_tpu.stream import StreamStitcher as JStream  # noqa: E402
from imagestitch_tpu.types import ImageFeatures as JFeatures  # noqa: E402
from imagestitch_tpu.utils import io as jio  # noqa: E402
import imagestitch_tpu_torch as tist  # noqa: E402
from imagestitch_tpu_torch.convert import config_from_dict  # noqa: E402
from imagestitch_tpu_torch.geometry import affine as taff  # noqa: E402
from imagestitch_tpu_torch.geometry.bundle import (  # noqa: E402
    bundle_adjust_affine)
from imagestitch_tpu_torch.geometry.rotation import (  # noqa: E402
    estimate_affine_host)
from imagestitch_tpu_torch.matching.matcher import match_pair  # noqa: E402
from imagestitch_tpu_torch.matching.matcher import pair_list  # noqa: E402
from imagestitch_tpu_torch.pipeline import (stitch_chain_impl,  # noqa: E402
                                            stitch_pair_impl)
from imagestitch_tpu_torch.types import ImageFeatures  # noqa: E402

from test_torch_chain import CHAIN_CFG  # noqa: E402
from test_torch_stitcher import ST_CFG  # noqa: E402

torch.set_num_threads(2)

PAIR_CFG = jcfg.PipelineConfig(
    mode="scans",
    detector=jcfg.DetectorConfig(nfeatures=256, max_keypoints=768),
    matcher=jcfg.MatcherConfig(max_matches=256),
    ransac=jcfg.RansacConfig(num_hypotheses=512),
    seam=jcfg.SeamConfig(orient="vertical"))


def _tcfg(cfg):
    return config_from_dict(dataclasses.asdict(cfg))


def affine_draws(key, num_hypotheses, p=2):
    """JAX find_affine's draw under `key` (one pass: no refit draw)."""
    return (np.asarray(jax.random.uniform(key, (num_hypotheses, p))), None)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1.0)


def _points(seed=0, n=256):
    rng = np.random.default_rng(seed)
    src = rng.uniform(0, 500, (n, 2)).astype(np.float32)
    th, s = 0.2, 1.15
    A = np.array([[s * np.cos(th), -s * np.sin(th), 40.0],
                  [s * np.sin(th), s * np.cos(th), -25.0]], np.float32)
    dst = (src @ A[:, :2].T + A[:, 2]).astype(np.float32)
    dst[n // 2:] += rng.uniform(-120, 120, (n - n // 2, 2)).astype(
        np.float32)
    mask = np.ones(n, bool)
    mask[-7:] = False
    return src, dst, mask


def test_affine_solvers_match_jax():
    rng = np.random.default_rng(1)
    src = rng.uniform(-100, 100, (16, 2)).astype(np.float32)
    A = np.array([[1.1, 0.2, 5.0], [-0.15, 0.9, 3.0]], np.float32)
    dst = (src @ A[:, :2].T + A[:, 2]).astype(np.float32)
    t2, ok2 = taff.solve_affine_partial_2p(torch.as_tensor(src[:2]),
                                           torch.as_tensor(dst[:2]))
    j2, jok2 = jaff.solve_affine_partial_2p(jnp.asarray(src[:2]),
                                            jnp.asarray(dst[:2]))
    assert bool(ok2) == bool(jok2) and _rel(t2, j2) < 1e-5
    t3, ok3 = taff.solve_affine_3p(torch.as_tensor(src[:3]),
                                   torch.as_tensor(dst[:3]))
    j3, jok3 = jaff.solve_affine_3p(jnp.asarray(src[:3]),
                                    jnp.asarray(dst[:3]))
    assert bool(ok3) == bool(jok3) and _rel(t3, j3) < 1e-5
    w = (rng.uniform(size=16) > 0.3).astype(np.float32)
    for partial in (True, False):
        tf, tok = taff.ls_affine(torch.as_tensor(src), torch.as_tensor(dst),
                                 torch.as_tensor(w), partial)
        jf, jok = jaff.ls_affine(jnp.asarray(src), jnp.asarray(dst),
                                 jnp.asarray(w), partial)
        assert bool(tok) == bool(jok) and _rel(tf, jf) < 1e-5
        te = taff.affine_error_sq(tf, torch.as_tensor(src),
                                  torch.as_tensor(dst))
        je = jaff.affine_error_sq(jf, jnp.asarray(src), jnp.asarray(dst))
        assert np.abs(te.numpy() - np.asarray(je)).max() < 1e-3


@pytest.mark.parametrize("partial", [True, False])
@pytest.mark.parametrize("seed", [0, 3])
def test_find_affine_with_jax_draws(partial, seed):
    src, dst, mask = _points(seed)
    key = jax.random.key(seed)
    cfg = jcfg.RansacConfig(num_hypotheses=512)
    j = jaff.find_affine(jnp.asarray(src), jnp.asarray(dst),
                         jnp.asarray(mask), key, cfg, partial=partial)
    u = affine_draws(key, 512, 2 if partial else 3)[0]
    t = taff.find_affine(torch.as_tensor(src), torch.as_tensor(dst),
                         torch.as_tensor(mask), _tcfg_r(cfg),
                         partial=partial, u=u)
    assert bool(t.ok) == bool(j.ok) and bool(t.ok)
    assert int(t.num_inliers) == int(j.num_inliers)
    assert np.array_equal(t.inliers.numpy(), np.asarray(j.inliers))
    assert _rel(t.H, j.H) < 1e-4


def _tcfg_r(rcfg):
    return tist.RansacConfig(**dataclasses.asdict(rcfg))


def test_estimate_affine_host_and_adjustment_equal_jax():
    rng = np.random.default_rng(4)

    def sim(th, s, tx, ty):
        c, sn = np.cos(th), np.sin(th)
        return np.array([[s * c, -s * sn, tx], [s * sn, s * c, ty],
                         [0, 0, 1.0]])

    G = [np.eye(3), sim(0.06, 1.02, 110.0, 8.0),
         sim(0.12, 1.05, 215.0, 20.0), sim(0.2, 1.0, 300.0, 30.0)]
    pairs = pair_list(4)
    Hs = np.stack([np.linalg.inv(G[j]) @ G[i] for i, j in pairs])
    pf = np.array([p[0] for p in pairs])
    pt = np.array([p[1] for p in pairs])
    nin = np.array([50, 10, 3, 40, 12, 44])
    pv = np.array([True, True, False, True, True, True])
    tc, te, tr = estimate_affine_host(Hs, pf, pt, nin, pv, 4,
                                      return_tree=True)
    jc, je, jr = jrot.estimate_affine_host(Hs, pf, pt, nin, pv, 4,
                                           return_tree=True)
    assert te == je and np.array_equal(tr, jr)
    assert np.array_equal(tc.R.numpy(), np.asarray(jc.R))
    assert np.array_equal(tc.focal.numpy(), np.asarray(jc.focal))
    T = 48
    src, dst = [], []
    for i, j in pairs:
        canvas = rng.uniform(0, 400, (T, 2))
        h = np.concatenate([canvas, np.ones((T, 1))], 1)
        src.append((h @ np.linalg.inv(G[i]).T)[:, :2]
                   + rng.normal(0, 0.3, (T, 2)))
        dst.append((h @ np.linalg.inv(G[j]).T)[:, :2]
                   + rng.normal(0, 0.3, (T, 2)))
    src, dst = np.stack(src), np.stack(dst)
    ptv = rng.uniform(size=(len(pairs), T)) > 0.2
    for partial in (True, False):
        a = bundle_adjust_affine(tc.R.numpy(), src, dst, ptv, pf, pt, pv,
                                 anchor=te[0][0], partial=partial)
        b = jbundle.bundle_adjust_affine(np.asarray(jc.R), src, dst, ptv,
                                         pf, pt, pv, anchor=je[0][0],
                                         partial=partial)
        assert np.array_equal(a, b)


def test_affine_confidence_not_zeroed():
    rng = np.random.default_rng(7)
    CAP, n = 512, 320
    xy = rng.uniform(0, 200, (CAP, 2)).astype(np.float32)
    desc = rng.integers(0, 2, (CAP, 256)).astype(np.uint8)
    valid = np.arange(CAP) < n
    f = ImageFeatures(
        xy=torch.as_tensor(xy), response=torch.zeros(CAP),
        angle=torch.zeros(CAP), size=torch.zeros(CAP),
        level=torch.zeros(CAP, dtype=torch.int32),
        valid=torch.as_tensor(valid), descriptors=torch.as_tensor(desc),
        img_size=torch.tensor([200, 200], dtype=torch.int32))
    jf = JFeatures(xy=jnp.asarray(xy), response=jnp.zeros(CAP),
                   angle=jnp.zeros(CAP), size=jnp.zeros(CAP),
                   level=jnp.zeros(CAP, jnp.int32),
                   valid=jnp.asarray(valid), descriptors=jnp.asarray(desc),
                   img_size=jnp.asarray([200, 200], jnp.int32))
    key = jax.random.key(0)
    mcfg = jcfg.MatcherConfig(motion="affine_partial")
    rj = jmatch.match_pair(jf, jf, key, cfg=mcfg)
    rt = match_pair(f, f, cfg=tist.MatcherConfig(motion="affine_partial"),
                    draws=affine_draws(key, 2048))
    assert int(rt.num_matches()) >= 241
    assert float(rt.confidence) > 3.0
    assert abs(float(rt.confidence) - float(rj.confidence)) < 1e-6
    assert int(rt.num_inliers) == int(rj.num_inliers)


def _held(pj, vj, pt, vt):
    vj, vt = np.asarray(vj, bool), np.asarray(vt, bool)
    iou = (vj & vt).sum() / max((vj | vt).sum(), 1)
    both = vj & vt
    diff = np.abs(np.asarray(pt, np.float64) - np.asarray(pj, np.float64))
    return iou, float(diff[both].mean())


@pytest.fixture(scope="module")
def batch():
    pairs = []
    for seed, ang in ((5, 6.0), (8, -4.0)):
        a, b, _ = jio.synthetic_affine_pair(192, 256, angle_deg=ang,
                                            scale=1.04, seed=seed)
        pairs.append(np.stack([a, b]))
    pairs = np.stack(pairs)
    keys = jax.random.split(jax.random.key(0), 2)
    pj, vj, cj, mj = jbatched(jnp.asarray(pairs, jnp.float32), keys,
                              PAIR_CFG)
    draws = {b: affine_draws(keys[b], 512) for b in range(2)}
    pt, vt, ct, mt = tist.stitch_pairs_batched(pairs, _tcfg(PAIR_CFG),
                                               device="cpu", draws=draws)
    return dict(pairs=pairs, draws=draws,
                j=(np.asarray(pj), np.asarray(vj), np.asarray(cj),
                   {k: np.asarray(v) for k, v in mj.items()}),
                t=(pt, vt, ct, mt))


def test_scans_batch_matches_jax(batch):
    pj, vj, cj, mj = batch["j"]
    pt, vt, ct, mt = batch["t"]
    assert mt["h_valid"].all() and np.array_equal(mt["h_valid"].numpy(),
                                                  mj["h_valid"])
    for k in ("num_matches", "num_inliers", "kpts1", "kpts2"):
        assert np.array_equal(mt[k].numpy(), mj[k]), k
    assert np.abs(mt["confidence"].numpy() - mj["confidence"]).max() < 1e-5
    assert np.array_equal(mt["focal"].numpy(), mj["focal"])
    assert np.array_equal(ct.numpy(), cj)
    assert np.abs(mt["roi_uv"].numpy() - mj["roi_uv"]).max() < 0.5
    for b in range(2):
        iou, diff = _held(pj[b], vj[b], pt[b].numpy(), vt[b].numpy())
        assert iou >= 0.999 and diff < 0.5


@pytest.mark.parametrize("b", [0, 1])
def test_scans_pair_equals_batch_element(batch, b):
    a, c = (torch.as_tensor(x) for x in batch["pairs"][b])
    pt, vt, ct, _ = stitch_pair_impl(a, c, _tcfg(PAIR_CFG),
                                     draws=batch["draws"][b])
    bp, bv, bc, _ = batch["t"]
    assert torch.equal(pt, bp[b]) and torch.equal(vt, bv[b])
    assert torch.equal(ct, bc[b])


def test_scans_stitch_pair_entry():
    a, c, A = jio.synthetic_affine_pair(192, 256, angle_deg=6.0,
                                        scale=1.04, seed=5)
    pano, m = tist.stitch_pair(a, c, _tcfg(PAIR_CFG), device="cpu")
    assert m["h_valid"] and m["num_inliers"] > 15 and m["focal"] == 1.0
    G1 = np.linalg.inv(np.vstack([A, [0.0, 0.0, 1.0]]))
    corners = np.array([[0, 0, 1], [256, 0, 1], [0, 192, 1],
                        [256, 192, 1]], np.float64) @ G1.T
    exp_w = max(256, corners[:, 0].max()) - min(0.0, corners[:, 0].min())
    assert abs(pano.shape[1] - exp_w) < 0.04 * exp_w + 6


def _chain_affine_draws(key, n, num_hypotheses):
    d = {(i, i + 1): affine_draws(jax.random.fold_in(key, i),
                                  num_hypotheses) for i in range(n - 1)}
    d.update({(j, j + 2): affine_draws(jax.random.fold_in(key, n - 1 + j),
                                       num_hypotheses)
              for j in range(n - 2)})
    return d


def test_scans_chain_splice_matches_jax():
    views, _ = jio.synthetic_sequence(4, 160, 224, overlap=0.7, seed=31)
    views = np.asarray(views).copy()
    views[2] = np.random.default_rng(0).integers(0, 255, views[2].shape)
    cfg = CHAIN_CFG.replace(mode="scans", chain_splice=True)
    key = jax.random.key(0)
    pj, vj, cj, mj = jpipe.stitch_chain_core(
        jnp.asarray(views, jnp.float32), key, cfg)
    pt, vt, ct, mt = stitch_chain_impl(
        torch.as_tensor(views), _tcfg(cfg),
        _chain_affine_draws(key, 4, 512))
    assert mt["reachable"].tolist() == [True, True, False, True]
    assert mt["reachable"].tolist() == np.asarray(mj["reachable"]).tolist()
    assert np.array_equal(mt["h_valid"].numpy(), np.asarray(mj["h_valid"]))
    assert np.array_equal(mt["num_inliers"].numpy(),
                          np.asarray(mj["num_inliers"]))
    assert np.array_equal(ct.numpy(), np.asarray(cj))
    assert np.abs(mt["roi_uv"].numpy() - np.asarray(mj["roi_uv"])).max() \
        < 0.5
    iou, diff = _held(np.asarray(pj), np.asarray(vj), pt.numpy(),
                      vt.numpy())
    assert iou >= 0.999 and diff < 0.5


def _all_affine_draws(seed, n, num_hypotheses):
    key = jax.random.key(seed)
    return {(i, j): affine_draws(jax.random.fold_in(
        jax.random.fold_in(key, i), j), num_hypotheses)
        for i, j in pair_list(n)}


SCANS_ST = ST_CFG.replace(mode="scans", camera=jcfg.CameraConfig())


@pytest.fixture(scope="module")
def views4():
    return list(jio.synthetic_sequence(4, 160, 224, overlap=0.5,
                                       seed=50)[0])


def test_scans_stitcher_matches_jax(views4, tmp_path):
    dj, dt = str(tmp_path / "j"), str(tmp_path / "t")
    pj, mj = jist.Stitcher(SCANS_ST).stitch(views4, 0, dump_stages=dj)
    pt, mt = tist.Stitcher(_tcfg(SCANS_ST), device="cpu").stitch(
        views4, draws=_all_affine_draws(0, 4, 512), dump_stages=dt)
    assert mt["reachable"] == list(mj["reachable"]) == [True] * 4
    Rj = np.load(os.path.join(dj, "cameras.npz"))["R"]
    Rt = np.load(os.path.join(dt, "cameras.npz"))["R"]
    assert np.abs(Rt[:, :2, :2] - Rj[:, :2, :2]).max() < 1e-3
    assert np.abs(Rt[:, :2, 2] - Rj[:, :2, 2]).max() < 1e-2
    for ax in (0, 1):
        assert abs(pt.shape[ax] - pj.shape[ax]) <= 0.02 * pj.shape[ax]


def test_scans_stream_matches_jax(views4):
    views = views4[:3]
    js = JStream(SCANS_ST)
    pj, _ = js.calibrate(views, 0)
    ts = tist.StreamStitcher(_tcfg(SCANS_ST), device="cpu")
    pt, mt = ts.calibrate(views, draws=_all_affine_draws(0, 3, 512))
    Rj = np.asarray(js._cams.R)
    Rt = ts.frozen("cams").R.numpy()
    assert np.abs(Rt[:, :2, :2] - Rj[:, :2, :2]).max() < 1e-3
    assert np.abs(Rt[:, :2, 2] - Rj[:, :2, 2]).max() < 1e-2
    assert pt.shape == pj.shape
    bright = [np.clip(v.astype(np.int32) + 12, 0, 255).astype(np.uint8)
              for v in views]
    ct = ts.compose(bright)
    assert ct.shape == pt.shape and ct.mean() > pt.mean()
