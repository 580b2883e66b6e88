"""imagestitch_tpu_torch matching and geometry against the JAX package,
each stage fed the JAX stage's own inputs through `convert.py`:
Hamming 2-NN matching, RANSAC with the JAX draws injected, the 4-point
solve, DLT, LM, focal recovery, chained cameras and the ray bundle
adjustment, on the synthetic 192x256 rotation pair.

Tolerances are stated per assertion. Homographies are compared after the
h33 = 1 scaling (the DLT eigenvector's sign is arbitrary); float32 sums
and LAPACK calls run in other orders in the two libraries.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from imagestitch_tpu.config import PipelineConfig as JCfg  # noqa: E402
from imagestitch_tpu.features.orb import detect_and_compute as j_detect  # noqa
from imagestitch_tpu.geometry import autocalib as j_autocalib  # noqa: E402
from imagestitch_tpu.geometry import bundle as j_bundle  # noqa: E402
from imagestitch_tpu.geometry import homography as j_hom  # noqa: E402
from imagestitch_tpu.geometry.ransac import find_homography as j_ransac  # noqa
from imagestitch_tpu.geometry.rotation import estimate_cameras as j_cams  # noqa
from imagestitch_tpu.matching.matcher import match_pair as j_match  # noqa
from imagestitch_tpu.ops.image import rgb_to_gray as j_gray  # noqa: E402
from imagestitch_tpu_torch.convert import (  # noqa: E402
    cameras_from_numpy, config_from_dict, features_from_numpy,
    matches_from_numpy)
from imagestitch_tpu_torch.geometry import autocalib, bundle  # noqa: E402
from imagestitch_tpu_torch.geometry import homography as hom  # noqa: E402
from imagestitch_tpu_torch.geometry.ransac import find_homography  # noqa
from imagestitch_tpu_torch.geometry.rotation import estimate_cameras  # noqa
from imagestitch_tpu_torch.matching.matcher import (  # noqa: E402
    match_pair, match_pair_descriptors)
from imagestitch_tpu_torch.utils.io import synthetic_rotation_pair  # noqa

torch.set_num_threads(2)

JC = JCfg()
TC = config_from_dict(dataclasses.asdict(JC))
FEAT_FIELDS = ("xy", "response", "angle", "size", "level", "valid",
               "descriptors", "img_size")
MATCH_FIELDS = ("src_idx", "dst_idx", "pairs", "distance", "valid",
                "inliers", "num_inliers", "H", "h_valid", "confidence")


def _np(obj, fields):
    return {k: np.asarray(getattr(obj, k)) for k in fields}


def _draws(key, n1=2048, n2=256):
    return (np.asarray(jax.random.uniform(key, (n1, 4))),
            np.asarray(jax.random.uniform(jax.random.fold_in(key, 1),
                                          (n2, 4))))


def _h33(H):
    H = np.asarray(H, np.float64)
    return H / H[2, 2]


@pytest.fixture(scope="module")
def ref():
    """JAX stages 1-5 on the rotation pair, as numpy."""
    i1, i2, _, _ = synthetic_rotation_pair(192, 256)
    det = jax.jit(lambda g: j_detect(j_gray(g), JC.detector))
    f1 = det(jnp.asarray(i1, jnp.float32))
    f2 = det(jnp.asarray(i2, jnp.float32))
    key = jax.random.key(0)
    mi = jax.jit(lambda a, b, k: j_match(a, b, k, 0, 1, JC.matcher,
                                         JC.ransac))(f1, f2, key)
    sizes = jnp.asarray([[192, 256], [192, 256]], jnp.int32)
    cams = jax.jit(j_cams)(mi.H[None], mi.h_valid[None], sizes)
    src = f1.xy[mi.pairs[:, 0]][None]
    dst = f2.xy[mi.pairs[:, 1]][None]
    ptv = (mi.inliers & mi.valid)[None]
    pv = (mi.confidence > 1.0)[None]
    ba = jax.jit(lambda c, s, d, p, v: j_bundle.bundle_adjust_ray(
        c, s, d, p, jnp.asarray([0]), jnp.asarray([1]), v, 25))(
            cams, src, dst, ptv, pv)
    cam_f = ("focal", "aspect", "ppx", "ppy", "R", "t")
    return dict(f1=_np(f1, FEAT_FIELDS), f2=_np(f2, FEAT_FIELDS),
                mi=_np(mi, MATCH_FIELDS), draws=_draws(key),
                sizes=np.asarray(sizes), cams=_np(cams, cam_f),
                ba=_np(ba, cam_f), src=np.asarray(src), dst=np.asarray(dst),
                ptv=np.asarray(ptv), pv=np.asarray(pv))


def test_match_pair_descriptors_matches_jax(ref):
    """Exact: integer Hamming distances, first-minimum argmins and the
    index-ordered tie breaks give the same match list."""
    from imagestitch_tpu.matching.matcher import (
        match_pair_descriptors as j_mpd)
    from imagestitch_tpu.types import ImageFeatures as JF
    jf1 = JF(**{k: jnp.asarray(v) for k, v in ref["f1"].items()})
    jf2 = JF(**{k: jnp.asarray(v) for k, v in ref["f2"].items()})
    pj, dj, vj = (np.asarray(a) for a in j_mpd(jf1, jf2, JC.matcher))
    pt, dt, vt = match_pair_descriptors(features_from_numpy(ref["f1"]),
                                        features_from_numpy(ref["f2"]),
                                        TC.matcher)
    assert np.array_equal(vt.numpy(), vj)
    assert np.array_equal(pt.numpy()[vj], pj[vj])
    assert np.array_equal(dt.numpy()[vj], dj[vj])
    assert vj.sum() > 50


def test_match_pair_with_injected_draws_matches_jax(ref):
    """Same draws -> same inlier set and count; H within 1e-4 relative
    (normalized), confidence within 1e-6."""
    mt = match_pair(features_from_numpy(ref["f1"]),
                    features_from_numpy(ref["f2"]), 0, 1, TC.matcher,
                    TC.ransac, draws=ref["draws"])
    mj = ref["mi"]
    assert bool(mt.h_valid) and bool(mj["h_valid"])
    assert int(mt.num_inliers) == int(mj["num_inliers"])
    assert np.array_equal(mt.inliers.numpy(), mj["inliers"])
    assert int(mt.num_matches()) == int(mj["valid"].sum())
    np.testing.assert_allclose(_h33(mt.H), _h33(mj["H"]), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(mt.confidence),
                               float(mj["confidence"]), rtol=1e-6)


def test_find_homography_with_outliers_matches_jax():
    """Synthetic correspondences under a known H with 30% outliers."""
    rng = np.random.default_rng(5)
    Ht = np.array([[1.05, 0.02, 30.0], [-0.03, 0.98, -12.0],
                   [1e-4, -5e-5, 1.0]])
    src = rng.uniform(-120, 120, (200, 2))
    p = np.c_[src, np.ones(200)] @ Ht.T
    dst = p[:, :2] / p[:, 2:]
    out = rng.uniform(size=200) < 0.3
    dst[out] += rng.uniform(-40, 40, (out.sum(), 2))
    mask = np.ones(200, bool)
    mask[190:] = False
    src, dst = src.astype(np.float32), dst.astype(np.float32)
    key = jax.random.key(3)
    u = np.asarray(jax.random.uniform(key, (512, 4)))
    rc = dataclasses.replace(JC.ransac, num_hypotheses=512)
    rj = j_ransac(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask),
                  key, rc)
    rt = find_homography(torch.as_tensor(src), torch.as_tensor(dst),
                         torch.as_tensor(mask),
                         dataclasses.replace(TC.ransac, num_hypotheses=512),
                         u=u)
    assert bool(rt.ok) and bool(rj.ok)
    assert np.array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    np.testing.assert_allclose(_h33(rt.H), _h33(rj.H), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_h33(rt.H), Ht, rtol=2e-2, atol=2e-2)


def test_solve_h4p_and_dlt_match_jax():
    rng = np.random.default_rng(7)
    s4 = rng.uniform(-100, 100, (64, 4, 2)).astype(np.float32)
    d4 = (s4 * 1.1 + rng.uniform(-5, 5, (64, 4, 2))).astype(np.float32)
    hj, okj = jax.vmap(j_hom.solve_h4p)(jnp.asarray(s4), jnp.asarray(d4))
    ht, okt = hom.solve_h4p(torch.as_tensor(s4), torch.as_tensor(d4))
    assert np.array_equal(okt.numpy(), np.asarray(okj))
    # float32 closed form through three levels of 3x3 products
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=2e-3,
                               atol=2e-4)
    src = rng.uniform(-100, 100, (50, 2)).astype(np.float32)
    dst = (src @ np.array([[1.02, 0.01], [-0.02, 0.97]], np.float32).T
           + 3.0 + rng.normal(0, 0.5, (50, 2))).astype(np.float32)
    mask = np.arange(50) < 45
    Hj, okj = j_hom.dlt_homography(jnp.asarray(src), jnp.asarray(dst),
                                   jnp.asarray(mask))
    Ht, okt = hom.dlt_homography(torch.as_tensor(src), torch.as_tensor(dst),
                                 torch.as_tensor(mask))
    assert bool(okt) and bool(okj)
    np.testing.assert_allclose(_h33(Ht), _h33(Hj), rtol=1e-4, atol=1e-4)
    Lj = j_hom.lm_refine_homography(Hj, jnp.asarray(src), jnp.asarray(dst),
                                    jnp.asarray(mask), 10)
    Lt = hom.lm_refine_homography(Ht, torch.as_tensor(src),
                                  torch.as_tensor(dst),
                                  torch.as_tensor(mask), 10)
    np.testing.assert_allclose(_h33(Lt), _h33(Lj), rtol=1e-4, atol=1e-4)


def test_focals_and_cameras_match_jax(ref):
    """Fed the JAX homography: focal within 1e-5 relative, rotations
    within 1e-5 (float32 3x3 inverses and products)."""
    Hs = ref["mi"]["H"][None]
    pv = ref["mi"]["h_valid"][None]
    fj = j_autocalib.focals_from_homography(jnp.asarray(Hs[0]))
    ft = autocalib.focals_from_homography(torch.as_tensor(Hs[0]))
    np.testing.assert_allclose([float(x) for x in ft],
                               [float(x) for x in fj], rtol=1e-5)
    ct = estimate_cameras(torch.as_tensor(Hs), torch.as_tensor(pv),
                          torch.as_tensor(ref["sizes"]))
    cj = ref["cams"]
    np.testing.assert_allclose(ct.focal.numpy(), cj["focal"], rtol=1e-5)
    np.testing.assert_allclose(ct.R.numpy(), cj["R"], atol=1e-5)
    np.testing.assert_allclose(ct.ppx.numpy(), cj["ppx"])
    np.testing.assert_allclose(ct.ppy.numpy(), cj["ppy"])


def test_masked_median_midpoint():
    x = torch.tensor([4.0, 1.0, 3.0, 2.0, 100.0])
    m = torch.tensor([True, True, True, True, False])
    assert float(autocalib._masked_median(x, m)) == 2.5
    xj = jnp.asarray(x.numpy())
    assert float(j_autocalib._masked_median(xj, jnp.asarray(m.numpy()))) \
        == 2.5


def test_bundle_adjust_ray_matches_jax(ref):
    """Fed the JAX cameras and inlier points: focal within 1e-3 relative
    and rotations within 1e-4 (same damping schedule and stopping rule;
    float32 Jacobians differ in their last bits)."""
    ct = bundle.bundle_adjust_ray(
        cameras_from_numpy(ref["cams"]), torch.as_tensor(ref["src"]),
        torch.as_tensor(ref["dst"]), torch.as_tensor(ref["ptv"]),
        torch.tensor([0]), torch.tensor([1]), torch.as_tensor(ref["pv"]),
        25)
    bj = ref["ba"]
    np.testing.assert_allclose(ct.focal.numpy(), bj["focal"], rtol=1e-3)
    np.testing.assert_allclose(ct.R.numpy(), bj["R"], atol=1e-4)
    assert abs(float(ct.focal[0]) - 230.4) < 0.05 * 230.4


def test_rodrigues_round_trip_matches_jax():
    rng = np.random.default_rng(2)
    r = rng.normal(0, 0.3, (5, 3)).astype(np.float32)
    Rj = np.asarray(jax.vmap(j_bundle.rodrigues_to_R)(jnp.asarray(r)))
    Rt = bundle.rodrigues_to_R(torch.as_tensor(r)).numpy()
    np.testing.assert_allclose(Rt, Rj, atol=1e-6)
    back = bundle.R_to_rodrigues(torch.as_tensor(Rt)).numpy()
    np.testing.assert_allclose(back, r, atol=1e-5)
    assert np.allclose(bundle.rodrigues_to_R(torch.zeros(3)).numpy(),
                       np.eye(3))
