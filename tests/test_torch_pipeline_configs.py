"""imagestitch_tpu_torch `stitch_pair_impl` against `imagestitch_tpu`'s
`stitch_pair_core` on the CPU (the kernels' plain versions) in the
configurations off the default that the port accepts, and on a larger
translation pair, with the JAX RANSAC draws injected.

- Configurations, on synthetic_rotation_pair(192, 256): seam, blend and
  exposure kind "none", no bundle adjustment, an explicit seam orientation,
  the plane and spherical warps, the OpenCV BRIEF pattern, the DP seam at
  full resolution, and mixed sizes (192x256 with 176x240). Counts,
  h_valid, canvas overflow and corner equal; focal within 1e-3 relative;
  valid-mask IoU >= 0.999; PSNR >= 60 dB over the pixels both canvases
  cover. The two packages' sin, cos, atan2 and exp differ in the last bit,
  which moves sample positions by about 1e-4 px; the loosest case
  (spherical) is at about 71 dB.
- synthetic_pair(384, 512), default configuration: counts, corner, IoU
  and PSNR as above, the focal within 1e-2 relative (6.5e-3 when this
  test was written). Its bundle adjustment is ill-conditioned (see
  `test_translation_ba_same_inputs`), so there the adjusted focal is held
  to the objective, not to the bits.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import imagestitch_tpu as jist  # noqa: E402
from imagestitch_tpu import pipeline as jax_pipeline  # noqa: E402
from imagestitch_tpu.geometry import bundle as jax_bundle  # noqa: E402
import imagestitch_tpu_torch as tist  # noqa: E402
from imagestitch_tpu_torch.geometry.bundle import (  # noqa: E402
    bundle_adjust_ray)
from imagestitch_tpu_torch.pipeline import (register_pair,  # noqa: E402
                                            stitch_pair_impl)
from imagestitch_tpu_torch.utils.io import (synthetic_pair,  # noqa: E402
                                            synthetic_rotation_pair)

torch.set_num_threads(2)

# case -> {dotted config field: value}; "mixed_sizes" crops view 2
CASES = {
    "seam_none": {"seam.kind": "none"},
    "blend_none": {"blend.kind": "none"},
    "exposure_none": {"exposure.kind": "none"},
    "no_bundle_adjust": {"camera.ba_refine": False},
    "orient_vertical": {"seam.orient": "vertical"},
    "warp_plane": {"warp.kind": "plane"},
    "warp_spherical": {"warp.kind": "spherical"},
    "pattern_opencv": {"detector.pattern": "opencv"},
    "dp_scale_1": {"seam.dp_scale": 1},
    "mixed_sizes": {},
    "translation_384x512": {},
}


def _config(pkg, changes):
    cfg = pkg.PipelineConfig()
    for dotted, value in changes.items():
        group, field = dotted.split(".")
        sub = dataclasses.replace(getattr(cfg, group), **{field: value})
        cfg = dataclasses.replace(cfg, **{group: sub})
    return cfg


PAIR_OF = {"mixed_sizes": "mixed", "translation_384x512": "translation"}


def _pair(case):
    pair = PAIR_OF.get(case, "rotation")
    if pair == "translation":
        return synthetic_pair(384, 512)[:2]
    a, b = synthetic_rotation_pair(192, 256)[:2]
    if pair == "mixed":
        b = np.ascontiguousarray(b[:176, :240])
    return a, b


def _draws(key):
    return (np.asarray(jax.random.uniform(key, (2048, 4))),
            np.asarray(jax.random.uniform(jax.random.fold_in(key, 1),
                                          (256, 4))))


_front = jax.jit(jax_pipeline.stitch_pair_front_impl,
                 static_argnames=("cfg",))
_back = jax.jit(jax_pipeline._seam_and_blend,
                static_argnames=("cfg", "src_w", "src_h"))


def _front_cfg(case):
    cfg = _config(jist, CASES[case])
    return dataclasses.replace(cfg, seam=jist.SeamConfig(),
                               blend=jist.BlendConfig())


@pytest.fixture(scope="module")
def runs():
    """Per case, computed once on first use: the JAX canvas, mask, corner
    and metrics, and the port's with the JAX draws. The JAX side is
    `stitch_pair_core`'s two halves, `stitch_pair_front_impl` and
    `_seam_and_blend`, each jitted: cases that change only the seam or
    the blend share one front, and the distinct fronts are compiled
    ahead, three at a time."""
    key = jax.random.key(0)
    draws = _draws(key)
    fronts = {}
    for case in CASES:
        fronts.setdefault((PAIR_OF.get(case, "rotation"), _front_cfg(case)),
                          case)

    def compile_front(fkey):
        a, b = _pair(fronts[fkey])
        return _front.lower(jnp.asarray(a), jnp.asarray(b), key,
                            cfg=fkey[1]).compile()

    with ThreadPoolExecutor(max_workers=3) as pool:
        compiled = dict(zip(fronts, pool.map(compile_front, fronts)))
    cache = {}

    def get(case):
        if case not in cache:
            a, b = _pair(case)
            front = compiled[(PAIR_OF.get(case, "rotation"),
                              _front_cfg(case))]
            warped, masks, cj, mj = front(jnp.asarray(a), jnp.asarray(b),
                                          key)
            pj, vj = _back(warped, masks, cfg=_config(jist, CASES[case]),
                           src_w=max(a.shape[1], b.shape[1]),
                           src_h=max(a.shape[0], b.shape[0]))
            pt, vt, ct, mt = stitch_pair_impl(
                torch.as_tensor(a), torch.as_tensor(b),
                _config(tist, CASES[case]), draws=draws)
            cache[case] = dict(
                j=(np.asarray(pj), np.asarray(vj), np.asarray(cj),
                   {k: np.asarray(v) for k, v in mj.items()}),
                t=(pt.numpy(), vt.numpy(), ct.numpy(),
                   {k: v.numpy() for k, v in mt.items()}))
        return cache[case]
    return get


@pytest.mark.parametrize("case", list(CASES))
def test_config_metrics_match_jax(runs, case):
    _, _, cj, mj = runs(case)["j"]
    _, _, ct, mt = runs(case)["t"]
    assert sorted(mt) == sorted(mj)
    for k in ("kpts1", "kpts2", "num_matches", "num_inliers", "h_valid",
              "canvas_overflow"):
        assert int(mt[k]) == int(mj[k]), k
    assert bool(mt["h_valid"])
    # the translation pair's focal: see test_translation_ba_same_inputs
    rel = 1e-2 if case == "translation_384x512" else 1e-3
    assert abs(float(mt["focal"]) - float(mj["focal"])) \
        <= rel * float(mj["focal"])
    assert np.array_equal(ct, cj)


@pytest.mark.parametrize("case", list(CASES))
def test_config_canvas_matches_jax(runs, case):
    pj, vj, _, _ = runs(case)["j"]
    pt, vt, _, _ = runs(case)["t"]
    assert pt.shape == pj.shape
    assert (vt & vj).sum() / max((vt | vj).sum(), 1) >= 0.999
    both = vt & vj
    mse = np.mean((pt[both].astype(np.float64) - pj[both]) ** 2)
    psnr = 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))
    assert psnr >= 60.0, psnr


def _ray_error(x, ppx, ppy, src, dst, m):
    """The ray bundle adjuster's objective in float64: x (2, 4) per camera
    (focal, Rodrigues), one pair 0 -> 1."""
    def rot(r):
        t = np.linalg.norm(r)
        if t < 1e-12:
            return np.eye(3)
        k = r / t
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        return np.eye(3) + np.sin(t) * K + (1 - np.cos(t)) * K @ K

    def rays(i, pts):
        d = np.stack([(pts[:, 0] - ppx[i]) / x[i, 0],
                      (pts[:, 1] - ppy[i]) / x[i, 0],
                      np.ones(len(pts))], 1) @ rot(x[i, 1:]).T
        return d / np.linalg.norm(d, axis=1, keepdims=True)

    r = (rays(0, src) - rays(1, dst)) * np.sqrt(abs(x[0, 0] * x[1, 0]))
    return float(((r * m[:, None]) ** 2).sum())


def test_translation_ba_same_inputs():
    """Both ray bundle adjusters fed the same inputs: the cameras before
    adjustment and the inlier points of synthetic_pair(384, 512) under the
    default configuration, from the port's registration with the JAX
    RANSAC draws (counts equal to JAX's). The two LM loops are the same
    logic (the accept and stop tests, the λ schedule and clamp, float32
    throughout), yet they part at the first step: J^T J has a float64
    condition number of about 1e17 (the ray error is unchanged by a global
    rotation, and a near-pure translation hardly fixes the focal), so
    float32 rounding of about 1e-7 in J^T J moves the first step by about
    1e-3 relative. Both then walk a flat valley. When this test was
    written they stopped at 6818.7 px (JAX) and 6861.9 px (port), 6.3e-3
    apart, with objectives 50.0966 and 50.0951 (3e-5 apart, from 3.6e7
    before adjustment); JAX's own adjuster started from its own cameras
    (focal 6e-4 away) stops at 6906.8 px. So the objectives must agree
    within 1e-4 relative, and the focals within 2e-2."""
    a, b = _pair("translation_384x512")
    cfg = tist.PipelineConfig()
    no_ba = _config(tist, {"camera.ba_refine": False})
    f1, f2, mi, cams = register_pair(
        torch.as_tensor(a).float(), torch.as_tensor(b).float(), no_ba,
        draws=_draws(jax.random.key(0)))
    pairs = mi.pairs.long()
    src = f1.xy[pairs[:, 0]][None]
    dst = f2.xy[pairs[:, 1]][None]
    ptv = (mi.inliers & mi.valid)[None]
    pv = (mi.confidence > cfg.camera.ba_conf_thresh)[None]
    zero = torch.zeros(1, dtype=torch.int64)
    one = torch.ones(1, dtype=torch.int64)
    ba_t = bundle_adjust_ray(cams, src, dst, ptv, zero, one, pv,
                             cfg.camera.ba_iters)
    jcams = jist.CameraParams(**{
        f: jnp.asarray(getattr(cams, f).numpy())
        for f in ("focal", "aspect", "ppx", "ppy", "R", "t")})
    ba_j = jax.jit(jax_bundle.bundle_adjust_ray, static_argnums=7)(
        jcams, *(jnp.asarray(t.numpy()) for t in (src, dst, ptv)),
        jnp.asarray([0]), jnp.asarray([1]), jnp.asarray(pv.numpy()),
        cfg.camera.ba_iters)
    m = (ptv[0] & pv[0]).double().numpy()
    ppx, ppy = cams.ppx.double().numpy(), cams.ppy.double().numpy()

    def objective(focal, R):
        r3 = np.stack([jax_bundle.R_to_rodrigues(jnp.asarray(Ri))
                       for Ri in np.asarray(R)])
        x = np.concatenate([np.asarray(focal)[:, None], r3], 1)
        return _ray_error(x.astype(np.float64), ppx, ppy,
                          src[0].double().numpy(), dst[0].double().numpy(),
                          m)

    e0 = objective(cams.focal.numpy(), cams.R.numpy())
    e_j = objective(ba_j.focal, ba_j.R)
    e_t = objective(ba_t.focal.numpy(), ba_t.R.numpy())
    f_j, f_t = float(ba_j.focal[0]), float(ba_t.focal[0])
    assert e_j < 1e-3 * e0 and e_t < 1e-3 * e0, (e0, e_j, e_t)
    assert abs(e_t - e_j) <= 1e-4 * e_j, (e_t, e_j, f_t, f_j)
    assert abs(f_t - f_j) <= 2e-2 * f_j, (f_t, f_j)
