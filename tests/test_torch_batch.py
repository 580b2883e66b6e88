"""imagestitch_tpu_torch's `stitch_pairs_batched` against
`imagestitch_tpu.parallel.stitch_pairs_batched` on the CPU (the kernels'
plain versions), at the JAX package's own test size and configuration
(`tests/test_parallel.py`: 144x192 pairs, TINY), B = 3, with each pair's
RANSAC draws taken from its key of `jax.random.split(key, B)`.

- Against JAX's batch: equal shapes, corners, inlier counts and h_valid;
  focal within 1e-3 relative; each canvas within 0.5 on average and its
  0.999 quantile within 30 (`tests/test_parallel.py:38-54`: JAX's own
  vmapped linear algebra rounds differently from its single-pair
  program).
- Against the port's `stitch_pair_impl` on each pair with the same draws:
  equal canvas, valid mask, corner and metrics, bit for bit (the batch
  runs the same operations; the warp takes each view's pair scale).
- One batched detect and one warp call for the whole batch.
- seam.orient="auto" resolves to "vertical" (the batch equals an explicit
  vertical batch); the host seam kinds raise the JAX batch's ValueError,
  with its message; without a card the default device raises.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from imagestitch_tpu.config import (BlendConfig, CameraConfig,  # noqa
                                    DetectorConfig, MatcherConfig,
                                    PipelineConfig, RansacConfig,
                                    SeamConfig)
from imagestitch_tpu.parallel import stitch_pairs_batched as jbatched  # noqa
from imagestitch_tpu.utils.io import synthetic_pair  # noqa: E402
import imagestitch_tpu_torch as tist  # noqa: E402
from imagestitch_tpu_torch.convert import config_from_dict  # noqa: E402
from imagestitch_tpu_torch import pipeline as tpipe  # noqa: E402
from imagestitch_tpu_torch.parallel import batch as tbatch  # noqa: E402
from imagestitch_tpu_torch.pipeline import stitch_pair_impl  # noqa: E402

from test_torch_chain import pair_draws  # noqa: E402

torch.set_num_threads(2)

# tests/test_parallel.py's configuration
TINY = PipelineConfig(
    detector=DetectorConfig(nfeatures=96, max_keypoints=288, nlevels=3),
    matcher=MatcherConfig(max_matches=96),
    ransac=RansacConfig(num_hypotheses=128),
    camera=CameraConfig(ba_iters=4),
    blend=BlendConfig(num_bands=2),
)
B = 3


def _pairs(batch, seed=1):
    ps = []
    for b in range(batch):
        i1, i2, _ = synthetic_pair(144, 192, overlap=0.5, seed=seed + b)
        ps.append(np.stack([i1, i2]))
    return np.stack(ps)


def _tcfg(cfg):
    return config_from_dict(dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def runs():
    pairs = _pairs(B)
    keys = jax.random.split(jax.random.key(0), B)
    draws = {b: pair_draws(keys[b], TINY.ransac.num_hypotheses)
             for b in range(B)}
    pj, vj, cj, mj = jbatched(jnp.asarray(pairs, jnp.float32), keys, TINY)
    calls = {"detect": 0, "warp": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbatch, "detect_batched",
                   counting("detect", tbatch.detect_batched))
        mp.setattr(tpipe, "warp_batched",
                   counting("warp", tpipe.warp_batched))
        pt, vt, ct, mt = tist.stitch_pairs_batched(
            pairs, _tcfg(TINY), device="cpu", draws=draws)
    return dict(pairs=pairs, draws=draws, calls=calls,
                j=(np.asarray(pj), np.asarray(vj), np.asarray(cj),
                   {k: np.asarray(v) for k, v in mj.items()}),
                t=(pt, vt, ct, mt))


def test_batched_matches_jax(runs):
    pj, vj, cj, mj = runs["j"]
    pt, vt, ct, mt = runs["t"]
    assert pt.shape == pj.shape and vt.shape == vj.shape
    assert sorted(mt) == sorted(mj)
    assert np.array_equal(ct.numpy(), cj)
    for k in ("num_inliers", "h_valid", "kpts1", "kpts2", "num_matches"):
        assert np.array_equal(mt[k].numpy(), mj[k]), k
    assert bool(mt["h_valid"].all())
    np.testing.assert_allclose(mt["focal"].numpy(), mj["focal"], rtol=1e-3)
    for b in range(B):
        d = np.abs(pt[b].numpy() - pj[b])
        assert d.mean() < 0.5
        assert np.quantile(d, 0.999) < 30.0


@pytest.mark.parametrize("b", range(B))
def test_batched_equals_single_pair(runs, b):
    pt, vt, ct, mt = runs["t"]
    cfg = _tcfg(TINY)
    cfg = cfg.replace(seam=dataclasses.replace(cfg.seam, orient="vertical"))
    a, c = runs["pairs"][b]
    p1, v1, c1, m1 = stitch_pair_impl(torch.as_tensor(a),
                                      torch.as_tensor(c), cfg,
                                      runs["draws"][b])
    assert torch.equal(pt[b], p1) and torch.equal(vt[b], v1)
    assert torch.equal(ct[b], c1)
    assert sorted(m1) == sorted(mt)
    for k, v in m1.items():
        assert torch.equal(mt[k][b], v), k


def test_one_detect_and_one_warp_per_batch(runs):
    assert runs["calls"] == {"detect": 1, "warp": 1}


def test_auto_orient_resolves_to_vertical(runs):
    cfg = _tcfg(TINY)
    vert = cfg.replace(seam=dataclasses.replace(cfg.seam,
                                                orient="vertical"))
    pairs = runs["pairs"][:2]
    draws = {b: runs["draws"][b] for b in range(2)}
    pa, va, _, _ = tist.stitch_pairs_batched(pairs, cfg, device="cpu",
                                             draws=draws)
    pv, vv, _, _ = tist.stitch_pairs_batched(pairs, vert, device="cpu",
                                             draws=draws)
    assert torch.equal(pa, pv) and torch.equal(va, vv)
    assert torch.equal(pa, runs["t"][0][:2])


@pytest.mark.parametrize("seam", [dict(kind="graphcut"),
                                  dict(kind="graphcut_colorgrad"),
                                  dict(kind="dp_color",
                                       full_components=True)])
def test_batched_host_seam_kind_raises(seam):
    """A host seam has no place in a batch: the port raises the JAX
    package's ValueError, before any stitching."""
    cfg = tist.PipelineConfig().replace(seam=tist.SeamConfig(**seam))
    with pytest.raises(ValueError, match="resolves on the host") as et:
        tist.stitch_pairs_batched(_pairs(1), cfg, device="cpu")
    jc = TINY.replace(seam=SeamConfig(**seam))
    with pytest.raises(ValueError, match="resolves on the host") as ej:
        jbatched(jnp.asarray(_pairs(1), jnp.float32),
                 jax.random.split(jax.random.key(0), 1), jc)
    assert str(et.value) == str(ej.value)


def test_batched_checks_shape_and_device():
    with pytest.raises(ValueError, match="B, 2, H, W"):
        tist.stitch_pairs_batched(_pairs(1)[:, 0], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tist.stitch_pairs_batched(_pairs(1))
