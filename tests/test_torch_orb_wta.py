"""imagestitch_tpu_torch's ORB descriptors with wta_k 3 and 4 against
`imagestitch_tpu.features.orb` on the CPU.

- `orb_tuple_pattern`: equal to the JAX package's, bit for bit (the same
  numpy generator and seed).
- `_orb_descriptors` on the same blurred level, keypoints and angles:
  equal one-hot codes, (K, 128·wta_k).
- `detect_and_compute` on both views of synthetic_pair(192, 256): equal
  keypoints and descriptors, as the wta_k 2 detector's test asks
  (`test_torch_detect.py`).
- `match_pair_descriptors` on the JAX package's features: equal pairs,
  distances and valid flags. The Hamming distance is a float32 matrix
  product with TF32 off: every partial sum is an integer below 2^24, so
  it is exact at 512 bits, checked against a popcount.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from imagestitch_tpu.config import DetectorConfig as JDet  # noqa: E402
from imagestitch_tpu.config import MatcherConfig as JMatch  # noqa: E402
from imagestitch_tpu.features import orb as jorb  # noqa: E402
from imagestitch_tpu.features import pattern as jpat  # noqa: E402
from imagestitch_tpu.matching import matcher as jmatcher  # noqa: E402
from imagestitch_tpu.ops.image import rgb_to_gray as j_gray  # noqa: E402
from imagestitch_tpu_torch.config import DetectorConfig  # noqa: E402
from imagestitch_tpu_torch.config import MatcherConfig  # noqa: E402
from imagestitch_tpu_torch.convert import features_from_numpy  # noqa
from imagestitch_tpu_torch.features import orb as torb  # noqa: E402
from imagestitch_tpu_torch.features import pattern as tpat  # noqa: E402
from imagestitch_tpu_torch.matching.hamming import (  # noqa: E402
    hamming_distance_matrix)
from imagestitch_tpu_torch.matching.matcher import (  # noqa: E402
    match_pair_descriptors)
from imagestitch_tpu_torch.ops.image import rgb_to_gray  # noqa: E402
from imagestitch_tpu_torch.utils.io import synthetic_pair  # noqa: E402

torch.set_num_threads(2)

FIELDS = ("xy", "response", "angle", "size", "level", "valid",
          "descriptors", "img_size")


@pytest.fixture(scope="module")
def feats():
    """Per wta_k, JAX's and the port's features of both views."""
    i1, i2, _ = synthetic_pair(192, 256)
    out = {}
    for k in (3, 4):
        jdet = jax.jit(lambda g, k=k: jorb.detect_and_compute(
            j_gray(g), JDet(wta_k=k)))
        out[k] = []
        for im in (i1, i2):
            fj = jdet(jnp.asarray(im, jnp.float32))
            ft = torb.detect_and_compute(rgb_to_gray(torch.as_tensor(im)),
                                         DetectorConfig(wta_k=k))
            out[k].append(({f: np.asarray(getattr(fj, f)) for f in FIELDS},
                           fj, ft))
    return out


@pytest.mark.parametrize("k", [3, 4])
def test_tuple_pattern_equal(k):
    want = jpat.orb_tuple_pattern(k)
    got = tpat.orb_tuple_pattern(k)
    assert got.shape == (128 * k, 2) and got.dtype == want.dtype
    assert np.array_equal(got, want)


@pytest.mark.parametrize("k", [3, 4])
def test_descriptors_on_the_same_keypoints(k):
    rng = np.random.default_rng(k)
    blurred = rng.uniform(0, 255, (80, 100)).astype(np.float32)
    # repeated values make the codes' tie rules matter
    blurred[::3] = np.round(blurred[::3] / 32) * 32
    xk = rng.integers(16, 84, 200).astype(np.int32)
    yk = rng.integers(16, 64, 200).astype(np.int32)
    ang = rng.uniform(-np.pi, np.pi, 200).astype(np.float32)
    dj = np.asarray(jorb._orb_descriptors(
        jnp.asarray(blurred), jnp.asarray(xk), jnp.asarray(yk),
        jnp.asarray(ang), JDet(wta_k=k)))
    dt = torb._orb_descriptors(
        torch.as_tensor(blurred), torch.as_tensor(xk), torch.as_tensor(yk),
        torch.as_tensor(ang), DetectorConfig(wta_k=k)).numpy()
    assert dt.shape == (200, 128 * k) and dt.dtype == np.uint8
    assert np.array_equal(dt, dj)
    assert np.all(dt.reshape(200, 128, k).sum(-1) == 1)


@pytest.mark.parametrize("view", [0, 1])
@pytest.mark.parametrize("k", [3, 4])
def test_detect_and_compute_equal(feats, k, view):
    j, _, t = feats[k][view]
    assert np.array_equal(t.xy.numpy(), j["xy"])
    assert np.array_equal(t.valid.numpy(), j["valid"])
    assert np.array_equal(t.descriptors.numpy(), j["descriptors"])
    assert int(t.num_valid()) > 150


@pytest.mark.parametrize("k", [3, 4])
def test_matches_equal(feats, k):
    (j1, fj1, _), (j2, fj2, _) = feats[k]
    pj, dj, vj = (np.asarray(a) for a in jmatcher.match_pair_descriptors(
        fj1, fj2, JMatch()))
    pt, dt, vt = match_pair_descriptors(features_from_numpy(j1),
                                        features_from_numpy(j2),
                                        MatcherConfig())
    assert np.array_equal(vt.numpy(), vj)
    assert np.array_equal(pt.numpy()[vj], pj[vj])
    assert np.array_equal(dt.numpy()[vj], dj[vj])
    assert vj.sum() > 20


def test_hamming_exact_at_512_bits():
    rng = np.random.default_rng(5)
    a = (rng.uniform(size=(64, 512)) > 0.5).astype(np.uint8)
    b = (rng.uniform(size=(80, 512)) > 0.5).astype(np.uint8)
    a[0] = 1
    b[0] = 0
    want = (a[:, None, :] != b[None, :, :]).sum(-1)
    got = hamming_distance_matrix(torch.as_tensor(a), torch.as_tensor(b))
    assert np.array_equal(got.numpy(), want.astype(np.float32))
    assert got.numpy()[0, 0] == 512
