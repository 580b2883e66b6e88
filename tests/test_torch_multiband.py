"""imagestitch_tpu_torch's multi-band blender against
`imagestitch_tpu.blend.multiband` on the CPU, alone and inside
`stitch_pair`.

- `multiband_blend` on seeded canvases and overlapping masks, at 3 and 5
  bands and at odd canvas sizes: valid masks equal; values within 2e-4 of
  the JAX package's on 0..255 canvases (7.6e-5 when written). The
  blur, the halving resize and the doubling resize of a pyramid level
  equal JAX's bit for bit at the sizes tested here, but at some small
  level sizes XLA:CPU's dot sums the resize's taps in another order than
  the port's sequential one, which moves a level by an ulp or two.
- The doubling resize takes XLA's contraction order (columns first for a
  landscape image): bit for bit on 96x128 -> 192x256 and 48x64 -> 96x128.
- `stitch_pair` with `BlendConfig(kind="multiband")` (5 bands) on the
  192x256 rotation and translation pairs, against JAX's
  `stitch_pair_core` with its RANSAC draws injected: equal counts and
  corner, focal within 1e-3, valid-mask IoU >= 0.999 and PSNR >= 40 dB
  over the pixels both cover (`tests/test_torch_pipeline.py`'s
  tolerances).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import imagestitch_tpu as jist  # noqa: E402
from imagestitch_tpu.blend.multiband import multiband_blend as jmb  # noqa
from imagestitch_tpu.pipeline import stitch_pair_core  # noqa: E402
import imagestitch_tpu_torch as tist  # noqa: E402
from imagestitch_tpu_torch.blend.multiband import multiband_blend  # noqa
from imagestitch_tpu_torch.ops.image import resize_planes  # noqa: E402
from imagestitch_tpu_torch.pipeline import stitch_pair_impl  # noqa: E402

from test_torch_pipeline import PAIRS, _draws, _pair  # noqa: E402

torch.set_num_threads(2)

TOL = 2e-4


def _canvases(n, h, w, seed):
    """n seeded canvases, each covering a band of columns that overlaps its
    neighbours', zero outside its mask."""
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0, 255, (n, h, w, 3)).astype(np.float32)
    m = np.zeros((n, h, w), bool)
    for i in range(n):
        x0 = i * w // (n + 1)
        m[i, 2 * i:, x0:x0 + w // 2 + 10] = True
    return imgs * m[..., None], m


_jmb = jax.jit(jmb, static_argnums=2)


@pytest.mark.parametrize("n,h,w,bands", [
    (2, 96, 128, 3), (2, 96, 128, 5), (3, 101, 147, 5), (2, 75, 93, 3),
    (3, 64, 200, 4)])
def test_multiband_blend_matches_jax(n, h, w, bands):
    imgs, m = _canvases(n, h, w, n * 100 + h)
    oj, vj = _jmb(jnp.asarray(imgs), jnp.asarray(m), bands)
    ot, vt = multiband_blend(torch.as_tensor(imgs), torch.as_tensor(m),
                             bands)
    assert ot.shape == (h, w, 3) and ot.dtype == torch.float32
    assert np.array_equal(vt.numpy(), np.asarray(vj))
    assert float(np.abs(ot.numpy() - np.asarray(oj)).max()) <= TOL
    assert float(ot[~vt].abs().max()) == 0.0


@pytest.mark.parametrize("shape,out", [((96, 128), (192, 256)),
                                       ((48, 64), (96, 128))])
def test_doubling_resize_matches_jax(shape, out):
    rng = np.random.default_rng(shape[0])
    x = rng.uniform(0, 255, (3,) + shape).astype(np.float32)
    j = np.asarray(jax.jit(lambda a: jax.image.resize(
        a, out + (3,), "linear"))(jnp.asarray(x.transpose(1, 2, 0))))
    t = resize_planes(torch.as_tensor(x), out).numpy().transpose(1, 2, 0)
    assert np.array_equal(t, j)


@pytest.fixture(scope="module")
def stitched():
    key = jax.random.key(0)
    jcfg = jist.PipelineConfig(blend=jist.BlendConfig(kind="multiband"))
    tcfg = tist.PipelineConfig(blend=tist.BlendConfig(kind="multiband"))
    out = {}
    for name in PAIRS:
        a, b = _pair(name)
        pj, vj, cj, mj = stitch_pair_core(jnp.asarray(a), jnp.asarray(b),
                                          key, jcfg)
        pt, vt, ct, mt = stitch_pair_impl(torch.as_tensor(a),
                                          torch.as_tensor(b), tcfg,
                                          draws=_draws(key))
        out[name] = ((np.asarray(pj), np.asarray(vj), np.asarray(cj),
                      {k: np.asarray(v) for k, v in mj.items()}),
                     (pt.numpy(), vt.numpy(), ct.numpy(),
                      {k: v.numpy() for k, v in mt.items()}))
    return out


@pytest.mark.parametrize("name", PAIRS)
def test_stitch_pair_multiband_matches_jax(stitched, name):
    (pj, vj, cj, mj), (pt, vt, ct, mt) = stitched[name]
    for k in ("kpts1", "kpts2", "num_matches", "num_inliers", "h_valid"):
        assert int(mt[k]) == int(mj[k]), k
    assert abs(float(mt["focal"]) - float(mj["focal"])) \
        <= 1e-3 * float(mj["focal"])
    assert np.array_equal(ct, cj)
    assert pt.shape == pj.shape
    assert (vt & vj).sum() / max((vt | vj).sum(), 1) >= 0.999
    both = vt & vj
    mse = np.mean((pt[both].astype(np.float64) - pj[both]) ** 2)
    assert 10 * np.log10(255.0 ** 2 / max(mse, 1e-12)) >= 40.0
