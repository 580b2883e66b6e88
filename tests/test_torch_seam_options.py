"""imagestitch_tpu_torch's Voronoi seam, colour-gradient DP cost and
seam-anchored ramp blend against `imagestitch_tpu` on the CPU, on seeded
shared-frame canvases whose masks overlap in a band with ragged edges.

- `voronoi_seam_pair`: equal masks (integer distances, the same ties).
- `seam_costs(use_grad=True)`: within 1e-6 relative (the gray conversion
  is a dot product in XLA and three multiply-adds here, which can differ
  in the last bit; the Sobel taps are exact), and `dp_seam_pair` on it
  finds the same seam columns, at scale 1 and at the default scale 4.
- `overlap_extents` and `ramp_weights`: equal (integer extents; the
  weights are the same float32 operations in the same order).
- `ramp_blend_pair` on a 192x256 pair, colour and colour-gradient costs:
  the same seam, the same valid mask, the pano within 1e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from imagestitch_tpu.blend.ramp import ramp_blend_pair as j_ramp  # noqa
from imagestitch_tpu.seam import dp as jdp  # noqa: E402
from imagestitch_tpu.seam.voronoi import voronoi_seam_pair as j_vor  # noqa
from imagestitch_tpu_torch.blend.ramp import ramp_blend_pair  # noqa: E402
from imagestitch_tpu_torch.seam import dp as tdp  # noqa: E402
from imagestitch_tpu_torch.seam.voronoi import voronoi_seam_pair  # noqa

torch.set_num_threads(2)


def _pair(seed, h=96, w=240, swap=False):
    """Two canvases of one textured scene (noise and a gain difference
    apart) whose masks overlap in a band of ragged edges; with `swap` the
    right-hand view comes first."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    scene = np.stack([120 + 60 * np.sin(xx / 7.0 + c) * np.cos(yy / 11.0)
                      + 30 * np.sin(xx * yy / 900.0) for c in range(3)], -1)
    a = scene + rng.normal(0, 4, scene.shape)
    b = 1.1 * scene + rng.normal(0, 4, scene.shape)
    m1 = xx < (0.6 * w + rng.integers(-6, 7, h))[:, None]
    m2 = xx >= (0.35 * w + rng.integers(-6, 7, h))[:, None]
    m1[:3] = False
    m2[-5:] = False
    imgs = np.stack([a * m1[..., None], b * m2[..., None]]).astype(
        np.float32)
    masks = np.stack([m1, m2])
    if swap:
        imgs, masks = imgs[::-1].copy(), masks[::-1].copy()
    return imgs, masks


def _t(*xs):
    return [torch.as_tensor(np.ascontiguousarray(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_voronoi_equal(seed):
    _, masks = _pair(seed)
    masks[1, 40:50, 150:160] = False        # a hole changes the distances
    aj, bj = j_vor(*_j(masks[0], masks[1]))
    at, bt = voronoi_seam_pair(*_t(masks[0], masks[1]))
    assert np.array_equal(at.numpy(), np.asarray(aj))
    assert np.array_equal(bt.numpy(), np.asarray(bj))
    assert not (at & bt).any()
    assert np.array_equal((at | bt).numpy(), masks[0] | masks[1])


@pytest.mark.parametrize("seed", [0, 3])
def test_colorgrad_cost_and_seam(seed):
    imgs, masks = _pair(seed)
    both = masks[0] & masks[1]
    cj = np.asarray(jdp.seam_costs(*_j(imgs[0], imgs[1], both),
                                   use_grad=True))
    ct = tdp.seam_costs(*_t(imgs[0], imgs[1], both), use_grad=True).numpy()
    np.testing.assert_allclose(ct, cj, rtol=1e-6)
    for scale in (1, 4):
        rj = jdp.dp_seam_pair(*_j(imgs[0], imgs[1], masks[0], masks[1]),
                              use_grad=True, orient="vertical", scale=scale)
        rt = tdp.dp_seam_pair(*_t(imgs[0], imgs[1], masks[0], masks[1]),
                              use_grad=True, orient="vertical", scale=scale)
        assert np.array_equal(rt[2].numpy(), np.asarray(rj[2]))
        assert np.array_equal(rt[0].numpy(), np.asarray(rj[0]))
        assert np.array_equal(rt[1].numpy(), np.asarray(rj[1]))


def test_overlap_extents_and_ramp_weights_equal():
    _, masks = _pair(4)
    both = masks[0] & masks[1]
    both[10:14] = False                      # rows without overlap
    lj, rj, hj = jdp.overlap_extents(jnp.asarray(both))
    lt, rt, ht = tdp.overlap_extents(torch.as_tensor(both))
    for a, b in ((lt, lj), (rt, rj), (ht, hj)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    seam = np.clip(np.asarray(lj) + 20 + np.arange(both.shape[0]) % 7, 0,
                   both.shape[1] - 1).astype(np.int32)
    wj = jdp.ramp_weights(jnp.asarray(both), jnp.asarray(seam))
    wt = tdp.ramp_weights(torch.as_tensor(both), torch.as_tensor(seam))
    assert np.array_equal(wt.numpy(), np.asarray(wj))


@pytest.mark.parametrize("use_grad,swap", [(False, False), (True, False),
                                           (True, True)])
def test_ramp_blend_pair(use_grad, swap):
    imgs, masks = _pair(5, 192, 256, swap)
    pj, vj, sj = j_ramp(*_j(imgs[0], imgs[1], masks[0], masks[1]),
                        use_grad=use_grad, max_overlap_w=256)
    pt, vt, st = ramp_blend_pair(*_t(imgs[0], imgs[1], masks[0], masks[1]),
                                 use_grad=use_grad, max_overlap_w=256)
    assert np.array_equal(st.numpy(), np.asarray(sj))
    assert np.array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0,
                               atol=1e-4)
