"""imagestitch_tpu_torch exposure, seam and blend stages against the JAX
package: GAIN compensation, the L1 distance transform, the DP seam split
(auto orientation, dp_scale 4 and 1, vertical- and horizontal-seam pairs)
and the feather blend, on the same seeded canvases.

Tolerances are stated per assertion.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from imagestitch_tpu.blend.feather import feather_blend as j_feather  # noqa
from imagestitch_tpu.exposure.gain import gain_compensate as j_gain  # noqa
from imagestitch_tpu.seam.distance import (  # noqa: E402
    l1_distance_transform as j_dt)
from imagestitch_tpu.seam.dp import dp_seam_pair as j_dp  # noqa: E402
from imagestitch_tpu_torch.blend.feather import feather_blend  # noqa: E402
from imagestitch_tpu_torch.exposure.gain import gain_compensate  # noqa
from imagestitch_tpu_torch.seam.distance import l1_distance_transform  # noqa
from imagestitch_tpu_torch.seam.dp import dp_seam_pair  # noqa: E402

torch.set_num_threads(2)

HC, WC = 96, 240


def _pair(seed, vertical_offset=False):
    """Two shared-frame canvases of one smooth scene (plus per-image noise
    and a gain difference) whose masks overlap in a band with ragged
    edges; offset horizontally, or vertically (transposed)."""
    rng = np.random.default_rng(seed)
    h, w = (WC, HC) if vertical_offset else (HC, WC)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    scene = np.stack([120 + 60 * np.sin(xx / 9.0 + c) * np.cos(yy / 13.0)
                      for c in range(3)], -1)
    a = scene + rng.normal(0, 4, scene.shape)
    b = 1.15 * scene + rng.normal(0, 4, scene.shape)
    edge1 = (0.62 * w + rng.integers(-6, 7, h))[:, None]
    edge2 = (0.38 * w + rng.integers(-6, 7, h))[:, None]
    m1 = xx < edge1
    m2 = xx >= edge2
    m1[:3] = False
    m2[-4:] = False
    imgs = np.stack([a * m1[..., None], b * m2[..., None]]).astype(
        np.float32)
    masks = np.stack([m1, m2])
    if vertical_offset:
        imgs = imgs.transpose(0, 2, 1, 3).copy()
        masks = masks.transpose(0, 2, 1).copy()
    return imgs, masks


def test_gain_compensate_matches_jax():
    """Gains within 1e-5 relative: the overlap sums are float32
    reductions in another order."""
    imgs, masks = _pair(1)
    gj, oj = j_gain(jnp.asarray(imgs), jnp.asarray(masks),
                    jnp.zeros((2, 2), jnp.int32), shared_frame=True)
    gt, ot = gain_compensate(torch.as_tensor(imgs), torch.as_tensor(masks))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-5)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-5,
                               atol=1e-3)
    assert float(gt[0]) > float(gt[1])      # the brighter image is damped


@pytest.mark.parametrize("max_dist", [None, 3])
def test_l1_distance_transform_matches_jax(max_dist):
    """Exact: integer distances."""
    rng = np.random.default_rng(2)
    m = rng.uniform(size=(2, 40, 57)) > 0.1
    dj = np.asarray(j_dt(jnp.asarray(m), max_dist=max_dist))
    dt = l1_distance_transform(torch.as_tensor(m), max_dist=max_dist)
    assert np.array_equal(dt.numpy(), dj)


@pytest.mark.parametrize("scale", [4, 1])
@pytest.mark.parametrize("offset", ["horizontal", "vertical"])
def test_dp_seam_pair_auto_matches_jax(scale, offset):
    """orient="auto": a horizontally offset pair takes a vertical seam, a
    vertically offset pair a horizontal one. Split masks equal: the
    costs are computed in the same order, the DP takes first minima."""
    imgs, masks = _pair(3, offset == "vertical")
    H, W = masks.shape[1:]
    max_w = -(-int(round(1.1 * 160)) // 128) * 128
    a1, b1, _ = j_dp(jnp.asarray(imgs[0]), jnp.asarray(imgs[1]),
                     jnp.asarray(masks[0]), jnp.asarray(masks[1]), False,
                     max_overlap_w=max_w, max_overlap_h=max_w,
                     orient="auto", scale=scale)
    a2, b2, _ = dp_seam_pair(torch.as_tensor(imgs[0]),
                             torch.as_tensor(imgs[1]),
                             torch.as_tensor(masks[0]),
                             torch.as_tensor(masks[1]), False,
                             max_overlap_w=max_w, max_overlap_h=max_w,
                             orient="auto", scale=scale)
    assert np.array_equal(a2.numpy(), np.asarray(a1))
    assert np.array_equal(b2.numpy(), np.asarray(b1))
    both = masks[0] & masks[1]
    # the seam split partitions the overlap
    assert not (a2.numpy() & b2.numpy() & both).any()
    assert np.array_equal((a2.numpy() | b2.numpy()),
                          masks[0] | masks[1])


@pytest.mark.parametrize("sharpness", [5.0, 0.1])
def test_feather_blend_matches_jax(sharpness):
    """Within 1e-3 intensity: normalized float32 weighted sums."""
    imgs, masks = _pair(4)
    oj, vj = j_feather(jnp.asarray(imgs), jnp.asarray(masks), sharpness)
    ot, vt = feather_blend(torch.as_tensor(imgs), torch.as_tensor(masks),
                           sharpness)
    assert np.array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-3)
