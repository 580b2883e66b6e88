"""imagestitch_tpu_torch's exposure compensators against
`imagestitch_tpu.exposure.gain` on the CPU: GAIN (shared frame and per
frame, with corners), CHANNELS, GAIN_BLOCKS and CHANNELS_BLOCKS, on
seeded 3- and 4-view canvases with partial overlaps, differently exposed
views and one view whose mask leaves a whole block cell empty.

Tolerances: gains within 1e-5 relative (the overlap and block sums are
float32 reductions in another order, and `torch.linalg.solve` and
`jnp.linalg.solve` pivot and round differently); compensated images
within 1e-5 relative plus 1e-3 absolute. With a NaN inside an overlap
both packages' non-finite guard fires: every gain is exactly 1.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from imagestitch_tpu.exposure import gain as jgain  # noqa: E402
from imagestitch_tpu_torch import pipeline as tpipe  # noqa: E402
from imagestitch_tpu_torch.config import (ExposureConfig,  # noqa: E402
                                          PipelineConfig)
from imagestitch_tpu_torch.exposure import gain as tgain  # noqa: E402

torch.set_num_threads(2)

H, W = 96, 160


def _canvases(n, seed):
    """n shared-frame canvases, view i covering columns [30 i, 30 i + 80)
    of a common scene at exposure 0.8 + 0.15 i; the last view's mask also
    misses a 40x40 corner (a 32-px cell with no mask pixel of any
    view)."""
    rng = np.random.default_rng(seed)
    scene = rng.uniform(20, 220, (H, W, 3)).astype(np.float32)
    imgs = np.zeros((n, H, W, 3), np.float32)
    masks = np.zeros((n, H, W), bool)
    for i in range(n):
        x0 = 30 * i
        masks[i, 4:H - 4, x0:x0 + 80] = True
        imgs[i] = scene * (0.8 + 0.15 * i) * masks[i][..., None]
    masks[-1, :40, W - 40:] = False
    masks[:, :, W - 8:] = False
    imgs *= masks[..., None]
    return imgs, masks


@pytest.mark.parametrize("n", [3, 4])
def test_gain_shared_frame(n):
    imgs, masks = _canvases(n, n)
    gj, oj = jgain.gain_compensate(jnp.asarray(imgs), jnp.asarray(masks),
                                   jnp.zeros((n, 2), jnp.int32),
                                   shared_frame=True)
    gt, ot = tgain.gain_compensate(torch.as_tensor(imgs),
                                   torch.as_tensor(masks))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-5)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-5,
                               atol=1e-3)


@pytest.mark.parametrize("n", [3, 4])
def test_gain_per_frame_with_corners(n):
    """Each view on its own canvas with its own pano corner: the
    per-frame path moves canvas j into canvas i's frame."""
    imgs, masks = _canvases(n, 10 + n)
    corners = np.asarray([[-30 * i, 5 * i] for i in range(n)], np.int32)
    own = np.stack([np.roll(imgs[i], (5 * i, -30 * i), axis=(0, 1))
                    for i in range(n)])
    own_m = np.stack([np.roll(masks[i], (5 * i, -30 * i), axis=(0, 1))
                      for i in range(n)])
    gj, oj = jgain.gain_compensate(jnp.asarray(own), jnp.asarray(own_m),
                                   jnp.asarray(corners))
    gt, ot = tgain.gain_compensate(torch.as_tensor(own),
                                   torch.as_tensor(own_m),
                                   torch.as_tensor(corners))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-5)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-5,
                               atol=1e-3)


@pytest.mark.parametrize("kind", ["gain", "channels"])
def test_shared_frame_skips_given_corners(kind):
    """`shared_frame=True` with nonzero corners given: the JAX package's
    gains (it skips the frame shifts too), and exactly the port's
    `corners=None`."""
    n = 3
    imgs, masks = _canvases(n, 30)
    corners = np.asarray([[-30 * i, 5 * i] for i in range(n)], np.int32)
    name = f"{kind}_compensate"
    gj, oj = getattr(jgain, name)(jnp.asarray(imgs), jnp.asarray(masks),
                                  jnp.asarray(corners), shared_frame=True)
    ti, tm = torch.as_tensor(imgs), torch.as_tensor(masks)
    gt, ot = getattr(tgain, name)(ti, tm, torch.as_tensor(corners),
                                  shared_frame=True)
    g0, o0 = getattr(tgain, name)(ti, tm)
    assert torch.equal(gt, g0) and torch.equal(ot, o0)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-5)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-5,
                               atol=1e-3)


@pytest.mark.parametrize("n", [3, 4])
def test_channels(n):
    imgs, masks = _canvases(n, 20 + n)
    imgs[..., 1] *= 1.1
    gj, oj = jgain.channels_compensate(jnp.asarray(imgs),
                                       jnp.asarray(masks),
                                       jnp.zeros((n, 2), jnp.int32),
                                       shared_frame=True)
    gt, ot = tgain.channels_compensate(torch.as_tensor(imgs),
                                       torch.as_tensor(masks))
    assert gt.shape == (n, 3)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-5)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-5,
                               atol=1e-3)


@pytest.mark.parametrize("kind", ["gain_blocks", "channels_blocks"])
@pytest.mark.parametrize("n,block", [(3, 32), (4, 16)])
def test_blocks(kind, n, block):
    imgs, masks = _canvases(n, 30 + n)
    jfn = getattr(jgain, {"gain_blocks": "gain_compensate_blocks",
                          "channels_blocks": "channels_compensate_blocks"
                          }[kind])
    tfn = getattr(tgain, {"gain_blocks": "gain_compensate_blocks",
                          "channels_blocks": "channels_compensate_blocks"
                          }[kind])
    mj, oj = jfn(jnp.asarray(imgs), jnp.asarray(masks), block)
    mt, ot = tfn(torch.as_tensor(imgs), torch.as_tensor(masks), block)
    assert mt.shape == np.asarray(mj).shape
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-5)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-5,
                               atol=1e-3)
    # the empty cell keeps unit gain before smoothing: its smoothed gain
    # stays near 1 in both
    assert abs(float(mt[-1, 5, W - 5].mean()) - 1.0) < 0.2


@pytest.mark.parametrize("kind", ["gain", "channels"])
def test_non_finite_guard(kind):
    """A NaN inside an overlap makes the solve non-finite: every gain is 1
    in both packages."""
    imgs, masks = _canvases(3, 40)
    imgs[1, 50, 70, 0] = np.nan
    if kind == "gain":
        gj, _ = jgain.gain_compensate(jnp.asarray(imgs), jnp.asarray(masks),
                                      jnp.zeros((3, 2), jnp.int32),
                                      shared_frame=True)
        gt, _ = tgain.gain_compensate(torch.as_tensor(imgs),
                                      torch.as_tensor(masks))
    else:
        gj, _ = jgain.channels_compensate(
            jnp.asarray(imgs), jnp.asarray(masks),
            jnp.zeros((3, 2), jnp.int32), shared_frame=True)
        gt, _ = tgain.channels_compensate(torch.as_tensor(imgs),
                                          torch.as_tensor(masks))
    assert np.all(np.asarray(gj) == 1.0)
    assert np.all(gt.numpy() == 1.0)


@pytest.mark.parametrize("kind", ["gain", "gain_blocks", "channels",
                                  "channels_blocks", "none"])
def test_pipeline_dispatch(kind):
    """`_apply_exposure` picks the compensator of the kind, as the JAX
    package's dispatch does, with the config's block size."""
    from imagestitch_tpu import pipeline as jpipe
    from imagestitch_tpu.config import ExposureConfig as JExp
    from imagestitch_tpu.config import PipelineConfig as JCfg
    imgs, masks = _canvases(3, 50)
    oj = jpipe._apply_exposure(jnp.asarray(imgs), jnp.asarray(masks),
                               JCfg(exposure=JExp(kind=kind, block_size=16)))
    ot = tpipe._apply_exposure(
        torch.as_tensor(imgs), torch.as_tensor(masks),
        PipelineConfig(exposure=ExposureConfig(kind=kind, block_size=16)))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-5,
                               atol=1e-3)
