"""imagestitch_tpu_torch's eleven rotation projectors and the plain warp's
options against `imagestitch_tpu.warp` on the CPU.

- `forward` and `backward` of every projector kind on the same camera,
  scale and points: within 1e-3 px, the backward validity (z > 0) equal.
  The two libraries' float32 sin, cos, atan2, asin, log, sinh and cosh
  differ in the last bit, about 1e-5 px at these coordinates.
- `warp_image` of every kind, bilinear with a source mask and nearest
  without: the same canvas corner and ROI size; masks equal except on
  pixels within 1e-3 px of the validity boundary
  (`testing.near_validity_boundary`: the image border for the bilinear
  warp; for the nearest warp a half-integer source coordinate, where the
  rounding picks the tap, the in-image test and the mask lookup); values
  equal where both are valid off those pixels (nearest), or within 2e-2
  (bilinear: the backward maps' chains of float32 trig functions differ
  by up to about 8e-5 px, ten ulps at x = 100, times the random image's
  intensity steps of up to 255 per pixel; 5.4e-3 at most when written).
- `warp_point`: within 1e-3 px.
- The pipeline warps the kernel's three kinds with `warp_batched` and the
  other eight with the plain warp.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from imagestitch_tpu.warp import projectors as jproj  # noqa: E402
from imagestitch_tpu.warp import warper as jwarp  # noqa: E402
from imagestitch_tpu_torch import pipeline as tpipe  # noqa: E402
from imagestitch_tpu_torch.testing import near_validity_boundary  # noqa
from imagestitch_tpu_torch.warp import projectors as tproj  # noqa: E402
from imagestitch_tpu_torch.warp import warper as twarp  # noqa: E402

torch.set_num_threads(2)

KINDS = sorted(jproj.PROJECTORS)
H, W = 96, 128
F = 110.0


def _rot(yaw, pitch, roll):
    cy, sy = np.cos(yaw), np.sin(yaw)
    cx, sx = np.cos(pitch), np.sin(pitch)
    cz, sz = np.cos(roll), np.sin(roll)
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return (Rz @ Rx @ Ry).astype(np.float32)


K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]], np.float32)
R = _rot(0.15, 0.05, 0.02)


def test_every_kind_is_ported():
    assert sorted(tproj.PROJECTORS) == KINDS
    from imagestitch_tpu_torch.ops.cuda_warp import KIND_IDS
    assert sorted(KIND_IDS) == ["cylindrical", "plane", "spherical"]


@pytest.mark.parametrize("kind", KINDS)
def test_forward_backward(kind):
    pj = jproj.PROJECTORS[kind](jnp.asarray(K), jnp.asarray(R), F)
    pt = tproj.PROJECTORS[kind](torch.as_tensor(K), torch.as_tensor(R), F)
    rng = np.random.default_rng(1)
    x = rng.uniform(0, W - 1, (40, 50)).astype(np.float32)
    y = rng.uniform(0, H - 1, (40, 50)).astype(np.float32)
    uj, vj = (np.asarray(a) for a in pj.forward(jnp.asarray(x),
                                                jnp.asarray(y)))
    ut, vt = (a.numpy() for a in pt.forward(torch.as_tensor(x),
                                            torch.as_tensor(y)))
    np.testing.assert_allclose(ut, uj, rtol=0, atol=1e-3)
    np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-3)
    # backward over the forward image's extent and a margin around it
    u = np.linspace(uj.min() - 20, uj.max() + 20, 60, dtype=np.float32)
    v = np.linspace(vj.min() - 20, vj.max() + 20, 50, dtype=np.float32)
    ug, vg = np.meshgrid(u, v)
    xj, yj, okj = (np.asarray(a) for a in pj.backward(jnp.asarray(ug),
                                                      jnp.asarray(vg)))
    xt, yt, okt = (a.numpy() for a in pt.backward(torch.as_tensor(ug),
                                                  torch.as_tensor(vg)))
    assert np.array_equal(okt, okj)
    sel = okj & (np.abs(xj) < 1e4) & (np.abs(yj) < 1e4)
    assert sel.mean() > 0.5
    np.testing.assert_allclose(xt[sel], xj[sel], rtol=0, atol=1e-3)
    np.testing.assert_allclose(yt[sel], yj[sel], rtol=0, atol=1e-3)
    # the round trip lands back on the source points
    xb, yb, _ = pt.backward(*pt.forward(torch.as_tensor(x),
                                        torch.as_tensor(y)))
    np.testing.assert_allclose(xb.numpy(), x, atol=2e-2)
    np.testing.assert_allclose(yb.numpy(), y, atol=2e-2)


def _image(seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 255, (H, W, 3)).astype(np.float32)


@pytest.mark.parametrize("interp", ["linear", "nearest"])
@pytest.mark.parametrize("kind", KINDS)
def test_warp_image_options(kind, interp):
    img = _image(2)
    mask = None
    if interp == "linear":
        mask = np.ones((H, W), bool)
        mask[30:50, 40:70] = False          # a hole in the source mask
    canvas = (150, 220)
    rj = jwarp.warp_image(jnp.asarray(img), jnp.asarray(K), jnp.asarray(R),
                          F, canvas, kind,
                          mask=None if mask is None else jnp.asarray(mask),
                          interp=interp, use_pallas=False)
    rt = twarp.warp_image(torch.as_tensor(img), torch.as_tensor(K),
                          torch.as_tensor(R), F, canvas, kind,
                          mask=None if mask is None else torch.as_tensor(
                              mask), interp=interp)
    corner = np.asarray(rj.corner)
    assert np.array_equal(rt.corner.numpy(), corner)
    assert np.array_equal(rt.size.numpy(), np.asarray(rj.size))
    _, k_rinv = tproj._camera_mats(torch.as_tensor(K), torch.as_tensor(R))
    corner = corner.copy()
    near = near_validity_boundary(
        k_rinv[None], F, torch.as_tensor(corner)[None], canvas, kind,
        [(H, W)], interp=interp)[0].numpy()
    if mask is not None:
        # the source mask's hole edges: rounding picks the side there
        ms = near_validity_boundary(
            k_rinv[None], F, torch.as_tensor(corner)[None], canvas, kind,
            [(H, W)], interp="nearest")[0].numpy()
        near = near | ms
    mj, mt = np.asarray(rj.mask), rt.mask.numpy()
    assert mj.sum() > 0.2 * H * W
    assert np.array_equal(mt & ~near, mj & ~near)
    both = mj & mt & ~near
    oj, ot = np.asarray(rj.image), rt.image.numpy()
    if interp == "nearest":
        assert np.array_equal(ot[both], oj[both])
    else:
        np.testing.assert_allclose(ot[both], oj[both], rtol=0, atol=2e-2)
    assert np.all(ot[~mt] == 0)


@pytest.mark.parametrize("kind", KINDS)
def test_warp_point(kind):
    rng = np.random.default_rng(3)
    xy = rng.uniform(0, 90, (7, 5, 2)).astype(np.float32)
    pj = np.asarray(jwarp.warp_point(jnp.asarray(xy), jnp.asarray(K),
                                     jnp.asarray(R), F, kind))
    pt = twarp.warp_point(torch.as_tensor(xy), torch.as_tensor(K),
                          torch.as_tensor(R), F, kind).numpy()
    assert pt.shape == (7, 5, 2)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-3)


@pytest.mark.parametrize("kind", ["spherical", "paniniA2B1", "mercator"])
def test_pipeline_warp_dispatch(kind, monkeypatch):
    """The warp kernel's kinds go to `warp_batched` (its plain version on
    the CPU), the other kinds to the plain warp directly."""
    calls = []
    real = tpipe.warp_batched

    def spy(*a, **kw):
        calls.append(a[6])
        return real(*a, **kw)

    monkeypatch.setattr(tpipe, "warp_batched", spy)
    from imagestitch_tpu_torch.types import CameraParams
    cams = CameraParams(
        focal=torch.full((2,), F), aspect=torch.ones(2),
        ppx=torch.full((2,), W / 2), ppy=torch.full((2,), H / 2),
        R=torch.as_tensor(np.stack([np.eye(3, dtype=np.float32), R])),
        t=torch.zeros(2, 3))
    cfg = tpipe.PipelineConfig().replace(
        warp=tpipe.PipelineConfig().warp.__class__(kind=kind))
    imgs = torch.as_tensor(np.stack([_image(4), _image(5)]))
    warped, masks, *_ = tpipe._warp_all_shared(
        imgs, cams, torch.tensor(F), (130, 270), cfg)
    assert calls == ([kind] if kind in ("cylindrical", "spherical", "plane")
                     else [])
    assert warped.shape == (2, 130, 270, 3) and masks[1].sum() > 0
