"""imagestitch_tpu_torch warp: the plain version of the warp kernel
against the JAX package's XLA warp path (`warp_image(use_pallas=False)`)
for the three ported projectors, the shared-canvas `_warp_all_shared`
(mixed sizes included), and the warp's image ops. On the CPU,
`warp_image`'s default route is its plain path (the inputs the kernel
route converts: a gray image, uint8, a strided view, a scale as a number
or a tensor, a canvas smaller than the ROI), `use_kernel=True` raises,
and `ops.cuda_warp.warp` is `warp_batched` on a batch of one; none of
them builds the kernel library.

Tolerances: masks may differ only on pixels whose source coordinate sits
within 1e-3 px of the image border (float32 rounding of sin/cos/divide
differs between the two libraries in the last bit); values agree within
5e-3 intensity where both are valid (a last-bit coordinate difference,
~8e-6 px at x = 80, times intensity steps of up to 255 per pixel).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from imagestitch_tpu import pipeline as jpipe  # noqa: E402
from imagestitch_tpu.config import PipelineConfig as JCfg  # noqa: E402
from imagestitch_tpu.ops.image import dilate as j_dilate  # noqa: E402
from imagestitch_tpu.ops.image import remap_bilinear as j_remap  # noqa
from imagestitch_tpu.types import CameraParams as JCams  # noqa: E402
from imagestitch_tpu.warp.warper import roi_bounds as j_roi  # noqa: E402
from imagestitch_tpu.warp.warper import warp_image as j_warp  # noqa: E402
from imagestitch_tpu_torch import pipeline as tpipe  # noqa: E402
from imagestitch_tpu_torch.convert import (cameras_from_numpy,  # noqa: E402
                                           config_from_dict)
from imagestitch_tpu_torch.ops import cuda_build, cuda_warp  # noqa: E402
from imagestitch_tpu_torch.ops.image import dilate, remap_bilinear  # noqa
from imagestitch_tpu_torch.warp.warper import roi_bounds, warp_image  # noqa

torch.set_num_threads(2)

KINDS = ["cylindrical", "spherical", "plane"]
H, W = 60, 80


def _rot(yaw, pitch, roll):
    cy, sy = np.cos(yaw), np.sin(yaw)
    cx, sx = np.cos(pitch), np.sin(pitch)
    cz, sz = np.cos(roll), np.sin(roll)
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Rx @ Ry


def _cams(sizes):
    """Two cameras 12 degrees of yaw apart, numpy fields."""
    sizes = np.asarray(sizes, np.float32)
    R = np.stack([_rot(-0.1, 0.0, 0.0), _rot(0.11, 0.02, 0.03)])
    return dict(focal=np.full(2, 90.0, np.float32),
                aspect=np.ones(2, np.float32),
                ppx=0.5 * sizes[:, 1], ppy=0.5 * sizes[:, 0],
                R=R.astype(np.float32), t=np.zeros((2, 3), np.float32))


def _images(seed, n=2, h=H, w=W):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 255, (n, h, w, 3)).astype(np.float32)


def _near_border(xs, ys, h, w):
    d = np.minimum.reduce([np.abs(xs), np.abs(xs - (w - 1)), np.abs(ys),
                           np.abs(ys - (h - 1))])
    return d < 1e-3


def _source_coords(K, R, scale, corner, canvas, kind):
    """float64 backward map of every canvas pixel (for the border test)."""
    Kf, Rf = np.asarray(K, np.float64), np.asarray(R, np.float64)
    M = Kf @ np.linalg.inv(Rf)
    v, u = np.mgrid[0:canvas[0], 0:canvas[1]].astype(np.float64)
    u = (u + corner[0]) / scale
    v = (v + corner[1]) / scale
    if kind == "cylindrical":
        X, Y, Z = np.sin(u), v, np.cos(u)
    elif kind == "spherical":
        X, Y, Z = (np.sin(np.pi - v) * np.sin(u), np.cos(np.pi - v),
                   np.sin(np.pi - v) * np.cos(u))
    else:
        X, Y, Z = u, v, np.ones_like(u)
    p = np.einsum("ij,jhw->ihw", M, np.stack([X, Y, Z]))
    return p[0] / p[2], p[1] / p[2]


def _assert_warp_close(out_t, val_t, out_j, val_j, xs, ys, h, w):
    mism = val_t != val_j
    assert not (mism & ~_near_border(xs, ys, h, w)).any()
    both = val_t & val_j
    assert both.sum() > 0.2 * both.size
    np.testing.assert_allclose(out_t[both], out_j[both], atol=5e-3)
    assert np.all(out_t[~val_t] == 0)


@pytest.mark.parametrize("kind", KINDS)
def test_warp_image_matches_jax_xla_path(kind):
    img = _images(1, 1)[0]
    c = _cams([(H, W)] * 2)
    K = np.array([[90.0, 0, W / 2], [0, 90.0, H / 2], [0, 0, 1]], np.float32)
    R = c["R"][1]
    canvas = (90, 140)
    rj = j_warp(jnp.asarray(img), jnp.asarray(K), jnp.asarray(R), 90.0,
                canvas, kind, use_pallas=False)
    rt = warp_image(torch.as_tensor(img), torch.as_tensor(K),
                    torch.as_tensor(R), 90.0, canvas, kind)
    corner = np.asarray(rj.corner)
    assert np.array_equal(rt.corner.numpy(), corner)
    xs, ys = _source_coords(K, R, 90.0, corner, canvas, kind)
    _assert_warp_close(rt.image.numpy(), rt.mask.numpy(),
                       np.asarray(rj.image), np.asarray(rj.mask), xs, ys,
                       H, W)


def _no_library(monkeypatch):
    def boom():
        raise AssertionError("kernel library requested for a CPU tensor")
    monkeypatch.setattr(cuda_build, "load_library", boom)


def _yaw_case(case):
    """(numpy image as the JAX package gets it, the port's tensor, scale
    as the port gets it, canvas) for one input variant."""
    img = _images(7, 1)[0]
    scale, canvas = 90.0, (90, 140)
    if case == "gray":
        img = img[..., 0]
    elif case == "uint8":
        img = np.round(img).astype(np.uint8)
    elif case == "scale_0d":
        scale = torch.tensor(90.0)
    elif case == "scale_1":
        scale = torch.tensor([90.0])
    elif case == "small_canvas":
        canvas = (24, 30)
    t = torch.as_tensor(img)
    if case == "strided":
        t = torch.as_tensor(np.ascontiguousarray(
            img.transpose(1, 0, 2))).permute(1, 0, 2)
        assert not t.is_contiguous()
    return img, t, scale, canvas


@pytest.mark.parametrize("case", ["rgb", "gray", "uint8", "strided",
                                  "scale_0d", "scale_1", "small_canvas"])
@pytest.mark.parametrize("kind", KINDS + ["mercator"])
def test_warp_image_default_route_on_cpu(monkeypatch, kind, case):
    """use_kernel=None on a CPU tensor is the plain path (use_kernel=False)
    bit for bit, and agrees with the JAX package's XLA path."""
    _no_library(monkeypatch)
    img, t, scale, canvas = _yaw_case(case)
    c = _cams([(H, W)] * 2)
    K = np.array([[90.0, 0, W / 2], [0, 90.0, H / 2], [0, 0, 1]], np.float32)
    R = c["R"][1]
    Kt, Rt = torch.as_tensor(K), torch.as_tensor(R)
    n0 = cuda_warp.launch_count
    rd = warp_image(t, Kt, Rt, scale, canvas, kind)
    rp = warp_image(t, Kt, Rt, scale, canvas, kind, use_kernel=False)
    assert cuda_warp.launch_count == n0
    for f in ("image", "mask", "corner", "size"):
        assert torch.equal(getattr(rd, f), getattr(rp, f)), f
    rj = j_warp(jnp.asarray(img), jnp.asarray(K), jnp.asarray(R), 90.0,
                canvas, kind, use_pallas=False)
    assert np.array_equal(rd.corner.numpy(), np.asarray(rj.corner))
    assert np.array_equal(rd.size.numpy(), np.asarray(rj.size))
    assert rd.image.shape == rj.image.shape
    if kind in KINDS:
        xs, ys = _source_coords(K, R, 90.0, np.asarray(rj.corner), canvas,
                                kind)
        _assert_warp_close(rd.image.numpy(), rd.mask.numpy(),
                           np.asarray(rj.image), np.asarray(rj.mask), xs,
                           ys, H, W)


@pytest.mark.parametrize("extra", [{}, {"interp": "nearest"},
                                   {"mask": True}, {"kind": "mercator"}],
                         ids=["linear", "nearest", "mask", "mercator"])
def test_warp_image_use_kernel_true_raises_on_cpu(monkeypatch, extra):
    """The kernel has no CPU mode: use_kernel=True on a CPU tensor raises,
    whatever the case, and launches nothing."""
    _no_library(monkeypatch)
    img = torch.as_tensor(_images(8, 1)[0])
    K = torch.tensor([[90.0, 0, W / 2], [0, 90.0, H / 2], [0, 0, 1]])
    kw = dict(extra)
    if kw.pop("mask", False):
        kw["mask"] = torch.ones((H, W), dtype=torch.bool)
    n0 = cuda_warp.launch_count
    with pytest.raises(ValueError, match="CUDA"):
        warp_image(img, K, torch.eye(3), 90.0, (90, 140), use_kernel=True,
                   **kw)
    assert cuda_warp.launch_count == n0


@pytest.mark.parametrize("channels", [None, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_warp_one_image_is_a_batch_of_one(monkeypatch, kind, channels):
    """`ops.cuda_warp.warp` on the CPU equals `warp_batched` on a batch of
    one, gray or colour, with the scale as a number or a tensor."""
    _no_library(monkeypatch)
    img = _images(9, 1)[0]
    img = torch.as_tensor(img if channels else img[..., 0])
    c = _cams([(H, W)] * 2)
    K = torch.tensor([[90.0, 0, W / 2], [0, 90.0, H / 2], [0, 0, 1]])
    R = torch.as_tensor(c["R"][1])
    k_rinv = K @ torch.linalg.inv(R)
    roi = torch.stack(roi_bounds(K, R, 90.0, (H, W), kind))
    corner = torch.floor(roi[:2]).to(torch.int32)
    for scale in (90.0, torch.tensor(90.0)):
        out, valid = cuda_warp.warp(img, k_rinv, scale, corner, roi,
                                    (90, 140), kind)
        ob, vb = cuda_warp.warp_batched(img[None], k_rinv[None], scale,
                                        corner[None], roi[None], (90, 140),
                                        kind)
        assert torch.equal(out, ob[0]) and torch.equal(valid, vb[0])
        assert out.shape == (90, 140) + tuple(img.shape[2:])
        assert bool(valid.any())


@pytest.mark.parametrize("kind", KINDS)
def test_roi_bounds_match_jax(kind):
    c = _cams([(H, W)] * 2)
    K = np.array([[90.0, 0, 40], [0, 90.0, 30], [0, 0, 1]], np.float32)
    bj = np.asarray(j_roi(jnp.asarray(K), jnp.asarray(c["R"][1]), 90.0,
                          (H, W), kind))
    bt = torch.stack(roi_bounds(torch.as_tensor(K),
                                torch.as_tensor(c["R"][1]), 90.0, (H, W),
                                kind)).numpy()
    np.testing.assert_allclose(bt, bj, rtol=2e-6, atol=2e-5)


@pytest.mark.parametrize("mixed", [False, True], ids=["same", "mixed"])
def test_warp_all_shared_matches_jax(mixed):
    """The shared-frame warp of both images in one call, against the JAX
    package's XLA path; `mixed` pads the second image from 52x70 back to
    60x80 by edge replication with its true size passed as data."""
    imgs = _images(2)
    sizes = np.asarray([[H, W], [52, 70]] if mixed else [[H, W], [H, W]],
                       np.int32)
    if mixed:
        small = imgs[1, :52, :70]
        imgs[1] = np.pad(small, ((0, 8), (0, 10), (0, 0)), mode="edge")
    c = _cams(sizes)
    jc = JCfg()
    canvas = jpipe._pano_canvas_shape((H, W), 2, jc)
    src_sizes = sizes if mixed else None
    wj, mj, cj, oj, rj = jpipe._warp_all_shared(
        jnp.asarray(imgs), JCams(**{k: jnp.asarray(v) for k, v in c.items()}),
        jnp.float32(90.0), canvas, jc, src_sizes=src_sizes)
    tc = config_from_dict(dataclasses.asdict(jc))
    wt, mt, ct, ot, rt = tpipe._warp_all_shared(
        torch.as_tensor(imgs), cameras_from_numpy(c),
        torch.tensor(90.0), canvas, tc, src_sizes=src_sizes)
    assert np.array_equal(ct.numpy(), np.asarray(cj))
    assert bool(ot) == bool(oj)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=2e-6,
                               atol=2e-5)
    for i in range(2):
        K = np.array([[90.0, 0, c["ppx"][i]], [0, 90.0, c["ppy"][i]],
                      [0, 0, 1]])
        xs, ys = _source_coords(K, c["R"][i], 90.0, np.asarray(cj), canvas,
                                "cylindrical")
        _assert_warp_close(wt[i].numpy(), mt[i].numpy(),
                           np.asarray(wj[i]), np.asarray(mj[i]), xs, ys,
                           *sizes[i])


def test_remap_bilinear_matches_jax():
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 255, (30, 40, 3)).astype(np.float32)
    xm = rng.uniform(-2, 42, (25, 35)).astype(np.float32)
    ym = rng.uniform(-2, 32, (25, 35)).astype(np.float32)
    oj, vj = j_remap(jnp.asarray(img), jnp.asarray(xm), jnp.asarray(ym))
    ot, vt = remap_bilinear(torch.as_tensor(img), torch.as_tensor(xm),
                            torch.as_tensor(ym))
    assert np.array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-4)


@pytest.mark.parametrize("k", [3, 20])
def test_dilate_asymmetric_padding_matches_jax(k):
    rng = np.random.default_rng(k)
    m = (rng.uniform(size=(2, 50, 61)) > 0.97).astype(np.float32)
    dj = np.asarray(jax.vmap(lambda a: j_dilate(a, (k, k)))(jnp.asarray(m)))
    dt = dilate(torch.as_tensor(m), (k, k)).numpy()
    assert np.array_equal(dt, dj)
