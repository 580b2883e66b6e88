"""imagestitch_tpu_torch kernels on a CUDA card: each hand-written kernel
against its plain version on the same inputs, and a small stitch on the
card against the same stitch on the CPU. The kernels have no CPU mode, so
every test here skips without a card. This file imports no JAX, so it
also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from imagestitch_tpu_torch import (BlendConfig, DetectorConfig,  # noqa
                                   MatcherConfig, PipelineConfig,
                                   SeamConfig, WarpConfig, stitch_pair,
                                   stitch_pairs_batched)
from imagestitch_tpu_torch.convert import cameras_from_numpy  # noqa: E402
from imagestitch_tpu_torch.geometry import bundle  # noqa: E402
from imagestitch_tpu_torch import pipeline  # noqa: E402
from imagestitch_tpu_torch.ops import (cuda_crop, cuda_detect,  # noqa: E402
                                       cuda_dp, cuda_lm, cuda_sift,
                                       cuda_slab_probe, cuda_warp)
from imagestitch_tpu_torch.ops import slab_probe  # noqa: E402
from imagestitch_tpu_torch.seam import dp  # noqa: E402
from imagestitch_tpu_torch.pipeline import (_pano_canvas_shape,  # noqa
                                            warp_inputs)
from imagestitch_tpu_torch.utils import log  # noqa: E402
from imagestitch_tpu_torch.utils.io import synthetic_rotation_pair  # noqa
from imagestitch_tpu_torch.testing import (bundle_problem,  # noqa: E402
                                           near_validity_boundary)
from imagestitch_tpu_torch.warp.warper import warp_batched_plain  # noqa

from test_torch_crop_dispatch import MASKS as CROP_MASKS  # noqa: E402
from test_torch_crop_dispatch import canvas as crop_canvas  # noqa: E402
from test_torch_crop_dispatch import mask as crop_mask  # noqa: E402

torch.set_num_threads(2)

CONTRAST = 0.04 * 255.0 / 3      # the default SIFT contrast on 0..255


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(2, 100, 150), (2, 97, 131),
                                   (1, 378, 672)])
def test_detect_kernel_matches_plain(cuda, shape):
    """FAST/NMS equal everywhere, Harris within 1e-4·max|Harris| and the
    blur within 1e-3 intensity (the chip_smoke.py tolerances)."""
    rng = np.random.default_rng(sum(shape))
    img = torch.as_tensor(rng.uniform(0, 255, shape).astype(np.float32),
                          device=cuda)
    k = cuda_detect.detect_maps_cuda(img, 20.0)
    p = cuda_detect.detect_maps_plain(img, 20.0)
    assert torch.equal(k[0], p[0])
    assert float((k[1] - p[1]).abs().max()) <= \
        1e-4 * float(p[1].abs().max())
    assert float((k[2] - p[2]).abs().max()) <= 1e-3


@pytest.mark.parametrize("ksize,sigma", [(1, 1.0), (3, 0.8), (5, 1.5),
                                         (7, 1.2)])
def test_detect_kernel_blur_sizes_match_plain(cuda, ksize, sigma):
    """The blur at other odd sizes up to the kernel's 7 and other sigmas
    (the taps centred, zeros around them): within 1e-3 intensity of the
    plain version; FAST/NMS and Harris do not depend on it."""
    rng = np.random.default_rng(ksize)
    img = torch.as_tensor(rng.uniform(0, 255, (2, 97, 131)).astype(
        np.float32), device=cuda)
    k = cuda_detect.detect_maps(img, 20.0, ksize=ksize, sigma=sigma)
    p = cuda_detect.detect_maps_plain(img, 20.0, ksize=ksize, sigma=sigma)
    assert torch.equal(k[0], p[0])
    assert float((k[2] - p[2]).abs().max()) <= 1e-3
    with pytest.raises(ValueError, match="ksize"):
        cuda_detect.detect_maps(img, 20.0, ksize=9)


def _detect_images(image, batch):
    """(batch, 97, 131) float32: seeded noise, a constant, or a
    checkerboard of 4-pixel cells (FAST's arcs tie)."""
    if image == "constant":
        return np.full((batch, 97, 131), 77.0, np.float32)
    if image == "checker":
        yy, xx = np.indices((97, 131))
        cells = ((yy // 4 + xx // 4) % 2 * 180.0 + 30.0).astype(np.float32)
        return np.stack([cells + 5.0 * b for b in range(batch)])
    rng = np.random.default_rng(batch)
    return rng.uniform(0, 255, (batch, 97, 131)).astype(np.float32)


@pytest.mark.parametrize("threshold", [0.0, 20.0])
@pytest.mark.parametrize("block_size", [3, 5, 7])
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("image", ["noise", "constant", "checker"])
def test_detect_levels_kernel_matches_plain(cuda, image, batch, block_size,
                                            threshold):
    """One launch for a 5-level 1.3 pyramid of a 97x131 image (its two
    smallest levels are smaller than one tile): per level FAST/NMS equal,
    Harris within 1e-4·max|Harris| and the blur within 1e-3 intensity."""
    from imagestitch_tpu_torch.ops.pyramid import build_pyramid
    img = torch.as_tensor(_detect_images(image, batch), device=cuda)
    pyr = [lv.contiguous() for lv in build_pyramid(img, 5, 1.3)]
    n0 = cuda_detect.launch_count
    got = cuda_detect.detect_maps_levels(pyr, threshold, block_size)
    assert cuda_detect.launch_count == n0 + 1
    for lv, k in zip(pyr, got):
        p = cuda_detect.detect_maps_plain(lv, threshold, block_size)
        assert all(m.shape == lv.shape for m in k)
        assert torch.equal(k[0], p[0])
        assert float((k[1] - p[1]).abs().max()) <= \
            1e-4 * float(p[1].abs().max())
        assert float((k[2] - p[2]).abs().max()) <= 1e-3


def test_detect_levels_batch_of_views_equals_one_view_launches(cuda):
    """One launch for 8 views' 5-level pyramids (the chain's batched
    detect): each view's three maps on every level equal, bit for bit,
    a launch for that view alone."""
    from imagestitch_tpu_torch.ops.pyramid import build_pyramid
    rng = np.random.default_rng(8)
    img = torch.as_tensor(rng.uniform(0, 255, (8, 270, 480)).astype(
        np.float32), device=cuda)
    pyr = [lv.contiguous() for lv in build_pyramid(img, 5, 1.3)]
    n0 = cuda_detect.launch_count
    got = cuda_detect.detect_maps_levels(pyr, 20.0)
    assert cuda_detect.launch_count == n0 + 1
    for b in range(8):
        one = cuda_detect.detect_maps_levels(
            [lv[b:b + 1].contiguous() for lv in pyr], 20.0)
        for lv_maps, lv_one in zip(got, one):
            for m, m1 in zip(lv_maps, lv_one):
                assert torch.equal(m[b], m1[0])


def test_detect_levels_work_scale_batch_matches_plain(cuda):
    """The detailed path's K1 launch: four views at the 0.6-megapixel work
    scale of 1080x1920 (581x1033) and their five 1.3 levels in one launch,
    each level against the plain version (FAST/NMS equal, Harris within
    1e-4·max|Harris|, the blur within 1e-3)."""
    from imagestitch_tpu_torch.ops.pyramid import build_pyramid
    rng = np.random.default_rng(581)
    img = torch.as_tensor(rng.uniform(0, 255, (4, 581, 1033)).astype(
        np.float32), device=cuda)
    pyr = [lv.contiguous() for lv in build_pyramid(img, 5, 1.3)]
    n0 = cuda_detect.launch_count
    maps = cuda_detect.detect_maps_levels(pyr, 20.0)
    assert cuda_detect.launch_count == n0 + 1
    for lv, k in zip(pyr, maps):
        p = cuda_detect.detect_maps_plain(lv, 20.0)
        assert torch.equal(k[0], p[0])
        assert float((k[1] - p[1]).abs().max()) <= \
            1e-4 * float(p[1].abs().max())
        assert float((k[2] - p[2]).abs().max()) <= 1e-3


def test_detect_levels_wrapper_launches_only_the_kernel(cuda):
    """A detect_maps_levels call over a 5-level pyramid runs exactly one
    CUDA kernel, the detector maps, and no copy or fill."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from imagestitch_tpu_torch.ops.pyramid import build_pyramid
    img = torch.as_tensor(_detect_images("noise", 1), device=cuda)
    pyr = [lv.contiguous() for lv in build_pyramid(img, 5, 1.3)]
    cuda_detect.detect_maps_levels(pyr, 20.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            cuda_detect.detect_maps_levels(pyr, 20.0)
        torch.cuda.synchronize()
    dev_events = [e.name for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
    assert len(dev_events) == 3, dev_events
    assert all("detect_maps_kernel" in name for name in dev_events), \
        dev_events


@pytest.mark.parametrize("shape,first", [((96, 160), True),
                                         ((67, 121), False)],
                         ids=["first", "later"])
def test_sift_octave_kernel_matches_plain(cuda, shape, first):
    """dog, score, gx, gy and gS within 1e-4 of the plain version and the
    same nonzero score support (the chip_smoke.py tolerances)."""
    rng = np.random.default_rng(sum(shape))
    cells = rng.uniform(0, 255, (shape[0] // 8 + 1, shape[1] // 8 + 1))
    img = np.kron(cells, np.ones((8, 8)))[:shape[0], :shape[1]]
    base = torch.as_tensor(img.astype(np.float32), device=cuda)
    n0 = cuda_sift.launch_count
    k = cuda_sift.sift_octave_maps_cuda(base, first, 3, 1.6, CONTRAST)
    p = cuda_sift.sift_octave_maps_plain(base, first, 3, 1.6, CONTRAST)
    assert cuda_sift.launch_count == n0 + 1
    for a, b in zip(k, p):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-4
    assert torch.equal(k[1] > 0, p[1] > 0)
    assert int((p[1] > 0).sum()) > 0


def _sift_image(image, shape):
    """(H, W) float32: 8x8 cells of seeded intensity, seeded noise, a
    constant, or a checkerboard of 4-pixel cells."""
    rng = np.random.default_rng(sum(shape))
    if image == "cells":
        cells = rng.uniform(0, 255, (shape[0] // 8 + 1, shape[1] // 8 + 1))
        img = np.kron(cells, np.ones((8, 8)))[:shape[0], :shape[1]]
    elif image == "noise":
        img = rng.uniform(0, 255, shape)
    elif image == "constant":
        img = np.full(shape, 77.0)
    else:
        yy, xx = np.indices(shape)
        img = (yy // 4 + xx // 4) % 2 * 180.0 + 30.0
    return np.ascontiguousarray(img, np.float32)


def _hold_sift(k, p, S=3):
    """All five maps within 1e-4 of the plain version, of its shapes, and
    the same nonzero score support."""
    assert len(k) == 5 and k[1].shape[0] == S
    for a, b in zip(k, p):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-4
    assert torch.equal(k[1] > 0, p[1] > 0)


@pytest.mark.parametrize("shape", [(8, 9), (20, 33), (31, 65), (67, 121),
                                   (96, 160), (135, 240)])
@pytest.mark.parametrize("first", [True, False], ids=["first", "later"])
@pytest.mark.parametrize("image", ["cells", "noise", "constant", "checker"])
def test_sift_octave_kernel_cases_match_plain(cuda, shape, first, image):
    """The octave-maps kernel at shapes smaller than one tile and no
    multiples of it, and at the 1080p path's last octave (135x240), on
    first and later octaves and four images: one launch, within 1e-4 in
    all five maps, the same score support."""
    base = torch.as_tensor(_sift_image(image, shape), device=cuda)
    n0 = cuda_sift.launch_count
    k = cuda_sift.sift_octave_maps_cuda(base, first, 3, 1.6, CONTRAST)
    assert cuda_sift.launch_count == n0 + 1
    p = cuda_sift.sift_octave_maps_plain(base, first, 3, 1.6, CONTRAST)
    _hold_sift(k, p)
    if image == "cells" and min(shape) > 2 * cuda_sift.BORDER + 8:
        assert int((p[1] > 0).sum()) > 0


@pytest.mark.parametrize("variant", range(len(cuda_sift.TILES)))
@pytest.mark.parametrize("first", [True, False], ids=["first", "later"])
def test_sift_octave_kernel_tile_variants_match_plain(cuda, variant, first):
    """Every tile variant of the kernel on a 135x240 octave and on one
    smaller than its tile."""
    for shape in [(135, 240), (45, 77)]:
        base = torch.as_tensor(_sift_image("cells", shape), device=cuda)
        k = cuda_sift._launch(base, first, 3, 1.6, CONTRAST,
                              cuda_sift.EDGE_RATIO, variant)
        p = cuda_sift.sift_octave_maps_plain(base, first, 3, 1.6, CONTRAST)
        _hold_sift(k, p)


@pytest.mark.parametrize("S,sigma0", [(1, 1.6), (2, 1.6), (4, 1.6),
                                      (5, 1.6), (6, 1.6), (3, 3.2),
                                      (6, 6.4)])
@pytest.mark.parametrize("first", [True, False], ids=["first", "later"])
def test_sift_octave_kernel_scales_match_plain(cuda, S, sigma0, first):
    """Other scales per octave and wider blurs, up to the widest halos the
    kernel takes (S = 6 at sigma0 = 6.4: 60 px on the first octave)."""
    base = torch.as_tensor(_sift_image("cells", (90, 150)), device=cuda)
    k = cuda_sift.sift_octave_maps_cuda(base, first, S, sigma0, CONTRAST)
    p = cuda_sift.sift_octave_maps_plain(base, first, S, sigma0, CONTRAST)
    _hold_sift(k, p, S)


def test_sift_octave_kernel_raises_on_what_it_does_not_take(cuda):
    """Seven scales, an octave of 7 rows, a strided view."""
    base = torch.as_tensor(_sift_image("noise", (64, 64)), device=cuda)
    with pytest.raises(ValueError):
        cuda_sift.sift_octave_maps_cuda(base, True, 7)
    with pytest.raises(ValueError):
        cuda_sift.sift_octave_maps_cuda(base[:7].contiguous(), True)
    with pytest.raises(ValueError):
        cuda_sift.sift_octave_maps_cuda(base[:, ::2], True)


def test_sift_octave_wrapper_launches_only_the_kernel(cuda):
    """A sift_octave_maps_cuda call runs exactly one CUDA kernel, the
    octave maps, and no copy or fill: the first octave and a later one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    base = torch.as_tensor(_sift_image("cells", (135, 240)), device=cuda)
    cuda_sift.sift_octave_maps_cuda(base, True, 3, 1.6, CONTRAST)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for first in (True, False, True):
            cuda_sift.sift_octave_maps_cuda(base, first, 3, 1.6, CONTRAST)
        torch.cuda.synchronize()
    dev_events = [e.name for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
    assert len(dev_events) == 3, dev_events
    assert all("sift_octave_kernel" in name for name in dev_events), \
        dev_events


@pytest.mark.parametrize("kind", ["cylindrical", "spherical", "plane"])
@pytest.mark.parametrize("mixed", [False, True], ids=["same", "mixed"])
def test_warp_kernel_matches_plain(cuda, kind, mixed):
    """Masks differ on at most 0.1% of the canvas (pixels at the image
    border); values within 1e-2 where both are valid."""
    h, w = 60, 80
    rng = np.random.default_rng(7)
    imgs = torch.as_tensor(rng.uniform(0, 255, (2, h, w, 3)).astype(
        np.float32), device=cuda)
    sizes = np.asarray([[h, w], [52, 70]] if mixed else [[h, w]] * 2,
                       np.int32)
    yaw = np.array([-0.1, 0.11])
    R = np.stack([[[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                   [-np.sin(a), 0, np.cos(a)]] for a in yaw])
    cams = cameras_from_numpy(dict(
        focal=np.full(2, 90.0), aspect=np.ones(2), ppx=sizes[:, 1] / 2,
        ppy=sizes[:, 0] / 2, R=R, t=np.zeros((2, 3))), device=cuda)
    cfg = PipelineConfig(warp=WarpConfig(kind=kind))
    canvas = _pano_canvas_shape((h, w), 2, cfg)
    scale = torch.tensor(90.0, device=cuda)
    src_sizes = sizes if mixed else None
    kr, corner, roi, _ = warp_inputs(cams, scale, (h, w), 2, canvas, cfg,
                                     src_sizes)
    args = (imgs, kr, scale, corner.expand(2, 2), roi, canvas, kind,
            src_sizes)
    ok, vk = cuda_warp.warp_batched_cuda(*args)
    op, vp = warp_batched_plain(*args)
    assert float((vk != vp).float().mean()) < 1e-3
    both = vk & vp
    assert bool(both.any())
    assert float((ok - op).abs()[both].max()) <= 1e-2


def _yaw_warp_args(dev, n, h, w, c, canvas=None, shift=(0, 0),
                   kind="cylindrical", focal=None, spread=0.1):
    """Seeded (n, h, w[, c]) images (c = 1: (n, h, w)) under cameras
    spread in yaw over ±`spread` rad; the canvas defaults to the
    pipeline's, and `shift` moves the canvas origin up and left of the
    ROIs' union."""
    rng = np.random.default_rng(n * 1000 + h + c)
    shape = (n, h, w) if c == 1 else (n, h, w, c)
    imgs = torch.as_tensor(rng.uniform(0, 255, shape).astype(np.float32),
                           device=dev)
    focal = focal or 1.5 * w
    yaw = np.linspace(-spread, spread, n) if n > 1 else np.zeros(1)
    R = np.stack([[[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                   [-np.sin(a), 0, np.cos(a)]] for a in yaw])
    cams = cameras_from_numpy(dict(
        focal=np.full(n, focal), aspect=np.ones(n), ppx=np.full(n, w / 2),
        ppy=np.full(n, h / 2), R=R, t=np.zeros((n, 3))), device=dev)
    cfg = PipelineConfig(warp=WarpConfig(kind=kind))
    canvas = canvas or _pano_canvas_shape((h, w), n, cfg)
    scale = torch.tensor(float(focal), device=dev)
    kr, corner, roi, _ = warp_inputs(cams, scale, (h, w), n, canvas, cfg)
    corner = corner - torch.tensor(shift, dtype=torch.int32, device=dev)
    return imgs, kr, scale, corner.expand(n, 2), roi, canvas, kind


@pytest.mark.parametrize("case", [
    dict(n=2, h=60, w=80, c=1),
    dict(n=1, h=60, w=80, c=3),
    dict(n=3, h=60, w=80, c=3),
    dict(n=2, h=60, w=80, c=3, canvas=(97, 167)),
    dict(n=2, h=60, w=80, c=1, canvas=(97, 171), kind="spherical"),
    dict(n=2, h=60, w=80, c=3, canvas=(256, 700), shift=(200, 80)),
    dict(n=2, h=60, w=80, c=3, canvas=(256, 701), shift=(200, 80),
         kind="plane"),
    dict(n=2, h=1080, w=1920, c=3, canvas=(1458, 4032), focal=1728.0),
    dict(n=8, h=1080, w=1920, c=3, canvas=(1458, 16704), focal=1728.0,
         spread=1.9),
    dict(n=4, h=1080, w=1920, c=3, canvas=(1458, 8256), focal=1728.0,
         spread=0.27, kind="spherical"),
], ids=["c1", "n1", "n3", "wc167", "c1_wc171_spherical", "outside_roi",
        "outside_roi_wc701_plane", "main_1080p", "chain8_1080p",
        "detailed4_spherical"])
def test_warp_kernel_cases_match_plain(cuda, case):
    """The warp kernel against its plain version: one channel, one and
    three images, canvases whose width is no multiple of 4 (unaligned
    rows), canvases with whole 128x16 tiles outside every ROI, and the
    main path's 1080p shapes, and the 8-view 1080p chain's canvas (2.3 GB
    of output, 584 M values). Masks equal except within 1e-3 px of the
    validity boundary; values within 1e-2 where both are valid; zeros
    wherever the kernel's mask is false; one launch."""
    imgs, kr, scale, corners, roi, canvas, kind = _yaw_warp_args(cuda,
                                                                 **case)
    n0 = cuda_warp.launch_count
    ok, vk = cuda_warp.warp_batched_cuda(imgs, kr, scale, corners, roi,
                                         canvas, kind)
    assert cuda_warp.launch_count == n0 + 1
    x = imgs[..., None] if imgs.ndim == 3 else imgs
    op, vp = warp_batched_plain(x, kr, scale, corners, roi, canvas, kind)
    if imgs.ndim == 3:
        op = op[..., 0]
    assert ok.shape == op.shape and vk.shape == vp.shape
    n, h, w = imgs.shape[:3]
    near = near_validity_boundary(kr, scale, corners, canvas, kind,
                                  [(h, w)] * n)
    assert int(((vk != vp) & ~near).sum()) == 0
    both = vk & vp
    assert bool(both.any())
    assert float((ok - op).abs()[both].max()) <= 1e-2
    dead = ~vk[..., None] if ok.ndim == 4 else ~vk
    assert float(ok.abs().masked_select(dead).max()) == 0.0
    if "shift" in case:       # whole tiles outside the ROI: all zero
        assert not bool(vk[:, :, :128].any())


def _warp_image_args(dev, case="rgb"):
    """One seeded 120x160 view under a camera yawed 0.12 rad, as
    `warp_image` takes it, with the variant of `case`."""
    rng = np.random.default_rng(11)
    img = rng.uniform(0, 255, (120, 160, 3)).astype(np.float32)
    if case == "gray":
        img = img[..., 0]
    elif case == "uint8":
        img = np.round(img).astype(np.uint8)
    img = torch.as_tensor(img, device=dev)
    if case == "strided":
        img = img.transpose(0, 1).contiguous().transpose(0, 1)
    a = 0.12
    K = torch.tensor([[200.0, 0, 80], [0, 200.0, 60], [0, 0, 1]],
                     device=dev)
    R = torch.tensor([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]], dtype=torch.float32,
                     device=dev)
    scale = {"scale_float": 200.0,
             "scale_1": torch.tensor([200.0], device=dev)}.get(
        case, torch.tensor(200.0, device=dev))
    canvas = (40, 60) if case == "small_canvas" else (150, 220)
    return img, K, R, scale, canvas


def _same_result(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("image", "mask", "corner", "size"))


@pytest.mark.parametrize("case", ["rgb", "gray", "uint8", "strided",
                                  "scale_float", "scale_1", "small_canvas"])
@pytest.mark.parametrize("kind", ["cylindrical", "spherical", "plane"])
def test_warp_image_launches_the_kernel_once(cuda, kind, case):
    """`warp_image` of a CUDA image takes the warp kernel (one launch) for
    the three kinds it carries and equals `use_kernel=False` on the card
    bit for bit, whatever the image's type, layout and scale."""
    from imagestitch_tpu_torch.warp.warper import warp_image
    img, K, R, scale, canvas = _warp_image_args(cuda, case)
    n0 = cuda_warp.launch_count
    rk = warp_image(img, K, R, scale, canvas, kind)
    assert cuda_warp.launch_count == n0 + 1
    rt = warp_image(img, K, R, scale, canvas, kind, use_kernel=True)
    assert cuda_warp.launch_count == n0 + 2
    rp = warp_image(img, K, R, scale, canvas, kind, use_kernel=False)
    assert cuda_warp.launch_count == n0 + 2
    assert _same_result(rk, rp) and _same_result(rt, rp)
    assert rk.image.shape == canvas + tuple(img.shape[2:])
    assert bool(rk.mask.any())


@pytest.mark.parametrize("extra", [{"interp": "nearest"}, {"mask": True},
                                   {"kind": "mercator"}],
                         ids=["nearest", "mask", "mercator"])
def test_warp_image_plain_where_the_kernel_does_not_carry(cuda, extra):
    """Nearest sampling, a source mask or a projector the kernel does not
    carry: the plain path on the card, no launch, with or without
    use_kernel=True."""
    from imagestitch_tpu_torch.warp.warper import warp_image
    img, K, R, scale, canvas = _warp_image_args(cuda)
    kw = dict(extra)
    if kw.pop("mask", False):
        kw["mask"] = torch.ones(img.shape[:2], dtype=torch.bool,
                                device=cuda)
    kw.setdefault("kind", "cylindrical")
    n0 = cuda_warp.launch_count
    rd = warp_image(img, K, R, scale, canvas, **kw)
    rt = warp_image(img, K, R, scale, canvas, use_kernel=True, **kw)
    rp = warp_image(img, K, R, scale, canvas, use_kernel=False, **kw)
    assert cuda_warp.launch_count == n0
    assert _same_result(rd, rp) and _same_result(rt, rp)


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("kind", ["cylindrical", "spherical", "plane"])
def test_one_image_warp_equals_a_batch_of_one(cuda, kind, channels):
    """`cuda_warp.warp` is one launch and equals `warp_batched` on a batch
    of one bit for bit."""
    imgs, kr, scale, corners, roi, canvas, _ = _yaw_warp_args(
        cuda, 1, 60, 80, channels, kind=kind)
    n0 = cuda_warp.launch_count
    out, valid = cuda_warp.warp(imgs[0], kr[0], scale, corners[0], roi[0],
                                canvas, kind)
    assert cuda_warp.launch_count == n0 + 1
    ob, vb = cuda_warp.warp_batched(imgs, kr, scale, corners, roi, canvas,
                                    kind)
    assert torch.equal(out, ob[0]) and torch.equal(valid, vb[0])


def test_warp_wrapper_launches_only_the_kernel(cuda):
    """On the main path (a 0-d scale tensor, corners as an expanded int32
    view, k_rinvs and roi_uvs from warp_inputs) a warp_batched_cuda call
    runs exactly one CUDA kernel, the warp, and no copy or fill."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    args = _yaw_warp_args(cuda, 2, 60, 80, 3)
    cuda_warp.warp_batched_cuda(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            cuda_warp.warp_batched_cuda(*args)
        torch.cuda.synchronize()
    dev_events = [e.name for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
    assert len(dev_events) == 3, dev_events
    assert all("warp_kernel" in name for name in dev_events), dev_events


@pytest.mark.parametrize("h", [16, 24, 32, 48])
@pytest.mark.parametrize("tiled", [False, True], ids=["planar", "tiled"])
def test_slab_probe_kernel_matches_plain(cuda, h, tiled):
    """The slab-load probe's tensor-map kernel equals its plain version bit
    for bit (the same float32 sums in chunk order) on a seeded 1080x1920x3
    source, one launch each. The output is the last step's sum, so every
    grid of 1-32 steps, and 100, 467 and the full 468, holds another step's
    eight origins against the plain version."""
    src = _probe_source(cuda, tiled)
    for steps in (*range(1, 33), 100, 467, slab_probe.STEPS):
        n0 = cuda_slab_probe.launch_count
        k = cuda_slab_probe.slab_probe_cuda(src, h, tiled, steps)
        assert cuda_slab_probe.launch_count == n0 + 1
        p = slab_probe.slab_probe_plain(src, h, tiled, steps)
        assert torch.equal(k, p)


def _probe_source(dev, tiled):
    rng = np.random.default_rng(0)
    planar = torch.as_tensor(rng.random((3, 1080, 1920)).astype(
        np.float32), device=dev)
    return slab_probe.to_tiled(planar) if tiled else planar


@pytest.mark.parametrize("h", [16, 48])
@pytest.mark.parametrize("tiled", [False, True], ids=["planar", "tiled"])
def test_slab_probe_persistent_grid_around_the_sm_count(cuda, h, tiled):
    """Grids of fewer steps than the card has multiprocessors (one block per
    step) and of more (one block per multiprocessor, uneven ranges that
    cross step boundaries): the kernel equals its plain version, one
    launch each."""
    src = _probe_source(cuda, tiled)
    sms = cuda_slab_probe.sm_count(cuda)
    for steps in (sms - 1, sms, sms + 1, 2 * sms + 3):
        assert cuda_slab_probe.probe_blocks(cuda, steps) == min(sms, steps)
        n0 = cuda_slab_probe.launch_count
        k = cuda_slab_probe.slab_probe_cuda(src, h, tiled, steps)
        assert cuda_slab_probe.launch_count == n0 + 1
        assert torch.equal(k, slab_probe.slab_probe_plain(src, h, tiled,
                                                          steps))


def test_slab_probe_wrapper_launches_only_the_kernel(cuda):
    """A slab_probe_cuda call runs exactly one CUDA kernel, the probe, and
    no copy or fill: the tensor map is encoded on the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    src = _probe_source(cuda, False)
    cuda_slab_probe.slab_probe_cuda(src, 48, False, 20)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            cuda_slab_probe.slab_probe_cuda(src, 48, False, 20)
        torch.cuda.synchronize()
    dev_events = [e.name for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
    assert len(dev_events) == 3, dev_events
    assert all("slab_probe_kernel" in name for name in dev_events), \
        dev_events


def test_l2_ceiling_kernels_run(cuda):
    """The L2 ceiling (bulk copies, whole 32 KB chunks) and the 16-byte-load
    reading (whole rounds of one block per multiprocessor) read at least
    the bytes asked for, less than one unit more, return finite block
    values, and raise on a source that is not on the card."""
    src = _probe_source(cuda, False)
    want = (64 << 20) + 4096
    sms = cuda_slab_probe.sm_count(cuda)
    for fn, unit in ((cuda_slab_probe.l2_ceiling_cuda, 32 << 10),
                     (cuda_slab_probe.l2_loads_cuda, sms * 1024 * 4 * 16)):
        vals, nbytes = fn(src, want)
        torch.cuda.synchronize()
        assert vals.shape == (sms,)
        assert bool(torch.isfinite(vals).all()) and float(vals.sum()) > 0
        assert want <= nbytes < want + unit and nbytes % unit == 0
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(src.cpu(), want)


@pytest.mark.parametrize("kind,launches", [("orb", (2, 0, 1)),
                                           ("sift", (0, 8, 1))])
def test_stitch_pair_on_card_matches_cpu_and_counts_launches(cuda, kind,
                                                             launches):
    """A 192x256 rotation pair stitched on the card and on the CPU with
    the same RANSAC draws: equal counts, focal within 1e-3, pano within 1
    intensity on average. The card's ORB stitch launched the detector-maps
    kernel twice (once per image, for all 5 levels) and the warp kernel
    once; its
    SIFT stitch called the octave-maps kernel 8 times (4 octaves x 2
    images) and the warp kernel once. Its bundle adjustment was one
    launch of the LM kernel (`lm_fused` 1); the CPU's the plain loop."""
    a, b, _, _ = synthetic_rotation_pair(192, 256)
    g = torch.Generator().manual_seed(1)
    draws = (torch.rand((2048, 4), generator=g),
             torch.rand((256, 4), generator=g))
    cfg = PipelineConfig(detector=DetectorConfig(kind=kind))
    cuda_detect.launch_count = 0
    cuda_sift.launch_count = 0
    cuda_warp.launch_count = 0
    lm0 = cuda_lm.launch_count
    pc, mc = stitch_pair(a, b, cfg, device=cuda, draws=draws)
    assert (cuda_detect.launch_count, cuda_sift.launch_count,
            cuda_warp.launch_count) == launches
    assert cuda_lm.launch_count == lm0 + 1
    assert mc["lm_fused"] == 1 and 1 <= mc["lm_iters"] <= 25
    pp, mp = stitch_pair(a, b, cfg, device="cpu", draws=draws)
    assert "lm_fused" not in mp and cuda_lm.launch_count == lm0 + 1
    for k in ("kpts1", "kpts2", "num_matches", "num_inliers", "h_valid"):
        assert mc[k] == mp[k], k
    assert abs(mc["focal"] - mp["focal"]) <= 1e-3 * mp["focal"]
    assert pc.shape == pp.shape
    assert np.abs(pc.astype(float) - pp.astype(float)).mean() < 1.0


def _counts():
    return (cuda_detect.launch_count, cuda_sift.launch_count,
            cuda_warp.launch_count)


@pytest.mark.parametrize("entry", ["stitch_chain", "stitch"])
def test_n_view_entry_on_card_matches_cpu_and_counts_launches(cuda, entry):
    """A 4-view 160x224 sequence through stitch_chain and stitch() on the
    card and on the CPU with the same RANSAC draws per pair, without
    bundle adjustment (on a near-pure translation the adjuster's stop
    moves by percents with float32 rounding): equal counts and reachable,
    focal within 1e-3, pano within 1 intensity on average. On the card
    each stitch launched the detector maps once (all 4 views' 5 levels)
    and the warp once."""
    from imagestitch_tpu_torch import CameraConfig, stitch, stitch_chain
    from imagestitch_tpu_torch.matching.matcher import pair_list
    from imagestitch_tpu_torch.utils.io import synthetic_sequence
    views, _ = synthetic_sequence(4, 160, 224, overlap=0.5, seed=9)
    g = torch.Generator().manual_seed(1)
    pairs = ([(i, i + 1) for i in range(3)] if entry == "stitch_chain"
             else pair_list(4))
    draws = {p: (torch.rand((2048, 4), generator=g),
                 torch.rand((256, 4), generator=g)) for p in pairs}
    fn = stitch_chain if entry == "stitch_chain" else stitch
    cfg = PipelineConfig(camera=CameraConfig(ba_refine=False))
    c0 = _counts()
    pc, mc = fn(views, cfg, device=cuda, draws=draws)
    assert tuple(b - a for a, b in zip(c0, _counts())) == (1, 0, 1)
    pp, mp = fn(views, cfg, device="cpu", draws=draws)
    assert _counts()[0] == c0[0] + 1
    keys = (("num_inliers", "h_valid", "reachable") if entry ==
            "stitch_chain" else ("reachable", "n_images"))
    for k in keys:
        assert mc[k] == mp[k], k
    assert all(mc["reachable"])
    assert abs(mc["focal"] - mp["focal"]) <= 1e-3 * mp["focal"]
    assert pc.shape == pp.shape
    assert np.abs(pc.astype(float) - pp.astype(float)).mean() < 1.0


def _batched_warp_args(dev, pairs, h, w, focal):
    """`pairs` pairs of seeded (h, w, 3) views, each pair under its own
    focal (so its own surface scale, its pair's median focal) and yaw
    spread (so its own canvas corner), into the pipeline's two-view
    canvas: one (2·pairs, ...) batch, scale (2·pairs,) one per view."""
    cfg = PipelineConfig()
    canvas = _pano_canvas_shape((h, w), 2, cfg)
    parts = [_yaw_warp_args(dev, 2, h, w, 3, canvas=canvas,
                            focal=focal * (1.0 + 0.02 * b),
                            spread=0.08 + 0.004 * b) for b in range(pairs)]
    scale = torch.stack([p[2] for p in parts]).repeat_interleave(2)
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]), scale,
            torch.cat([p[3] for p in parts]),
            torch.cat([p[4] for p in parts]), canvas, "cylindrical")


@pytest.mark.parametrize("case", [dict(pairs=8, h=1080, w=1920, focal=1728.0),
                                  dict(pairs=32, h=480, w=640, focal=576.0)],
                         ids=["pairs8_1080p", "pairs32_vga"])
def test_warp_kernel_per_image_scale_matches_plain(cuda, case):
    """K2 with one surface scale per view, at the batched shapes of
    stitch_pairs_batched (16 views into 1458x4032 canvases, 64 into
    648x1344), each pair with its own scale and corner: one launch; masks
    equal except within 1e-3 px of the validity boundary; values equal
    (max error 0) where both are valid; zeros where the kernel's mask is
    false."""
    imgs, kr, scale, corners, roi, canvas, kind = _batched_warp_args(
        cuda, **case)
    assert torch.unique(scale).numel() == case["pairs"]
    n0 = cuda_warp.launch_count
    ok, vk = cuda_warp.warp_batched_cuda(imgs, kr, scale, corners, roi,
                                         canvas, kind)
    assert cuda_warp.launch_count == n0 + 1
    op, vp = warp_batched_plain(imgs, kr, scale, corners, roi, canvas, kind)
    n, h, w = imgs.shape[:3]
    near = near_validity_boundary(kr, scale, corners, canvas, kind,
                                  [(h, w)] * n)
    assert int(((vk != vp) & ~near).sum()) == 0
    both = vk & vp
    assert bool(both.any())
    assert float((ok - op).abs()[both].max()) == 0.0
    assert float(ok.abs().masked_select(~vk[..., None]).max()) == 0.0


def test_warp_kernel_one_scale_bit_for_bit(cuda):
    """One scale given per view, as a number or as a one-element tensor:
    the same outputs, bit for bit; a scale of another length raises."""
    imgs, kr, scale, corners, roi, canvas, kind = _yaw_warp_args(
        cuda, 3, 60, 80, 3)
    ref = cuda_warp.warp_batched_cuda(imgs, kr, scale, corners, roi, canvas,
                                      kind)
    for s in (scale.expand(3).contiguous(), float(scale),
              scale.reshape(1).cpu(), scale.expand(3).cpu()):
        out = cuda_warp.warp_batched_cuda(imgs, kr, s, corners, roi, canvas,
                                          kind)
        assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    with pytest.raises(ValueError):
        cuda_warp.warp_batched_cuda(imgs, kr, scale.expand(2).contiguous(),
                                    corners, roi, canvas, kind)


def test_batched_pairs_on_card_match_cpu_and_count_launches(cuda):
    """stitch_pairs_batched on two 192x256 pairs on the card and on the CPU
    with the same draws: one detector-maps launch and one warp launch for
    the batch; equal inliers and corners, focal within 1e-3, each canvas
    within 1 intensity on average."""
    from imagestitch_tpu_torch import stitch_pairs_batched
    from imagestitch_tpu_torch.utils.io import synthetic_pair
    pairs = np.stack([np.stack(synthetic_pair(192, 256, overlap=0.4 + 0.1 * b,
                                              seed=3 + b)[:2])
                      for b in range(2)])
    g = torch.Generator().manual_seed(4)
    draws = {b: (torch.rand((2048, 4), generator=g),
                 torch.rand((256, 4), generator=g)) for b in range(2)}
    c0 = _counts()
    pc, vc, cc, mc = stitch_pairs_batched(pairs, device=cuda, draws=draws)
    torch.cuda.synchronize()
    assert tuple(b - a for a, b in zip(c0, _counts())) == (1, 0, 1)
    pp, vp, cp, mp = stitch_pairs_batched(pairs, device="cpu", draws=draws)
    assert torch.equal(cc.cpu(), cp)
    assert torch.equal(mc["num_inliers"].cpu(), mp["num_inliers"])
    assert bool(mc["h_valid"].all())
    assert torch.allclose(mc["focal"].cpu(), mp["focal"], rtol=1e-3)
    assert float((pc.cpu() - pp).abs().mean()) < 1.0


def test_stream_on_card_matches_cpu_and_counts_launches(cuda):
    """StreamStitcher with the default configuration (bundle adjustment on)
    on a panning camera's four 160x224 views, on the card and on the CPU
    with the same draws: calibrate launches the detector maps once and the
    warp once, compose the warp once and no detection; equal reachable,
    focal within 1e-3, panos within 1 intensity on average."""
    from imagestitch_tpu_torch import StreamStitcher
    from imagestitch_tpu_torch.matching.matcher import pair_list
    from imagestitch_tpu_torch.utils.io import synthetic_pan_sequence
    views = synthetic_pan_sequence(4)
    g = torch.Generator().manual_seed(5)
    draws = {p: (torch.rand((2048, 4), generator=g),
                 torch.rand((256, 4), generator=g)) for p in pair_list(4)}
    card = StreamStitcher(device=cuda)
    c0 = _counts()
    pc, mc = card.calibrate(views, draws=draws)
    c1 = _counts()
    assert tuple(b - a for a, b in zip(c0, c1)) == (1, 0, 1)
    composed = card.compose(views)
    assert tuple(b - a for a, b in zip(c1, _counts())) == (0, 0, 1)
    cpu = StreamStitcher(device="cpu")
    pp, mp = cpu.calibrate(views, draws=draws)
    assert mc["reachable"] == mp["reachable"] == [True] * 4
    assert abs(mc["focal"] - mp["focal"]) <= 1e-3 * mp["focal"]
    assert pc.shape == pp.shape == composed.shape
    assert np.abs(pc.astype(float) - pp.astype(float)).mean() < 1.0
    assert np.abs(pc.astype(float) - composed.astype(float)).mean() < 1.0


@pytest.mark.parametrize("case,launches", [("ramp_colorgrad", (2, 0, 1)),
                                           ("paniniA2B1", (2, 0, 0))])
def test_item13_pair_on_card_matches_cpu_and_counts_launches(cuda, case,
                                                             launches):
    """The 192x256 rotation pair with the ramp blend and the colour-
    gradient DP seam, and with the Panini projector, on the card and on the
    CPU with the same RANSAC draws: equal counts, focal within 1e-3, pano
    within 1 intensity on average. The Panini stitch warps with the plain
    warp on the card, as the JAX package does for the kinds its warp
    kernel does not carry: the warp kernel launches 0 times."""
    from imagestitch_tpu_torch import BlendConfig, SeamConfig
    a, b, _, _ = synthetic_rotation_pair(192, 256)
    g = torch.Generator().manual_seed(1)
    draws = (torch.rand((2048, 4), generator=g),
             torch.rand((256, 4), generator=g))
    cfg = (PipelineConfig(seam=SeamConfig(kind="dp_colorgrad"),
                          blend=BlendConfig(kind="ramp"))
           if case == "ramp_colorgrad"
           else PipelineConfig(warp=WarpConfig(kind=case)))
    c0 = _counts()
    pc, mc = stitch_pair(a, b, cfg, device=cuda, draws=draws)
    assert tuple(y - x for x, y in zip(c0, _counts())) == launches
    pp, mp = stitch_pair(a, b, cfg, device="cpu", draws=draws)
    for k in ("kpts1", "kpts2", "num_matches", "num_inliers", "h_valid"):
        assert mc[k] == mp[k], k
    assert abs(mc["focal"] - mp["focal"]) <= 1e-3 * mp["focal"]
    assert pc.shape == pp.shape
    assert np.abs(pc.astype(float) - pp.astype(float)).mean() < 1.0


def test_detailed_stitcher_on_card_matches_cpu_and_counts_launches(cuda):
    """OpenCV stitching_detailed's defaults (work_megapix, horizontal wave
    correction, spherical warp, GAIN_BLOCKS, DP colour seam, multi-band)
    through Stitcher on a panning camera's three 160x224 views, on the
    card and on the CPU with the same draws (work_megapix 0.02: the work
    views are 120x167): one detector-maps launch for the three work views,
    one warp launch; equal reachable, focal within 1e-3, panos within 1
    intensity on average."""
    from imagestitch_tpu_torch import (BlendConfig, CameraConfig,
                                       ExposureConfig, SeamConfig, Stitcher)
    from imagestitch_tpu_torch.matching.matcher import pair_list
    from imagestitch_tpu_torch.utils.io import synthetic_pan_sequence
    views = synthetic_pan_sequence(3)
    g = torch.Generator().manual_seed(5)
    draws = {p: (torch.rand((2048, 4), generator=g),
                 torch.rand((256, 4), generator=g)) for p in pair_list(3)}
    cfg = PipelineConfig(
        work_megapix=0.02,
        camera=CameraConfig(wave_correct=True, wave_kind="horiz"),
        warp=WarpConfig(kind="spherical"),
        exposure=ExposureConfig(kind="gain_blocks"),
        seam=SeamConfig(kind="dp_color"),
        blend=BlendConfig(kind="multiband"))
    c0 = _counts()
    pc, mc = Stitcher(cfg, device=cuda).stitch(views, draws=draws)
    assert tuple(y - x for x, y in zip(c0, _counts())) == (1, 0, 1)
    pp, mp = Stitcher(cfg, device="cpu").stitch(views, draws=draws)
    assert mc["reachable"] == mp["reachable"] == [True] * 3
    assert abs(mc["focal"] - mp["focal"]) <= 1e-3 * mp["focal"]
    assert pc.shape == pp.shape
    assert np.abs(pc.astype(float) - pp.astype(float)).mean() < 1.0


def _outputs_equal(a, b):
    """(pano, valid, corner, metrics) tensors equal bit for bit."""
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(x, y)
    assert sorted(a[3]) == sorted(b[3])
    for k in a[3]:
        assert torch.equal(a[3][k], b[3][k]), k


@pytest.mark.parametrize("axes", [{"data": 2}, {"data": 2, "model": 2}],
                         ids=str)
def test_sharded_pairs_on_repeated_card_mesh(cuda, axes):
    """stitch_pairs_sharded on a mesh that names the card 2 or 4 times (a
    logic check of the split on one card): equal to stitch_pairs_batched
    with the same seed, bit for bit, with the detector maps and the warp
    launched once per data shard."""
    from imagestitch_tpu_torch.parallel import (make_mesh,
                                                stitch_pairs_batched,
                                                stitch_pairs_sharded)
    from imagestitch_tpu_torch.utils.io import synthetic_pair
    pairs = np.stack([np.stack(synthetic_pair(192, 256, overlap=0.4,
                                              seed=s)[:2]) for s in range(4)])
    ref = stitch_pairs_batched(pairs, seed=2, device=cuda)
    mesh = make_mesh(axes, [cuda] * 4)
    c0 = _counts()
    out = stitch_pairs_sharded(pairs, mesh, seed=2)
    assert tuple(y - x for x, y in zip(c0, _counts())) == (2, 0, 2)
    _outputs_equal(out, ref)


def test_chain_pano_sharded_on_repeated_card_mesh(cuda):
    """stitch_chain_pano on a panning camera's four 160x224 views, on the
    card against the CPU with the same draws (counts, reachable and corner
    equal, focal within 1e-3, valid IoU >= 0.999, canvas within 0.5 on
    average where both cover), and split over a mesh that names the card
    twice: bit for bit, K1 and K2 once per data shard."""
    from imagestitch_tpu_torch.parallel import (make_mesh, stitch_chain_pano,
                                                stitch_chain_pano_sharded)
    from imagestitch_tpu_torch.utils.io import synthetic_pan_sequence
    views = synthetic_pan_sequence(4)
    g = torch.Generator().manual_seed(3)
    draws = {(i, i + 1): (torch.rand((2048, 4), generator=g),
                          torch.rand((256, 4), generator=g))
             for i in range(3)}
    c0 = _counts()
    pc, vc, cc, mc = stitch_chain_pano(views, device=cuda, draws=draws)
    assert tuple(y - x for x, y in zip(c0, _counts())) == (1, 0, 1)
    pp, vp, cp, mp = stitch_chain_pano(views, device="cpu", draws=draws)
    for k in ("num_inliers", "h_valid", "reachable"):
        assert torch.equal(mc[k].cpu(), mp[k]), k
    assert torch.equal(cc.cpu(), cp)
    assert abs(float(mc["focal"]) - float(mp["focal"])) <= \
        1e-3 * float(mp["focal"])
    vc_, vp_ = vc.cpu(), vp
    assert float((vc_ & vp_).sum()) / float((vc_ | vp_).sum()) >= 0.999
    both = vc_ & vp_
    assert float((pc.cpu() - pp).abs()[both].mean()) < 0.5
    c0 = _counts()
    out = stitch_chain_pano_sharded(views, make_mesh({"data": 2}, [cuda] * 2),
                                    draws=draws)
    assert tuple(y - x for x, y in zip(c0, _counts())) == (2, 0, 2)
    _outputs_equal(out, (pc, vc, cc, mc))


def test_hostseam_sharded_on_card_equals_split(cuda):
    """stitch_pair_hostseam_sharded (graph cut) under a {"data": 2,
    "model": 2} mesh of the card: equal to stitch_pair's split (its front
    and `_host_seam_blend`) on the same draws."""
    from imagestitch_tpu_torch import SeamConfig
    from imagestitch_tpu_torch.parallel import (make_mesh,
                                                stitch_pair_hostseam_sharded)
    from imagestitch_tpu_torch.pipeline import (_host_seam_blend,
                                                stitch_pair_front_impl)
    a, b, _, _ = synthetic_rotation_pair(192, 256)
    g = torch.Generator().manual_seed(1)
    draws = (torch.rand((2048, 4), generator=g),
             torch.rand((256, 4), generator=g))
    cfg = PipelineConfig(seam=SeamConfig(kind="graphcut"))
    mesh = make_mesh({"data": 2, "model": 2}, [cuda] * 4)
    out = stitch_pair_hostseam_sharded(a, b, mesh, cfg, draws=draws)
    warped, masks, corner, m = stitch_pair_front_impl(
        torch.as_tensor(a, device=cuda), torch.as_tensor(b, device=cuda),
        cfg, draws)
    pano, valid, _ = _host_seam_blend(warped, masks, cfg)
    _outputs_equal(out, (pano, valid, corner, m))


def test_serve_loop_on_card_equals_batched_call(cuda):
    """The serving loop (`tools.serve_demo.serve`) on the card, with the
    demo's configuration, after its all-zero warm-up: three 144x192
    requests from three producers, batch 3. Every request served ok, the
    detector maps and the warp launched once per dispatch, and each crop
    equal bit for bit to `stitch_pairs_batched(seed=k)` on its dispatch's
    pairs with the demo's crop."""
    from imagestitch_tpu_torch import stitch_pairs_batched
    from imagestitch_tpu_torch.tools import serve_demo
    from imagestitch_tpu_torch.utils.io import synthetic_pair
    cfg = serve_demo.demo_config()
    pairs = [np.stack(synthetic_pair(144, 192, overlap=0.5,
                                     seed=5 + k)[:2]).astype(np.float32)
             for k in range(3)]
    serve_demo.warm(cfg, 3, 144, 192, cuda)
    record = []
    c0 = _counts()
    serve_demo.serve([[p] for p in pairs], cfg, 3, 200.0, cuda, record)
    torch.cuda.synchronize()
    n = len(record)
    assert tuple(y - x for x, y in zip(c0, _counts())) == (n, 0, n)
    assert sum(e["n"] for e in record) == 3
    for e in record:
        x = np.stack([r.pair for r in e["reqs"]])
        panos, valids, _, _ = stitch_pairs_batched(x, cfg, seed=e["seed"],
                                                   device=cuda)
        panos, valids = panos.cpu().numpy(), valids.cpu().numpy()
        for b, r in enumerate(e["reqs"]):
            assert r.ok
            assert np.array_equal(r.pano,
                                  serve_demo.crop(panos[b], valids[b]))


# The LM kernel (csrc/lm_bundle.cu) against the plain loop
# (geometry/bundle._lm_minimize) on the same CUDA inputs, made with numpy
# from a fixed seed (testing.bundle_problem: 1080x1920 views, focal 1728).
LM_CHAIN = [(0, 1), (1, 2), (2, 3), (0, 2), (1, 3)]
LM_CASES = {
    "ray_pair": ("ray", dict(n_cams=2, pairs=[(0, 1)])),
    "ray_chain": ("ray", dict(n_cams=4, pairs=LM_CHAIN, masked=0.2,
                              invalid_pairs=[3])),
    "reproj2": ("reproj", dict(n_cams=2, pairs=[(0, 1)])),
    "reproj4": ("reproj", dict(n_cams=4, pairs=LM_CHAIN)),
    "degenerate": ("ray", dict(n_cams=2, pairs=[(0, 1)], masked=1.0)),
}


def _lm_inputs(dev, kind, T=512, seed=0, **kw):
    """(K, x0, (src, dst, pt_valid, pair_valid, pair_from, pair_to),
    (ppx, ppy)) on `dev`, x0 as the adjuster builds it."""
    cams, src, dst, ptv, pf, pt, pv = bundle_problem(T=T, seed=seed, **kw)
    mid = ([cams.ppx[:, None], cams.ppy[:, None], cams.aspect[:, None]]
           if kind == "reproj" else [])
    x0 = torch.cat([cams.focal[:, None], *mid,
                    bundle.R_to_rodrigues(cams.R)], dim=1).reshape(-1)
    pp = ((cams.ppx.to(dev), cams.ppy.to(dev)) if kind == "ray"
          else (None, None))
    return (cuda_lm.PARAMS_PER_CAMERA[kind], x0.to(dev),
            tuple(v.to(dev) for v in (src, dst, ptv, pv, pf, pt)), pp)


def _lm_plain(kind, x0, pts, pp, iters):
    """The plain loop: (x, iterations run, Σ r(x)²)."""
    src, dst, ptv, pv, pf, pt = pts
    res = (bundle._ray_residuals(src, dst, ptv, pf, pt, pv, *pp)
           if kind == "ray"
           else bundle._reproj_residuals(src, dst, ptv, pf, pt, pv))
    timer = log.StageTimer(sync=False)
    with timer.active():
        x = bundle._lm_minimize(res, x0, iters)
    r = res(x)
    return x, timer.counts().get("lm_iters", 0), float((r * r).sum())


def _lm_kernel(kind, x0, pts, pp, iters):
    src, dst, ptv, pv, pf, pt = pts
    return cuda_lm.lm_minimize(kind, x0, src, dst, ptv, pv, pf, pt, *pp,
                               iters)


def _focal_and_relative_R(x, K):
    """Focals and R_0ᵀ·R_i: what a global rotation, which no residual
    sees, leaves alone (the adjusters re-anchor on camera 0)."""
    p = x.reshape(-1, K).double().cpu()
    R = bundle.rodrigues_to_R(p[:, K - 3:].float()).double()
    return p[:, 0], R[0].T @ R


@pytest.mark.parametrize("case", list(LM_CASES))
def test_lm_kernel_one_step_matches_plain(cuda, case):
    """One step (iters=1): the Jacobian, the normal equations and the
    solve. Each parameter within 5% of the largest step the plain loop took
    in its group (focal; principal point and aspect; rotation): two float32
    summation orders of the same JᵀJ give first steps up to 2.3% apart at
    these shapes, where a float64 referee puts each float32 step up to 1%
    off the exact one (the damped system at λ = 1e-3 is that ill
    conditioned), and a wrong Jacobian or solve is off by the step itself.
    All points masked: neither moves."""
    kind, kw = LM_CASES[case]
    K, x0, pts, pp = _lm_inputs(cuda, kind, **kw)
    xp, itp, _ = _lm_plain(kind, x0, pts, pp, 1)
    xk, itk, _ = _lm_kernel(kind, x0, pts, pp, 1)
    assert itp == itk == 1
    d = (xk - xp).reshape(-1, K).abs().cpu()
    step = (xp - x0).reshape(-1, K).abs().cpu()
    for cols in ([0], list(range(1, K - 3)), list(range(K - 3, K))):
        if cols:
            assert float(d[:, cols].max()) <= \
                0.05 * float(step[:, cols].max()), (cols, d, step)
    if case == "degenerate":
        assert torch.equal(xk, x0) and torch.equal(xp, x0)


@pytest.mark.parametrize("case", list(LM_CASES))
def test_lm_kernel_converges_with_plain(cuda, case):
    """The whole loop (iters=25): the final error within 1e-4 relative of
    the plain loop's; ray: focals within 1e-4 relative and the rotations,
    re-anchored, within 1e-5; reproj: focals within 1% (its optimum is
    flat: float32 orders end 0.4% apart in focal on the 4-camera chain at
    errors 1.5e-5 apart). The iteration at which each stops is not
    compared: near the optimum an accepted step gains less than the
    float32 rounding of the error, so the stopping test reads rounding
    (two summation orders stop up to 21 steps apart on these shapes).
    All points masked: x0 back from both after 20 iterations (λ from 1e-3,
    x4 until past 1e8)."""
    kind, kw = LM_CASES[case]
    K, x0, pts, pp = _lm_inputs(cuda, kind, **kw)
    xp, itp, ep = _lm_plain(kind, x0, pts, pp, 25)
    xk, itk, ek = _lm_kernel(kind, x0, pts, pp, 25)
    assert 1 <= itk <= 25 and 1 <= itp <= 25
    assert abs(ek - ep) <= 1e-4 * ep
    fp, Rp = _focal_and_relative_R(xp, K)
    fk, Rk = _focal_and_relative_R(xk, K)
    if kind == "ray":
        assert float(((fk - fp).abs() / fp).max()) <= 1e-4
        assert float((Rk - Rp).abs().max()) <= 1e-5
    else:
        assert float(((fk - fp).abs() / fp).max()) <= 1e-2
    if case == "degenerate":
        assert torch.equal(xk, x0) and itk == itp == 20 and ek == 0.0


def test_lm_kernel_is_deterministic(cuda):
    """Two launches on the same inputs give the same bits: the sums run in
    a fixed order, with no float atomics."""
    kind, kw = LM_CASES["ray_chain"]
    K, x0, pts, pp = _lm_inputs(cuda, kind, seed=3, **kw)
    a = _lm_kernel(kind, x0, pts, pp, 25)
    b = _lm_kernel(kind, x0, pts, pp, 25)
    assert torch.equal(a[0], b[0]) and a[1:] == b[1:]


@pytest.mark.parametrize("kind,n_cams", [("ray", 32), ("reproj", 18)])
def test_lm_kernel_at_its_cap(cuda, kind, n_cams):
    """The largest systems the kernel holds (128 and 126 parameters, A and
    its factor in 135 KB of shared memory): 31 consecutive pairs of 128
    points, 3 iterations; the error falls and ends within 1% of the plain
    loop's (float32 first steps differ by up to 2% at these conditions)."""
    pairs = [(i, i + 1) for i in range(n_cams - 1)]
    K, x0, pts, pp = _lm_inputs(cuda, kind, T=128, seed=4, n_cams=n_cams,
                                pairs=pairs)
    assert bundle.takes_kernel(x0.device, x0.numel())
    n0 = cuda_lm.launch_count
    xp, itp, ep = _lm_plain(kind, x0, pts, pp, 3)
    xk, itk, ek = _lm_kernel(kind, x0, pts, pp, 3)
    assert cuda_lm.launch_count == n0 + 1
    _, _, e0 = _lm_plain(kind, x0, pts, pp, 0)
    assert ek < e0 and abs(ek - ep) <= 1e-2 * ep


def test_lm_kernel_raises_on_a_pair_outside_the_cameras(cuda):
    kind, kw = LM_CASES["ray_pair"]
    K, x0, (src, dst, ptv, pv, pf, pt), pp = _lm_inputs(cuda, kind, **kw)
    with pytest.raises(ValueError, match="outside"):
        cuda_lm.lm_minimize(kind, x0, src, dst, ptv, pv, pf, pt + 1, *pp, 5)


# The DP seam kernel (csrc/dp_seam.cu) against the plain loop
# (seam/dp._dp_seam_path_plain) on the same CUDA costs: the same seam
# columns, bit for bit.
DP_CELLS = {
    # the ORB pair cell: 1458-row canvas, dp_scale 4, window 2176 -> 544
    "pair": (PipelineConfig(), (365, 544)),
    # the SIFT cell: plane into 1944 rows, window 2560 -> 640
    "sift": (PipelineConfig(
        detector=DetectorConfig(kind="sift"),
        matcher=MatcherConfig(match_conf=0.51),
        warp=WarpConfig(kind="plane", canvas_scale_h=1.8)), (486, 640)),
    # the ramp blend's own seam at scale 1, window 2176
    "ramp": (PipelineConfig(seam=SeamConfig(kind="dp_colorgrad"),
                            blend=BlendConfig(kind="ramp")), (1458, 2176)),
    # a horizontal seam: the transposed canvas, window 1280 -> 320
    "horizontal": (PipelineConfig(seam=SeamConfig(orient="horizontal")),
                   (1008, 320)),
}


@pytest.fixture(scope="module")
def dp_cell_costs():
    """The costs the kernel is handed inside a 1080p rotation-pair stitch
    on the card, for each of `DP_CELLS`' configurations."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    a, b, _, _ = synthetic_rotation_pair(1080, 1920, yaw_deg=20.0)
    launch = cuda_dp.seam_path
    out = {}
    for name, (cfg, _) in DP_CELLS.items():
        seen = []

        def spy(cost, transitions):
            seen.append(cost.clone())
            return launch(cost, transitions)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(cuda_dp, "seam_path", spy)
            _, m = stitch_pair(a, b, cfg, device="cuda")
        assert m["dp_fused"] == len(seen) == 1, name
        out[name] = seen[0]
    return out


def _dp_both(cost):
    """(the kernel's columns, the plain loop's) for one CUDA cost; the
    kernel in one launch, through `dp.dp_seam_path`."""
    n0 = cuda_dp.launch_count
    k = dp.dp_seam_path(cost)
    assert cuda_dp.launch_count == n0 + 1
    return k, dp._dp_seam_path_plain(cost)


@pytest.mark.parametrize("name", list(DP_CELLS))
def test_dp_kernel_matches_plain_on_cell_costs(dp_cell_costs, name):
    cost = dp_cell_costs[name]
    assert tuple(cost.shape) == DP_CELLS[name][1]
    k, p = _dp_both(cost)
    assert k.dtype == torch.int64 and k.device == cost.device
    assert torch.equal(k, p)


def _dp_cost(shape, seed, free_rows=(), ties=False):
    """Seeded float32 costs on the card: a ragged band of finite costs
    (small integers with `ties`, so most moves tie) with BIG outside, and
    the rows in `free_rows` all BIG (no overlap)."""
    h, w = shape
    rng = np.random.default_rng(seed)
    c = (rng.integers(0, 3, (h, w)) if ties
         else rng.uniform(0, 500, (h, w))).astype(np.float32)
    lo = rng.integers(0, max(w // 5, 1), h)
    hi = w - rng.integers(0, max(w // 5, 1), h)
    cols = np.arange(w)[None, :]
    c[(cols < lo[:, None]) | (cols >= hi[:, None])] = dp.BIG
    c[list(free_rows)] = dp.BIG
    return torch.as_tensor(c, device="cuda")


@pytest.mark.parametrize("shape,free_rows,ties", [
    ((97, 131), (), False), ((97, 131), (), True),     # W % 32 != 0
    ((50, 1), (), False), ((1, 1), (), False), ((1, 37), (), False),
    ((2, 33), (), True), ((9, 64), (), False),
    ((120, 200), (0, 1, 2), False),                     # top
    ((120, 200), tuple(range(50, 70)), False),          # middle
    ((120, 200), (117, 118, 119), True),                # bottom
    ((120, 200), tuple(range(120)), False),             # all BIG
    ((64, 1024), (), True), ((64, 1025), (), True),     # 1 | 2 a thread:
    ((40, 2049), (), False), ((40, 4096), (), True),    # the further
    ((40, 4097), (), True), ((24, 8193), (5,), False),  # columns load in
    ((16, 16384), (), True), ((12, 20000), (3,), False),    # the row
    ((9, 40000), (), True), ((10, 40001), (0, 9), False)])  # m global
def test_dp_kernel_matches_plain_on_shapes(cuda, shape, free_rows, ties):
    k, p = _dp_both(_dp_cost(shape, sum(shape), free_rows, ties))
    assert torch.equal(k, p)


@pytest.mark.parametrize("value", [0.0, 3.0, 1e9])
def test_dp_kernel_matches_plain_on_constant_costs(cuda, value):
    """Every move ties: the first minimum decides each choice."""
    for shape in ((37, 53), (365, 544)):
        cost = torch.full(shape, value, device=cuda)
        k, p = _dp_both(cost)
        assert torch.equal(k, p), shape


@pytest.mark.parametrize("seed", range(8))
def test_dp_kernel_matches_plain_on_seeds(cuda, seed):
    """The pair cell's shape, the SIFT cell's and a transposed (not
    contiguous) scale-1 cost, seeded."""
    for shape in ((365, 544), (486, 640)):
        k, p = _dp_both(_dp_cost(shape, 1000 + seed, ties=seed % 2 == 1))
        assert torch.equal(k, p), shape
    cost = _dp_cost((1408, 900), 2000 + seed).T
    assert not cost.is_contiguous()
    k, p = _dp_both(cost)
    assert torch.equal(k, p)


def test_dp_kernel_is_deterministic(cuda):
    cost = _dp_cost((365, 544), 5, ties=True)
    assert torch.equal(dp.dp_seam_path(cost), dp.dp_seam_path(cost))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16])
def test_dp_kernel_takes_other_dtypes_as_float32(cuda, dtype):
    """A cost of another dtype on the card goes to the kernel as float32:
    the plain loop's columns on the float32 cost."""
    cost = _dp_cost((365, 544), 9).to(dtype)
    n0 = cuda_dp.launch_count
    k = dp.dp_seam_path(cost)
    assert cuda_dp.launch_count == n0 + 1
    assert torch.equal(k, dp._dp_seam_path_plain(cost.to(torch.float32)))


def test_stitch_pair_dp_kernel_equals_plain_panorama(cuda):
    """Four 1080p rotation pairs (yaw 15-30 deg, the pair cells' pool's
    range) stitched on the card through the DP kernel and with the plain
    loop forced: the same uint8 panorama byte for byte, `dp_fused` 1
    against none, and the kernel's stitch reading back less by exactly the
    choices' bytes (one (368, 544) int8 buffer)."""
    for i, yaw in enumerate((15.0, 20.0, 25.0, 30.0)):
        a, b, _, _ = synthetic_rotation_pair(1080, 1920, yaw_deg=yaw,
                                             seed=40 + i)
        g = torch.Generator().manual_seed(i)
        draws = (torch.rand((2048, 4), generator=g),
                 torch.rand((256, 4), generator=g))
        pk, mk = stitch_pair(a, b, device=cuda, draws=draws)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(dp, "takes_kernel", lambda dev: False)
            pp, mp_ = stitch_pair(a, b, device=cuda, draws=draws)
        assert mk["dp_fused"] == 1 and "dp_fused" not in mp_
        assert pk.shape == pp.shape and np.array_equal(pk, pp), yaw
        assert mp_["readback_bytes"] - mk["readback_bytes"] == 368 * 544


def test_batched_dispatch_launches_one_dp_kernel_per_pair(cuda):
    """`stitch_pairs_batched` of 8 pairs: 8 DP launches, and the same
    panoramas as with the plain loop forced."""
    pairs = np.stack([np.stack(synthetic_rotation_pair(
        192, 256, yaw_deg=10.0 + i, seed=60 + i)[:2]) for i in range(8)])
    n0 = cuda_dp.launch_count
    pk = stitch_pairs_batched(pairs, device=cuda)[0]
    assert cuda_dp.launch_count == n0 + 8
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dp, "takes_kernel", lambda dev: False)
        pp = stitch_pairs_batched(pairs, device=cuda)[0]
    assert cuda_dp.launch_count == n0 + 8
    assert torch.equal(pk, pp)


# the crop kernel (csrc/crop_u8.cu): the ORB pair's canvas, the SIFT
# cell's, and two below one group of four pixels a thread
CROP_SHAPES = ((1, 1), (7, 13), (1458, 4032), (1944, 4032))


def _crop_both(pano, valid):
    """(the kernel path's `_to_uint8`, its timer; the host path's) on one
    CUDA canvas: one launch, then the host path with the dispatch off."""
    n0 = cuda_crop.launch_count
    timer = log.StageTimer(pano.device)
    with np.errstate(invalid="ignore"), timer.active():
        got = pipeline._to_uint8(pano, valid)
    assert cuda_crop.launch_count == n0 + 1
    with pytest.MonkeyPatch.context() as mp, np.errstate(invalid="ignore"):
        mp.setattr(pipeline, "_crop_takes_kernel", lambda dev: False)
        want = pipeline._to_uint8(pano, valid)
    return got, timer, want


@pytest.mark.parametrize("kind", CROP_MASKS)
@pytest.mark.parametrize("shape", CROP_SHAPES)
def test_crop_kernel_equals_the_host_path(cuda, shape, kind):
    """`_to_uint8` through the crop kernel against the host path
    (`_read_back`, `_crop_valid`, clip, cast) on the same CUDA canvas,
    byte for byte: values in [-50, 300] with fractional parts, exact 0,
    255 and 254.9999, NaN and +-inf; masks empty, one pixel, touching
    each border, full; interleaved and (the "full" and "right" masks)
    planar canvases. One launch, `crop_fused` 1 and `readback_bytes` 16 +
    the crop's bytes."""
    h, w = shape
    planar = kind in ("full", "right")
    pano = crop_canvas(h, w, seed=h * w + len(kind), planar=planar).to(cuda)
    valid = crop_mask(h, w, kind, seed=h + w).to(cuda)
    assert cuda_crop._planar(pano) == (planar and h * w > 1)
    got, timer, want = _crop_both(pano, valid)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want), int((got != want).sum())
    assert timer.counts() == {"crop_fused": 1,
                              "readback_bytes": 16 + got.nbytes}


@pytest.mark.parametrize("layout", ["canvas_offset", "mask_offset",
                                    "transposed", "planar_odd"])
@pytest.mark.parametrize("shape", [(97, 131), (1458, 4032)])
def test_crop_kernel_off_its_vector_loads(cuda, layout, shape):
    """Canvases and masks the 16-byte loads do not take, byte for byte
    with the host path: a canvas one pixel (12 B) into its storage and a
    mask one byte in (pixel by pixel), a canvas with its rows and columns
    swapped (copied to interleaved first), a planar canvas of an odd
    pixel count (pixel by pixel)."""
    h, w = shape
    if layout == "planar_odd":
        h, w = h | 1, w | 1
    pano = crop_canvas(h, w, seed=h + 1).to(cuda)
    valid = crop_mask(h, w, "top", seed=w).to(cuda)
    if layout == "canvas_offset":
        pano = torch.cat([torch.zeros(3, device=cuda),
                          pano.reshape(-1)])[3:].view(h, w, 3)
        assert pano.data_ptr() % 16 != 0
    elif layout == "mask_offset":
        valid = torch.cat([torch.zeros(1, dtype=torch.bool, device=cuda),
                           valid.reshape(-1)])[1:].view(h, w)
        assert valid.data_ptr() % 4 != 0
    elif layout == "transposed":
        pano = pano.transpose(0, 1).contiguous().transpose(0, 1)
        assert not pano.is_contiguous() and not cuda_crop._planar(pano)
    else:
        pano = pano.permute(2, 0, 1).contiguous().permute(1, 2, 0)
        assert cuda_crop._planar(pano) and h * w % 4 != 0
    got, _, want = _crop_both(pano, valid)
    assert np.array_equal(got, want), int((got != want).sum())


def test_crop_kernel_runs_one_kernel_and_two_copies(cuda):
    """Three readbacks through the crop kernel run three CUDA kernels, the
    crop kernel, three memsets (the bbox's 16 bytes) and six device-to-
    host copies (the bbox, the crop), and nothing else on the card. A
    trace in a process that traced before can lose an event (as
    `utils/timing.kernel_split_ms` allows for): every trace holds nothing
    but these, and one of at most three traces holds them all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    pano = crop_canvas(1458, 4032, seed=5).to(cuda)
    valid = crop_mask(1458, 4032, "left", seed=6).to(cuda)
    cuda_crop.crop_u8(pano, valid)
    torch.cuda.synchronize()
    counts = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                cuda_crop.crop_u8(pano, valid)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        kernels = [n for n in names if "crop_u8_kernel" in n]
        copies = [n for n in names if "Memcpy" in n]
        sets = [n for n in names if "Memset" in n]
        assert len(kernels) + len(copies) + len(sets) == len(names), names
        assert all("DtoH" in n for n in copies), names
        counts.append((len(kernels), len(sets), len(copies)))
        if counts[-1] == (3, 3, 6):
            break
    assert counts[-1] == (3, 3, 6), counts


def test_crop_kernel_threads_share_the_staging_buffer(cuda):
    """Twelve threads (more than the card machine's 8 cores), with a short
    switch interval, read back canvases of twelve sizes five times each
    through the one page-locked staging buffer, which grows meanwhile:
    every read gives its own canvas's crop, the host path's bytes."""
    import sys
    import threading
    shapes = [(97 + 131 * i, 131 + 331 * i) for i in range(12)]
    cases = [(crop_canvas(h, w, seed=i).to(cuda),
              crop_mask(h, w, CROP_MASKS[i % len(CROP_MASKS)],
                        seed=i).to(cuda)) for i, (h, w) in enumerate(shapes)]
    want = [_crop_both(p, v)[2] for p, v in cases]
    cuda_crop._staging.clear()
    wrong, errors = [], []

    def run(i):
        try:
            for _ in range(5):
                if not np.array_equal(cuda_crop.crop_u8(*cases[i]), want[i]):
                    wrong.append(i)
        except Exception as e:       # noqa: BLE001  (asserted below)
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(cases))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors and not wrong, (errors, wrong)


def _crop_entries(cuda, entry):
    """The panoramas and metrics of one entry on the cells' pools, and
    the canvas shapes the crop kernel was handed."""
    from stitchbench import harness
    import imagestitch_tpu_torch as tist
    cell = {"orb_pair": "default_1080p.pair_closed1",
            "sift_pair": "sift_plane_1080p.pair_closed1",
            "chain": "detailed_1080p.chain4_closed1"}.get(
                entry, "detailed_1080p.chain4_closed1")
    c = harness.resolve_cell(harness.load_benchmark(), cell)
    cfg = (harness.pipeline_config(tist, c["config"].get("pipeline", {}))
           if entry in ("orb_pair", "sift_pair", "chain")
           else PipelineConfig())
    n = 2 if entry.endswith("pair") else 1
    pool = harness.make_pool(c["config"], {**c["traffic"], "pool": n},
                             2024, cuda)
    launch = cuda_crop.crop_u8
    shapes = []

    def spy(pano, valid):
        shapes.append(tuple(pano.shape))
        return launch(pano, valid)

    out = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cuda_crop, "crop_u8", spy)
        for item in pool:
            v = item.views
            if entry.endswith("pair"):
                out.append(stitch_pair(v[0], v[1], cfg, seed=7))
            elif entry == "chain":
                out.append(tist.stitch_chain(v, cfg, seed=7))
            elif entry == "stitcher":
                out.append(tist.Stitcher(cfg).stitch(v, seed=7))
            else:
                ss = tist.StreamStitcher(cfg)
                out.append(ss.calibrate(v, seed=7))
                out.append((ss.compose(v), None))
    return out, shapes


@pytest.mark.parametrize("entry", ["orb_pair", "sift_pair", "chain",
                                   "stitcher", "stream"])
def test_crop_kernel_entries_equal_the_host_path(cuda, entry):
    """Two pairs of the ORB and of the SIFT cell's pool, one pan of the
    chain cell's (the graph cut and multi-band: a planar canvas), a
    4-view Stitcher and a stream's calibrate and compose on that pan,
    each through the crop kernel and with the host path forced: the same
    uint8 panoramas byte for byte, `crop_fused` 1 against none, and
    `readback_bytes` lower by the canvas's 13 B a pixel less 16 + the
    crop's bytes."""
    got, shapes = _crop_entries(cuda, entry)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pipeline, "_crop_takes_kernel", lambda dev: False)
        want, none = _crop_entries(cuda, entry)
    assert not none and len(shapes) == len(got) == len(want)
    for (pk, mk), (pp, mp_), (hc, wc, _) in zip(got, want, shapes):
        assert pk.shape == pp.shape and np.array_equal(pk, pp), entry
        if mk is None:      # the stream's compose returns no metrics
            continue
        assert mk["crop_fused"] == 1 and "crop_fused" not in mp_
        assert mp_["readback_bytes"] - mk["readback_bytes"] == \
            hc * wc * 13 - 16 - pk.nbytes


@pytest.mark.parametrize("step", [20.0, 30.0])
def test_stitcher_pano_through_the_lm_kernel(cuda, step):
    """The `stitcher_pano_1080p` configuration (OpenCV's PANORAMA preset)
    on a 4-view 1080p pan of the benchmark's scenes: `register_views`
    adjusts through one LM kernel launch from sheared starts
    (`start_defect` over 1e-3) to rotations within 1e-5 (float32 products
    of a few rotations), and `Stitcher.stitch` reaches every view and
    meets the plain reference's checks at the configuration's limits."""
    from stitchbench import find, harness, reference, scenes
    import imagestitch_tpu_torch as tist
    config = harness.resolve_cell(harness.load_benchmark(),
                                  "stitcher_pano_1080p.pan4_closed1")[
        "config"]
    cfg = harness.pipeline_config(tist, config["pipeline"])
    h, w = config["view_hw"]
    f = float(config["focal_px"])
    rots, half = find.part("poses", "pan").cameras((step,), 4)
    views = scenes.render_views(rots, half, h, w, f,
                                np.random.default_rng(int(step)), cuda)
    timer = log.StageTimer(cuda)
    with timer.active():
        cams, _, reachable, _, start_defect = pipeline.register_views(
            views.to(torch.float32), cfg,
            generator=torch.Generator(cuda).manual_seed(7))
    counts = timer.counts()
    assert counts["lm_fused"] == 1 and counts["pairs_matched"] == 6
    assert start_defect > 1e-3 and reachable.all()
    assert bundle.rotation_defect(cams.R) < 1e-5
    pano, m = tist.Stitcher(cfg).stitch(list(views.cpu().numpy()), seed=7)
    assert all(m["reachable"]) and m["lm_fused"] == 1
    ref, valid = reference.render(views, rots, f, "spherical", True)
    got = reference.judge(pano, m["focal"], {"f": f}, ref, valid, True)
    for key, limit in config["limits"].items():
        assert got[key] <= limit, (key, got)
