"""Image substrate: gray conversion, separable Gaussian blur, Sobel and box
filters, rectangular dilation and erosion, the bilinear and nearest remaps
(the OpenCV cvtColor / GaussianBlur / Sobel / boxFilter / dilate / erode /
remap the reference leans on) and `jax.image.resize`'s linear resize, as
plain tensor code on (H, W) or (H, W, C) float32, the layouts of
`imagestitch_tpu.ops.image`.

Every product and sum rounds on its own, in the order the JAX package
writes it (no fused multiply-adds; the resize's matrix product is the one
exception, see `_resize_axis`): on the CPU the tests compare these
functions with it bit for bit where the detector thresholds on their
values.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

_GRAY_W = (0.299, 0.587, 0.114)


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """BT.601 luma of (..., H, W, 3) RGB (cv::cvtColor coefficients)."""
    img = img.to(torch.float32)
    w = torch.tensor(_GRAY_W, dtype=torch.float32, device=img.device)
    return img[..., 0] * w[0] + img[..., 1] * w[1] + img[..., 2] * w[2]


def gaussian_kernel1d(ksize: int, sigma: float,
                      device=None) -> torch.Tensor:
    """1-D Gaussian taps with cv::getGaussianKernel semantics (float32),
    computed on the CPU for every device, so that the card blurs with the
    same taps as the CPU."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    r = (ksize - 1) / 2.0
    x = torch.arange(ksize, dtype=torch.float32) - r
    k = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    tot = k[0]
    for t in range(1, ksize):      # in sequence, as XLA:CPU sums them
        tot = tot + k[t]
    return (k / tot).to(device)


def _border_index(n: int, r: int, border: str, device) -> torch.Tensor:
    """The source index of each of the n + 2r positions of a line padded
    by r on both sides: reflect-101, reflected again past the far edge as
    `jnp.pad`'s "reflect" does ("reflect"), or the nearest edge
    ("edge")."""
    i = torch.arange(-r, n + r, device=device)
    if border == "edge" or n == 1:
        return i.clamp(0, n - 1)
    period = 2 * (n - 1)
    i = i.remainder(period)
    return torch.where(i >= n, period - i, i)


def _pad_planes(x: torch.Tensor, ry: int, rx: int, border: str
                ) -> torch.Tensor:
    """(P, H, W) padded by ry rows and rx columns on both sides with the
    border of `jnp.pad`'s mode of the same name: "reflect" (reflect-101),
    "edge" (replicate) or "constant" (zeros)."""
    H, W = x.shape[-2:]
    if border == "constant":
        return F.pad(x, (rx, rx, ry, ry))
    if border == "reflect" and ry < H and rx < W:
        return F.pad(x[None], (rx, rx, ry, ry), mode="reflect")[0]
    if border not in ("reflect", "edge"):
        raise ValueError(f"border {border!r}: 'reflect', 'edge' or "
                         "'constant'")
    return (x.index_select(-2, _border_index(H, ry, border, x.device))
            .index_select(-1, _border_index(W, rx, border, x.device)))


def sep_filter_planes(x: torch.Tensor, kx: torch.Tensor, ky: torch.Tensor,
                      border: str = "reflect") -> torch.Tensor:
    """Separable filter of (P, H, W) float32 planes, the border as
    `_pad_planes` pads it (default reflect-101): a vertical pass of shifted
    multiply-adds, then a horizontal one."""
    H, W = x.shape[-2:]
    rx = (kx.shape[0] - 1) // 2
    ry = (ky.shape[0] - 1) // 2
    p = _pad_planes(x, ry, rx, border)
    acc = ky[0] * p[:, 0:H]
    for t in range(1, ky.shape[0]):
        acc = acc + ky[t] * p[:, t:t + H]
    out = kx[0] * acc[:, :, 0:W]
    for t in range(1, kx.shape[0]):
        out = out + kx[t] * acc[:, :, t:t + W]
    return out


def _sep_filter2d(img: torch.Tensor, kx: torch.Tensor, ky: torch.Tensor,
                  border: str = "reflect") -> torch.Tensor:
    """Separable 2-D filter over (H, W) or (H, W, C) float32."""
    if img.ndim == 2:
        return sep_filter_planes(img[None], kx, ky, border)[0]
    return sep_filter_planes(img.permute(2, 0, 1), kx, ky,
                             border).permute(1, 2, 0)


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float = 2.0,
                  border: str = "reflect") -> torch.Tensor:
    """GaussianBlur of (H, W) or (H, W, C) (7x7 sigma=2 before descriptor
    sampling in the reference). `border`: "reflect" (reflect-101, OpenCV's
    default), "edge" (replicate) or "constant" (zeros)."""
    k = gaussian_kernel1d(ksize, sigma, device=img.device)
    return _sep_filter2d(img.to(torch.float32), k, k, border)


def sobel(img: torch.Tensor, dx: int, dy: int, ksize: int = 3
          ) -> torch.Tensor:
    """cv::Sobel with ksize 3 over (H, W) or (H, W, C), reflect-101."""
    assert ksize == 3 and (dx, dy) in ((1, 0), (0, 1))
    smooth = torch.tensor([1.0, 2.0, 1.0], device=img.device)
    diff = torch.tensor([-1.0, 0.0, 1.0], device=img.device)
    if dx == 1:
        return _sep_filter2d(img.to(torch.float32), diff, smooth)
    return _sep_filter2d(img.to(torch.float32), smooth, diff)


def box_filter(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """Normalized box filter of (H, W) or (H, W, C), reflect-101."""
    k = torch.full((ksize,), 1.0 / ksize, dtype=torch.float32,
                   device=img.device)
    return _sep_filter2d(img.to(torch.float32), k, k)


def _morph_max(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """Separable rectangular max filter over the last two dims with the
    asymmetric even-kernel padding (k//2 before, (k-1)//2 after) and -inf
    outside the image."""
    lead = x.shape[:-2]
    y = x.reshape((-1, 1) + x.shape[-2:])
    y = F.pad(y, (0, 0, kh // 2, (kh - 1) // 2), value=float("-inf"))
    y = F.max_pool2d(y, (kh, 1), stride=1)
    y = F.pad(y, (kw // 2, (kw - 1) // 2, 0, 0), value=float("-inf"))
    y = F.max_pool2d(y, (1, kw), stride=1)
    return y.reshape(lead + y.shape[-2:])


def _morph_min(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """The min twin of `_morph_max` (+inf outside the image)."""
    return -_morph_max(-x, kh, kw)


def dilate(img: torch.Tensor, ksize: tuple[int, int] = (3, 3)
           ) -> torch.Tensor:
    """cv::dilate with a rect kernel over (..., H, W) float32."""
    return _morph_max(img.to(torch.float32), ksize[0], ksize[1])


def erode(img: torch.Tensor, ksize: tuple[int, int] = (3, 3)
          ) -> torch.Tensor:
    """cv::erode with a rect kernel over (..., H, W) float32."""
    return _morph_min(img.to(torch.float32), ksize[0], ksize[1])


@functools.lru_cache(maxsize=64)
def _resize_taps(n_in: int, n_out: int):
    """The nonzero band of `jax.image.resize`'s "linear" weight matrix
    (scale_and_translate with antialias): a triangle kernel widened by
    1/scale when downsampling (a 2x reduction has four taps, [1, 3, 3,
    1]/8 away from the edges), each output column normalised by its sum.
    Returns (index (T, n_out) int64, weight (T, n_out) float32), input
    indices ascending; unused taps carry weight 0."""
    scale = n_out / n_in
    inv = 1.0 / scale
    ks = max(inv, 1.0)
    sf = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv - 0.5
    x = (sf[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]
         ).abs() / ks
    w = torch.clamp(1.0 - x.abs(), min=0.0)                 # (n_in, n_out)
    nz = w > 0
    first = torch.argmax(nz.to(torch.int32), dim=0)
    T = int(nz.sum(0).max())
    idx = (first[None, :] + torch.arange(T)[:, None]).clamp(max=n_in - 1)
    tw = torch.where(torch.arange(T)[:, None] < nz.sum(0)[None, :],
                     torch.gather(w, 0, idx), torch.zeros(()))
    tot = tw[0]
    for t in range(1, T):
        tot = tot + tw[t]
    tw = torch.where(tot.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                     tw / torch.where(tot != 0, tot, torch.ones(())),
                     torch.zeros(()))
    inside = (sf >= -0.5) & (sf <= n_in - 0.5)
    return idx, torch.where(inside[None, :], tw, torch.zeros(()))


def _resize_axis(x: torch.Tensor, n_out: int, axis: int) -> torch.Tensor:
    """The product with the weight matrix along `axis`, summed over each
    column's taps in ascending input order with one rounding per
    multiply-add (a sequential fused multiply-add, the order of XLA:CPU's
    dot at the test shapes): float64 holds each float32 product exactly."""
    idx, w = _resize_taps(x.shape[axis], n_out)
    idx = idx.to(x.device)
    w = w.to(device=x.device, dtype=torch.float64)
    shape = [1] * x.ndim
    shape[axis] = n_out
    acc = torch.zeros((), dtype=torch.float32, device=x.device)
    for t in range(idx.shape[0]):
        xt = torch.index_select(x, axis, idx[t]).to(torch.float64)
        acc = (xt * w[t].reshape(shape) + acc).to(torch.float32)
    return acc


def resize(img: torch.Tensor, out_hw: tuple[int, int],
           method: str = "linear") -> torch.Tensor:
    """`jax.image.resize(img, out_hw, "linear")` of (H, W) or (H, W, C)
    float32: antialiased when downsampling, half-pixel centres. The two
    axis products run in the order XLA's einsum contracts them (the order
    with fewer multiply-adds: rows first when halving with H <= W, columns
    first when doubling with H <= W)."""
    if method != "linear":
        raise NotImplementedError(f"resize method {method!r} is not ported")
    return _resize_hw(img.to(torch.float32), out_hw, 0)


def resize_planes(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """`resize` of every (H, W) plane of (P, H, W) float32 at once: the
    same products in the same order, plane by plane."""
    return _resize_hw(x.to(torch.float32), out_hw, 1)


def _resize_hw(x: torch.Tensor, out_hw: tuple[int, int], ax: int
               ) -> torch.Tensor:
    """The two axis products of `resize` over the rows (axis `ax`) and the
    columns (axis `ax` + 1)."""
    H, W = x.shape[ax:ax + 2]
    h, w = out_hw
    # XLA's einsum takes the order with fewer multiply-adds, rows first
    # on a tie
    rows_first = H * W * h + h * W * w <= H * W * w + H * w * h
    axes = [(ax, h), (ax + 1, w)] if rows_first else [(ax + 1, w), (ax, h)]
    for axis, n in axes:
        if x.shape[axis] != n:
            x = _resize_axis(x, n, axis)
    return x


def remap_bilinear(img: torch.Tensor, xmap: torch.Tensor,
                   ymap: torch.Tensor, border_value: float = 0.0):
    """Bilinear remap with clamped taps: img (H, W) or (H, W, C) float32,
    maps (H', W') source coordinates. Samples outside [0, W-1] x [0, H-1]
    get `border_value` and valid=False. Returns (out, valid)."""
    img = img.to(torch.float32)
    H, W = img.shape[:2]
    x0 = torch.floor(xmap)
    y0 = torch.floor(ymap)
    fx = xmap - x0
    fy = ymap - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    flat = img.reshape((H * W,) + img.shape[2:])

    def tap(yi, xi):
        yi = yi.clamp(0, H - 1)
        xi = xi.clamp(0, W - 1)
        return flat[yi * W + xi]

    Ia = tap(y0i, x0i)
    Ib = tap(y0i, x0i + 1)
    Ic = tap(y0i + 1, x0i)
    Id = tap(y0i + 1, x0i + 1)
    if img.ndim == 3:
        fx = fx[..., None]
        fy = fy[..., None]
    top = Ia + (Ib - Ia) * fx
    bot = Ic + (Id - Ic) * fx
    out = top + (bot - top) * fy
    valid = (xmap >= 0) & (xmap <= W - 1) & (ymap >= 0) & (ymap <= H - 1)
    vmask = valid[..., None] if img.ndim == 3 else valid
    out = torch.where(vmask, out, torch.full_like(out, border_value))
    return out, valid


def remap_nearest(img: torch.Tensor, xmap: torch.Tensor,
                  ymap: torch.Tensor, border_value: float = 0.0):
    """Nearest-neighbour remap (round half to even, as `jnp.round`):
    img (H, W) or (H, W, C), maps (H', W'). Samples whose rounded tap
    lies outside the image get `border_value` and valid=False. Returns
    (out, valid)."""
    H, W = img.shape[:2]
    xi = torch.round(xmap).to(torch.int64)
    yi = torch.round(ymap).to(torch.int64)
    flat = img.reshape((H * W,) + img.shape[2:])
    out = flat[yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)]
    valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
    vmask = valid[..., None] if img.ndim == 3 else valid
    out = torch.where(vmask, out, torch.full_like(out, border_value))
    return out, valid
