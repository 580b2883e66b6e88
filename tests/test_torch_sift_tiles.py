"""The tile plan of the SIFT octave-maps kernel (`csrc/sift_octave.cu`)
on the CPU: its halo table, and a tile-by-tile emulation in plain torch
that computes each output tile from the base over the tile plus the base
halo only, each level over the tile plus its halo clipped to the image,
with reflect-101 at every pass by image coordinates. Assembled, the tiles
equal `sift_octave_maps_plain` bit for bit; a level read outside its
region raises, and so does every halo made one pixel smaller. The kernel
itself runs only on a card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from imagestitch_tpu_torch.ops import cuda_sift
from imagestitch_tpu_torch.ops.cuda_sift import (BORDER, dog_extrema_scores,
                                                 octave_blurs, octave_halos,
                                                 sift_octave_maps_plain)
from imagestitch_tpu_torch.ops.image import gaussian_kernel1d

CONTRAST = 0.04 * 255.0 / 3      # the default SIFT contrast on 0..255


class OutsideRegion(Exception):
    """A tile read a level outside the region its halo gives it."""


def _refl(i: torch.Tensor, n: int) -> torch.Tensor:
    i = i.abs()
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def _inside(idx: torch.Tensor, lo: int, hi: int, what: str) -> None:
    if idx.numel() and (int(idx.min()) < lo or int(idx.max()) >= hi):
        raise OutsideRegion(f"{what}: {int(idx.min())}..{int(idx.max())} "
                            f"outside [{lo}, {hi})")


def emulate_tiles(base, first, tile_hw, S=3, sigma0=1.6, halos=None):
    """(dog, score, gx, gy, gS) assembled from output tiles of `tile_hw`
    (rows, columns), each computed as the kernel computes it; `halos`
    (base, per level) replaces octave_halos'. Every level of a tile lives
    in a full-size plane that is NaN outside its clipped region."""
    H, W = base.shape
    th, tw = tile_hw
    pre, chain = octave_blurs(S, sigma0, first)
    blurs = ([pre] if pre is not None else []) + list(chain)
    hb, lv = halos or octave_halos(S, sigma0, first)
    stage = ((hb,) + tuple(lv)) if first else tuple(lv)
    nan = float("nan")
    out = [torch.full((n, H, W), nan) for n in (S + 2, S, S + 1, S + 1)]
    gs_out = torch.full((H, W), nan)
    for y0 in range(0, H, th):
        for x0 in range(0, W, tw):
            def region(h):
                return (max(0, y0 - h), min(H, y0 + th + h),
                        max(0, x0 - h), min(W, x0 + tw + h))

            cur = torch.full((H, W), nan)
            ry0, ry1, rx0, rx1 = region(stage[0])
            cur[ry0:ry1, rx0:rx1] = base[ry0:ry1, rx0:rx1]
            levels = [] if first else [cur]
            for b, (k, sig) in enumerate(blurs):
                t = gaussian_kernel1d(k, sig)
                r = (k - 1) // 2
                iy0, iy1, ix0, ix1 = region(stage[b])
                oy0, oy1, ox0, ox1 = region(stage[b + 1])
                ys = torch.arange(oy0, oy1)
                xs = _refl(torch.arange(ox0 - r, ox1 + r), W)
                rows = [_refl(ys - r + j, H) for j in range(k)]
                _inside(torch.cat(rows), iy0, iy1, f"blur {b} rows")
                _inside(xs, ix0, ix1, f"blur {b} columns")
                acc = t[0] * cur[rows[0]][:, xs]            # vertical
                for j in range(1, k):
                    acc = acc + t[j] * cur[rows[j]][:, xs]
                n = ox1 - ox0
                o = t[0] * acc[:, 0:n]                      # horizontal
                for j in range(1, k):
                    o = o + t[j] * acc[:, j:j + n]
                cur = torch.full((H, W), nan)
                cur[oy0:oy1, ox0:ox1] = o
                levels.append(cur)

            ty1, tx1 = min(H, y0 + th), min(W, x0 + tw)
            tile = (slice(y0, ty1), slice(x0, tx1))
            dog = torch.stack([levels[i + 1] - levels[i]
                               for i in range(S + 2)])
            out[0][(slice(None),) + tile] = dog[(slice(None),) + tile]
            yy, xx = torch.arange(y0, ty1), torch.arange(x0, tx1)
            yp, ym = yy.add(1).clamp(max=H - 1), yy.sub(1).clamp(min=0)
            xp, xm = xx.add(1).clamp(max=W - 1), xx.sub(1).clamp(min=0)
            for li in range(1, S + 2):
                ly0, ly1, lx0, lx1 = region(stage[li + first])
                _inside(torch.cat([yp, ym]), ly0, ly1, f"grad {li} rows")
                _inside(torch.cat([xp, xm]), lx0, lx1, f"grad {li} columns")
                L = levels[li]
                out[2][li - 1][tile] = 0.5 * (L[yy][:, xp] - L[yy][:, xm])
                out[3][li - 1][tile] = 0.5 * (L[yp][:, xx] - L[ym][:, xx])
            gs_out[tile] = levels[S][tile]
            # the 26-neighbour test reads every DoG layer at +-1 around
            # the tile's interior pixels
            iy0, ix0 = max(y0, BORDER), max(x0, BORDER)
            iy = torch.arange(iy0, max(iy0, min(ty1, H - BORDER)))
            ix = torch.arange(ix0, max(ix0, min(tx1, W - BORDER)))
            if iy.numel() and ix.numel():
                ly0, ly1, lx0, lx1 = region(stage[-1])
                _inside(torch.cat([iy - 1, iy + 1]), ly0, ly1, "DoG rows")
                _inside(torch.cat([ix - 1, ix + 1]), lx0, lx1, "DoG columns")
            score = dog_extrema_scores(dog, CONTRAST)[1:S + 1]
            out[1][(slice(None),) + tile] = score[(slice(None),) + tile]
    return out[0], out[1], out[2], out[3], gs_out


def _base(shape, seed=0):
    """8x8 cells of seeded uniform intensity: extrema at the cells'
    corners and edges, as the card tests use."""
    rng = np.random.default_rng(seed + sum(shape))
    cells = rng.uniform(0, 255, (shape[0] // 8 + 1, shape[1] // 8 + 1))
    img = np.kron(cells, np.ones((8, 8)))[:shape[0], :shape[1]]
    return torch.as_tensor(np.ascontiguousarray(img, np.float32))


@pytest.mark.parametrize("first,want", [
    (True, (33, (30, 26, 21, 15, 8, 1))),
    (False, (30, (30, 26, 21, 15, 8, 1)))], ids=["first", "later"])
def test_octave_halos_default(first, want):
    """S = 3, sigma0 = 1.6: taps 7 (pre-blur), 9, 11, 13, 15, 15."""
    pre, chain = octave_blurs(3, 1.6, first)
    assert [k for k, _ in chain] == [9, 11, 13, 15, 15]
    assert (pre[0] if pre else None) == (7 if first else None)
    assert octave_halos(3, 1.6, first) == want


@pytest.mark.parametrize("S", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("sigma0", [1.6, 3.2])
def test_octave_halos_follow_the_taps(S, sigma0):
    """Each level's halo is 1 plus the radii of the blurs after it; the
    base's adds the pre-blur's radius on the first octave."""
    for first in (True, False):
        pre, chain = octave_blurs(S, sigma0, first)
        hb, lv = octave_halos(S, sigma0, first)
        radii = [(k - 1) // 2 for k, _ in chain]
        assert len(lv) == S + 3
        assert lv == tuple(1 + sum(radii[i:]) for i in range(S + 3))
        assert hb == lv[0] + (3 if first else 0)


@pytest.mark.parametrize("shape,first", [((96, 160), True),
                                         ((67, 121), False),
                                         ((41, 75), True),
                                         ((41, 75), False)],
                         ids=["96x160-first", "67x121-later",
                              "41x75-first", "41x75-later"])
@pytest.mark.parametrize("tile", ["kernel", "16x32", "larger"])
def test_tiles_equal_plain(shape, first, tile):
    """The kernel's tile shapes (TILES), a small one and one larger than
    the image: the assembled tiles equal the plain version bit for bit."""
    base = _base(shape)
    tiles = {"kernel": [(th, tw) for tw, th, *_ in cuda_sift.TILES],
             "16x32": [(16, 32)], "larger": [(256, 256)]}[tile]
    want = sift_octave_maps_plain(base, first, 3, 1.6, CONTRAST)
    assert int((want[1] > 0).sum()) > 0
    for tile_hw in tiles:
        got = emulate_tiles(base, first, tile_hw)
        for a, b in zip(got, want):
            assert torch.equal(a, b), tile_hw


def test_tiles_equal_plain_largest_halos():
    """S = 6 at sigma0 = 6.4 (every chained blur at 15 taps): the widest
    halos the kernel takes, on an image smaller than two halos."""
    base = _base((90, 100), seed=3)
    hb, lv = octave_halos(6, 6.4, True)
    assert (hb, lv[0]) == (60, 57)
    want = sift_octave_maps_plain(base, True, 6, 6.4, CONTRAST)
    got = emulate_tiles(base, True, (32, 32), S=6, sigma0=6.4)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("first", [True, False], ids=["first", "later"])
def test_every_halo_is_needed(first):
    """With any one stage's halo a pixel smaller, some tile reads that
    stage outside its region."""
    base = _base((67, 121))
    hb, lv = octave_halos(3, 1.6, first)
    stage = [hb] + list(lv) if first else list(lv)
    for i in range(len(stage)):
        cut = list(stage)
        cut[i] -= 1
        halos = (cut[0], tuple(cut[1:])) if first else (cut[0], tuple(cut))
        with pytest.raises(OutsideRegion):
            emulate_tiles(base, first, (32, 64), halos=halos)


def test_tile_variant_by_octave():
    """On a 132-multiprocessor card the 1080p octaves take 64x64 tiles
    (510 and 135 of them) and then 32x32 (40 and 12 64x64 tiles would be
    a lone partial wave); a halo past 33 px takes the 60-px frame, past
    60 none."""
    shapes = cuda_sift.octave_shapes(1080, 1920, 4)
    assert [cuda_sift.tile_variant(h, w, 33, 132) for h, w in shapes] == \
        [0, 0, 1, 1]
    assert cuda_sift.TILES[0][:2] == (64, 64)
    assert cuda_sift.TILES[1][:2] == (32, 32)
    hb, _ = octave_halos(5, 1.6, True)
    assert hb == 34 and cuda_sift.tile_variant(1080, 1920, hb, 132) == 2
    assert cuda_sift.tile_variant(90, 100, 60, 132) == 2
    with pytest.raises(ValueError):
        cuda_sift.tile_variant(90, 100, 61, 132)
