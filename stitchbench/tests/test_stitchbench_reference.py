"""The plain reference on small shapes, against geometry known in closed
form, and the comparison against panoramas altered on purpose."""

from __future__ import annotations

import math

import numpy as np
import torch

from stitchbench import find, reference, scenes

H, W = 120, 200
F = 0.9 * W
DEV = torch.device("cpu")


def _pair(yaw=20.0, pitch=0.0, roll=0.0, seed=3, scale=1):
    rots, half_span = find.part("poses", "pair").cameras((yaw, pitch, roll),
                                                         2)
    views = scenes.render_views(rots, half_span, H * scale, W * scale,
                                F * scale, np.random.default_rng(seed), DEV)
    return views, rots


def test_views_see_the_scene_through_the_truth():
    rng = np.random.default_rng(5)
    scene = scenes.render_scene(200, 400, rng, DEV)
    rots, _ = find.part("poses", "pair").cameras((10.0, 1.0, -1.5), 2)
    views = scenes.sample_views(scene, rots, F, H, W)
    ks = scenes.intrinsics(F, 200, 400)
    kinv = np.linalg.inv(scenes.intrinsics(F, H, W))
    for i, (y, x) in enumerate([(10, 17), (60, 100), (111, 180)]):
        v = i % 2
        p = ks @ rots[v].T @ kinv @ np.array([x, y, 1.0])
        want = scenes.bilinear(scene, torch.tensor(p[0] / p[2]),
                               torch.tensor(p[1] / p[2]))
        got = views[v, y, x].to(torch.float32)
        assert torch.all((want.clamp(0, 255).floor() - got).abs() <= 1)


def test_reference_extent_is_the_surface_span():
    """A pure yaw pair on the cylinder spans f x (yaw + the field of view)
    across and the view's height (its corners' heights on the cylinder
    are lower) down."""
    views, rots = _pair(yaw=20.0)
    pano, valid = reference.render(views, rots, F, "cylindrical")
    span = F * (math.radians(20.0) + 2 * math.atan((W - 1) / 2 / F))
    assert abs(pano.shape[1] - span) <= 2
    assert abs(pano.shape[0] - H) <= 2
    assert valid.all(dim=1).any() and valid[:, 0].any()


def test_the_frame_only_moves_the_panorama_sideways():
    """Rendered in view 0's frame or in the world frame, a pure-yaw pair
    gives the same panorama up to a horizontal offset."""
    views, rots = _pair(yaw=24.0)
    a, _ = reference.render(views, rots, F, "cylindrical", False)
    b, _ = reference.render(views, rots, F, "cylindrical", True)
    assert abs(a.shape[1] - b.shape[1]) <= 1 and a.shape[0] == b.shape[0]


def test_compare_holds_the_reference_to_itself_and_catches_faults():
    views, rots = _pair(yaw=18.0, pitch=1.0, roll=-1.5, scale=3)
    ref, valid = reference.render(views, rots, 3 * F, "cylindrical")
    own = ref.clamp(0, 255).to(torch.uint8)
    same = reference.compare(own, ref, valid)
    assert same["tile_mad"] < 1.5 and same["align_resid_px"] < 0.5
    hh, ww = own.shape[:2]
    blk = own.clone()
    blk[hh // 4:hh // 2, ww // 4:ww // 2] = 255 - blk[hh // 4:hh // 2,
                                                      ww // 4:ww // 2]
    assert reference.compare(blk, ref, valid)["tile_mad"] > 20
    dark = (own.to(torch.float32) * 0.8).to(torch.uint8)
    assert reference.compare(dark, ref, valid)["tile_mad"] > 10


def test_judge_numbers():
    views, rots = _pair(yaw=18.0)
    ref, valid = reference.render(views, rots, F, "cylindrical")
    pano = ref.clamp(0, 255).to(torch.uint8).numpy()
    got = reference.judge(pano, 1.01 * F, {"f": F}, ref, valid, False)
    assert got["focal_rel_err"] == __import__("pytest").approx(0.01)
    assert got["extent_rel_err"] == 0.0
    cut = pano[:, : pano.shape[1] * 9 // 10]
    got = reference.judge(cut, F, {"f": F}, ref, valid, False)
    assert got["extent_rel_err"] >= 0.09
