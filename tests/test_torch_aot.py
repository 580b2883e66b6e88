"""imagestitch_tpu_torch's ahead-of-time cache (`aot`) on the CPU, case for
case with `tests/test_aot.py`: the export/load round trip and its cache
hit, invalidation by shape, tag and source hash, a corrupt blob rebuilt,
`clear`; then `stitch_pair_program`, whose libraries (the native seam
runtime here; the CUDA kernels too on a card) are built into the named
directory once (`was_cached` False, then True) and whose call equals
`stitch_pair_impl` bit for bit (the same function on the same inputs)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from imagestitch_tpu_torch import aot  # noqa: E402
from imagestitch_tpu_torch.config import PipelineConfig  # noqa: E402
from imagestitch_tpu_torch.pipeline import stitch_pair_impl  # noqa: E402
from imagestitch_tpu_torch.utils.io import synthetic_pair  # noqa: E402


def _fn(x, y):
    return (x @ y).sum(dim=1), x + 1.0


class TestCachedExport:
    def test_round_trip_and_hit(self, tmp_path):
        d = str(tmp_path)
        x = torch.arange(12.0).reshape(3, 4)
        y = torch.ones((4, 5))
        call, was_cached = aot.cached_export("t", _fn, (x, y), directory=d)
        assert not was_cached
        a0, b0 = call(x, y)
        call2, was_cached2 = aot.cached_export("t", _fn, (x, y), directory=d)
        assert was_cached2
        a1, b1 = call2(x, y)
        assert torch.equal(a0, a1) and torch.equal(b0, b1)
        ref = _fn(x, y)
        assert torch.equal(a0, ref[0]) and torch.equal(b0, ref[1])
        with pytest.raises((AssertionError, RuntimeError)):   # its guard
            call2(torch.ones((2, 4)), y)

    def test_shape_change_invalidates(self, tmp_path):
        d = str(tmp_path)
        y = torch.ones((4, 5))
        aot.cached_export("t", _fn, (torch.ones((3, 4)), y), directory=d)
        call, was_cached = aot.cached_export(
            "t", _fn, (torch.ones((2, 4)), y), directory=d)
        assert not was_cached
        assert call(torch.ones((2, 4)), y)[0].shape == (2,)

    def test_tag_change_invalidates(self, tmp_path):
        d = str(tmp_path)
        args = (torch.ones((3, 4)), torch.ones((4, 5)))
        aot.cached_export("t", _fn, args, directory=d)
        _, was_cached = aot.cached_export("u", _fn, args, directory=d)
        assert not was_cached

    def test_source_hash_invalidates(self, tmp_path, monkeypatch):
        d = str(tmp_path)
        args = (torch.ones((3, 4)), torch.ones((4, 5)))
        aot.cached_export("t", _fn, args, directory=d)
        monkeypatch.setattr(aot, "_package_source_hash", lambda: "edited")
        _, was_cached = aot.cached_export("t", _fn, args, directory=d)
        assert not was_cached

    def test_corrupt_blob_rebuilds(self, tmp_path):
        d = str(tmp_path)
        args = (torch.ones((3, 4)), torch.ones((4, 5)))
        aot.cached_export("t", _fn, args, directory=d)
        (blob,) = [f for f in os.listdir(d) if f.endswith(".pt2")]
        with open(os.path.join(d, blob), "wb") as f:
            f.write(b"garbage")
        call, was_cached = aot.cached_export("t", _fn, args, directory=d)
        assert not was_cached
        assert call(*args)[0].shape == (3,)
        _, was_cached = aot.cached_export("t", _fn, args, directory=d)
        assert was_cached

    def test_clear(self, tmp_path):
        d = str(tmp_path)
        aot.cached_export("t", _fn, (torch.ones((3, 4)), torch.ones((4, 2))),
                          directory=d)
        assert aot.clear(d) == 1
        assert aot.clear(d) == 0


def test_default_dir_is_ignored_build_output():
    root = os.path.dirname(os.path.dirname(os.path.abspath(aot.__file__)))
    assert aot.default_dir() == os.path.join(root, "build", "exported")


class TestStitchPairProgram:
    def test_builds_once_and_matches_stitch_pair_impl(self, tmp_path):
        d = str(tmp_path)
        H, W = 96, 128
        cfg = PipelineConfig()
        i1, i2, _ = synthetic_pair(H, W, overlap=0.4, seed=0)
        a1 = torch.as_tensor(i1).float()
        a2 = torch.as_tensor(i2).float()

        call, was_cached = aot.stitch_pair_program(H, W, cfg, directory=d,
                                                   device="cpu")
        assert not was_cached
        assert [f for f in os.listdir(d) if f.startswith("native-")]
        g = torch.Generator().manual_seed(0)
        pano, valid, corner, metrics = call(a1, a2, g)
        ref = stitch_pair_impl(a1, a2, cfg,
                               generator=torch.Generator().manual_seed(0))
        assert torch.equal(pano, ref[0]) and torch.equal(valid, ref[1])
        assert torch.equal(corner, ref[2])
        assert bool(metrics["h_valid"]) == bool(ref[3]["h_valid"])

        # second build: both libraries already on disk, the same outputs
        call2, was_cached2 = aot.stitch_pair_program(H, W, cfg, directory=d,
                                                     device="cpu")
        assert was_cached2
        g = torch.Generator().manual_seed(0)
        assert torch.equal(call2(np.asarray(i1), np.asarray(i2), g)[0], pano)
        draws = (torch.rand((2048, 4)), torch.rand((256, 4)))
        assert torch.equal(call2(a1, a2, draws)[0],
                           stitch_pair_impl(a1, a2, cfg, draws)[0])
        with pytest.raises(ValueError, match="stitches"):
            call2(a1[:64], a2[:64], draws)

        assert aot.clear(d) == 1
        _, was_cached3 = aot.stitch_pair_program(H, W, cfg, directory=d,
                                                 device="cpu")
        assert not was_cached3
