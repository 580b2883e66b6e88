"""imagestitch_tpu_torch's native host runtime (`native/ccl.py` and its
three C++ sources) against `imagestitch_tpu.native` on the CPU.

- The port's sources are byte-for-byte copies of the JAX package's, and
  its library builds into `build/native-<hash>/`.
- On seeded inputs the port's bindings equal the JAX package's exactly:
  4-connected labels and counts, component statistics, the flood fill's
  image and count, BK maxflow labels and flow, and the band Dijkstra's
  crossings and cut cost (the same C++ code on the same bytes).
- The plain twins `_ccl_numpy` and `_flood_numpy` equal the native code
  exactly (both number components in raster order of their first pixel).
- A corridor whose cost arrays do not fit raises ValueError.
- `have_native()` says what the JAX package's says where g++ builds the
  library, and False when the library cannot be built.
"""

import filecmp
import os
import shutil

import numpy as np
import pytest

pytest.importorskip("torch")

from imagestitch_tpu.native import ccl as jccl  # noqa: E402
from imagestitch_tpu_torch.native import ccl as tccl  # noqa: E402

SOURCES = ("ccl.cpp", "maxflow.cpp", "seamdual.cpp")


@pytest.mark.parametrize("name", SOURCES)
def test_sources_are_copies(name):
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert filecmp.cmp(os.path.join(here, "imagestitch_tpu", "native", name),
                       os.path.join(here, "imagestitch_tpu_torch", "native",
                                    name), shallow=False)


def test_have_native_where_gxx_is_present():
    assert shutil.which("g++") is not None
    assert tccl.have_native() is True
    assert tccl.have_native() == jccl.have_native()


def test_have_native_false_when_the_build_fails(monkeypatch):
    def fail(build_root=None):
        raise RuntimeError("g++ not found")
    monkeypatch.setattr(tccl, "load_library", fail)
    assert tccl.have_native() is False


def test_library_builds_under_build_dir():
    lib = tccl.load_library()
    assert lib is tccl.load_library()
    built = list(tccl.BUILD_DIR.glob("native-*/" + tccl.LIB_NAME))
    assert built, "no native library under build/"


def _masks(seed, shape=(37, 53), p=0.55):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=shape) > p


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_connected_components_and_stats_equal_jax(seed):
    m = _masks(seed)
    lt, nt = tccl.connected_components(m)
    lj, nj = jccl.connected_components(m)
    assert nt == nj and np.array_equal(lt, lj)
    ct, bt = tccl.component_stats(lt, nt)
    cj, bj = jccl.component_stats(lj, nj)
    assert np.array_equal(ct, cj) and np.array_equal(bt, bj)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_twins_equal_native(seed):
    m = _masks(seed).astype(np.uint8)
    ln, nn = tccl.connected_components(m)
    lp, np_ = tccl._ccl_numpy(m)
    assert nn == np_ and np.array_equal(ln, lp)
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 3, (29, 31)).astype(np.uint8)
    a, b = img.copy(), img.copy()
    seed_yx = (14, 15)
    v = int(img[seed_yx])
    assert tccl.flood_fill(a, seed_yx, v, 7) == tccl._flood_numpy(
        b, seed_yx, v, 7)
    assert np.array_equal(a, b)


def test_flood_fill_equals_jax():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 2, (40, 40)).astype(np.uint8)
    for seed_yx in [(0, 0), (20, 13), (39, 39), (50, 0)]:
        a, b = img.copy(), img.copy()
        v = int(img[min(seed_yx[0], 39), seed_yx[1]])
        assert tccl.flood_fill(a, seed_yx, v, 9) == jccl.flood_fill(
            b, seed_yx, v, 9)
        assert np.array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grid_maxflow_equals_jax(seed):
    rng = np.random.default_rng(seed)
    h, w = 24, 31
    t = np.zeros((h, w), np.float32)
    t[:, :3] = 1e4
    t[:, -3:] = -1e4
    e = rng.uniform(0.5, 20.0, (h, w, 4)).astype(np.float32)
    e[:, 0, 0] = e[:, -1, 1] = e[0, :, 2] = e[-1, :, 3] = 0.0
    lt, ft = tccl.grid_maxflow(t, e)
    lj, fj = jccl.grid_maxflow(t, e)
    assert ft == fj and np.array_equal(lt, lj)
    assert lt[:, :3].all() and not lt[:, -3:].any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_band_dijkstra_equals_jax(seed):
    rng = np.random.default_rng(seed)
    h, w = 41, 23
    v = rng.uniform(0.0, 50.0, (h, w + 1)).astype(np.float32)
    v[:, 0] = v[:, -1] = 1e8
    hc = rng.uniform(0.0, 50.0, (h + 1, w)).astype(np.float32)
    ct, kt = tccl.band_dijkstra(v, hc)
    cj, kj = jccl.band_dijkstra(v, hc)
    assert kt == kj and np.array_equal(ct, cj)
    # a vertical cut crosses every row an odd number of times
    assert (ct.sum(axis=1) % 2 == 1).all()
    with pytest.raises(ValueError, match="does not fit"):
        tccl.band_dijkstra(v, hc[:, :-1])
