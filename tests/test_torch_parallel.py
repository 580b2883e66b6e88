"""imagestitch_tpu_torch's mesh entry points (`parallel.mesh`, `parallel.
batch.stitch_pairs_sharded`, `parallel.pano`) against `imagestitch_tpu.
parallel` on the CPU (the kernels' plain versions), at the JAX package's
own test size and configuration (`tests/test_parallel.py`: 144x192 views,
TINY). The port's meshes are `[torch.device("cpu")] * k`, the counterpart
of the JAX tests' 8-device virtual CPU mesh; the JAX references are
computed once, in a module fixture, with their draws injected into the
port (a pair takes its key's draws, a chain pair (i, j) the key folded as
JAX's chain folds it).

Tolerances, each with its reason:
- the sharded batch against JAX's on the 8-device mesh: those of
  `tests/test_torch_batch.py` (equal corners, counts and h_valid;
  canvases within 0.5 on average and 30 at the 0.999 quantile), since
  JAX's vmapped linear algebra rounds apart from its single-pair program
  (`tests/test_parallel.py:38-54`); but the focal within 1e-2, the
  pipeline's translation-pair tolerance (ROADMAP Queue C): these are
  translation pairs, where the bundle adjustment's stop moves with
  float32 rounding, and on the JAX test's 8 pairs the port and JAX stood
  up to 4.8e-3 apart (pairs 4 and 7), where the batch test's 3 pairs
  hold 1e-3;
- the chain panorama against JAX's on a panning camera: those of
  `tests/test_torch_chain.py` (counts, h_valid, reachable and corner
  equal; focal within 1e-3; ROIs within 0.5 px; valid IoU >= 0.999; PSNR
  >= 40 dB where both cover). A panning camera, because on a near-pure
  translation the bundle adjustment's stop moves by percents with float32
  rounding (ROADMAP Queue C);
- the independent pair seams against JAX's `_independent_pair_seams` on
  the same canvases, and every split against the unsplit run in the port:
  bit for bit (the same operations on the same inputs: the splits change
  no per-view or per-pair shape, and the draws are taken in pair order
  before the split).
"""

import dataclasses
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from imagestitch_tpu.config import (BlendConfig, CameraConfig,  # noqa
                                    DetectorConfig, MatcherConfig,
                                    PipelineConfig, RansacConfig)
from imagestitch_tpu import parallel as jpar  # noqa: E402
from imagestitch_tpu.parallel.pano import (  # noqa: E402
    _independent_pair_seams as j_pair_seams)
from imagestitch_tpu.utils.io import synthetic_pair  # noqa: E402
from imagestitch_tpu_torch import parallel as tpar  # noqa: E402
from imagestitch_tpu_torch import pipeline as tpipe  # noqa: E402
from imagestitch_tpu_torch.convert import config_from_dict  # noqa: E402
from imagestitch_tpu_torch.geometry import affine as taffine  # noqa: E402
from imagestitch_tpu_torch.geometry import ransac as transac  # noqa: E402
from imagestitch_tpu_torch.ops import (cuda_build, cuda_detect,  # noqa
                                       cuda_sift, cuda_slab_probe,
                                       cuda_warp)
from imagestitch_tpu_torch.parallel import batch as tbatch  # noqa: E402
from imagestitch_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from imagestitch_tpu_torch.parallel import pano as tpano  # noqa: E402
from imagestitch_tpu_torch.utils import io as tio  # noqa: E402

from test_torch_chain import chain_draws, pair_draws  # noqa: E402

torch.set_num_threads(2)

# tests/test_parallel.py's configuration
TINY = PipelineConfig(
    detector=DetectorConfig(nfeatures=96, max_keypoints=288, nlevels=3),
    matcher=MatcherConfig(max_matches=96),
    ransac=RansacConfig(num_hypotheses=128),
    camera=CameraConfig(ba_iters=4),
    blend=BlendConfig(num_bands=2),
)
VERT = TINY.replace(seam=dataclasses.replace(TINY.seam, orient="vertical"))
CPU = torch.device("cpu")


def _tcfg(cfg):
    return config_from_dict(dataclasses.asdict(cfg))


def _cpu_mesh(axes):
    return tpar.make_mesh(axes, [CPU] * 8)


def _pairs(batch, seed=1):
    return np.stack([np.stack(synthetic_pair(144, 192, overlap=0.5,
                                             seed=seed + b)[:2])
                     for b in range(batch)])


def _pan(n=4):
    return tio.synthetic_pan_sequence(n, 144, 192)


def _triple():
    """Views at 0.7 overlap: view i+2 still overlaps view i."""
    return tio.synthetic_sequence(4, 144, 192, overlap=0.7, seed=8)[0]


def _front(views, cfg):
    """The port's chain front on the CPU with a seeded generator."""
    g = torch.Generator().manual_seed(0)
    return tpipe.stitch_chain_front_impl(
        torch.as_tensor(np.stack(views)).float(), cfg, generator=g)


def _jax_sharded():
    keys = jax.random.split(jax.random.key(1), 8)
    out = jpar.stitch_pairs_sharded(_pairs(8), keys,
                                    jpar.make_mesh({"data": 8}), TINY)
    return keys, jax.tree.map(np.asarray, out)


def _jax_pano():
    imgs = jnp.asarray(np.stack(_pan()), jnp.float32)
    return jax.tree.map(np.asarray,
                        jpar.stitch_chain_pano(imgs, jax.random.key(0), VERT))


def _jax_triple_seams():
    warped, masks, _, _ = _front(_triple(), _tcfg(VERT))
    fn = jax.jit(lambda w, m: j_pair_seams(w, m, VERT, 256))
    return np.asarray(fn(jnp.asarray(warped.numpy()),
                         jnp.asarray(masks.numpy())))


@pytest.fixture(scope="module")
def jref():
    """The JAX references, their three programs compiled in threads."""
    with ThreadPoolExecutor(3) as ex:
        sharded = ex.submit(_jax_sharded)
        pano = ex.submit(_jax_pano)
        seams = ex.submit(_jax_triple_seams)
        return dict(sharded=sharded.result(), pano=pano.result(),
                    seams=seams.result())


def _equal(a, b):
    """Outputs (pano, valid, corner, metrics) equal bit for bit."""
    for x, y in zip(a[:3], b[:3]):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert sorted(a[3]) == sorted(b[3])
    for k in a[3]:
        assert torch.equal(a[3][k], b[3][k]), k


# ---- the mesh ----------------------------------------------------------


def test_make_mesh_shape_and_error(monkeypatch):
    mesh = _cpu_mesh({"data": 4, "model": 2})
    assert mesh.shape == {"data": 4, "model": 2}
    assert mesh.devices.shape == (4, 2) and mesh.devices.size == 8
    assert mesh.axis_names == ("data", "model")
    assert mesh.axis_devices("model") == [CPU, CPU]
    assert len(mesh.axis_devices("data")) == 4
    assert mesh.row("data", 3).shape == {"data": 1, "model": 2}
    with pytest.raises(ValueError, match="mesh needs 16 devices, have 8"):
        _cpu_mesh({"data": 16})
    # no card and no devices: raise, as the entry points' default does
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.make_mesh({"data": 1})


def test_use_mesh_and_data_sharding():
    mesh = _cpu_mesh({"data": 3})
    assert tmesh.current_mesh() is None and tmesh.model_devices() == []
    with tpar.use_mesh(mesh):
        assert tmesh.current_mesh() is mesh
        assert tmesh.model_devices() == [CPU]     # no "model" axis
    assert tmesh.current_mesh() is None
    sh = tpar.data_sharding(mesh, 2, dim=1)
    x = torch.arange(14.0).reshape(2, 7)
    parts = sh.split(x)
    assert [p.shape[1] for p in parts] == [3, 2, 2]
    assert torch.equal(sh.gather(parts, CPU), x)
    with pytest.raises(ValueError):
        sh.split(x[0])
    assert tmesh.chunk_ranges(2, 4) == [(0, 1), (1, 2), (2, 2), (2, 2)]


def test_run_on_devices_threads_per_distinct_device():
    """One worker thread per distinct device, each running its device's
    jobs in order under the caller's active mesh; one device: the calling
    thread. Results come back in job order."""
    mesh = _cpu_mesh({"data": 2})
    other = torch.device("cpu", 0)     # distinct from CPU as a device
    seen = []
    both = threading.Barrier(2)

    def job(i, meet=False):
        if meet:                       # returns only if the other runs too
            both.wait(timeout=30)
        seen.append((i, threading.get_ident(), tmesh.current_mesh()))
        return i

    with tpar.use_mesh(mesh):
        out = tmesh.run_on_devices([(CPU, lambda: job(0, True)),
                                    (other, lambda: job(1, True)),
                                    (CPU, lambda: job(2))])
    assert out == [0, 1, 2]
    ident = {i: t for i, t, _ in seen}
    assert ident[0] == ident[2] != ident[1]
    assert [i for i, _, _ in seen if ident[i] == ident[0]] == [0, 2]
    assert all(m is mesh for _, _, m in seen)
    seen.clear()
    tmesh.run_on_devices([(CPU, lambda: job(0)), (CPU, lambda: job(1))])
    assert {t for _, t, _ in seen} == {threading.get_ident()}


@pytest.mark.parametrize("module", [cuda_detect, cuda_warp, cuda_sift,
                                    cuda_slab_probe],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_launch_count_is_exact_across_threads(module):
    """Two threads counting launches through a wrapper's counter, with the
    interpreter switching threads as often as it can: no update is
    lost."""
    n = 20000
    start = module.launch_count
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            cuda_build.count_launch(vars(module)) for _ in range(n)])
            for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert module.launch_count == start + 2 * n


# ---- the RANSAC "model" axis -------------------------------------------


def _tied_counts(B, N, seed):
    """(B, 3, 3) stand-in hypotheses whose [0, 0] entry is how many of the
    first points are inliers: counts drawn from few values, so the first
    maximum is tied many times across chunks; some hypotheses not ok."""
    rng = np.random.default_rng(seed)
    Hs = torch.zeros((B, 3, 3))
    Hs[:, 0, 0] = torch.as_tensor(rng.integers(0, 4, B) + N - 4,
                                  dtype=torch.float32)
    ok = torch.as_tensor(rng.random(B) > 0.2)
    return Hs, ok


def _prefix_errors(H, src, dst):
    idx = torch.arange(src.shape[0], dtype=torch.float32)
    return torch.where(idx[None, :] < H[:, 0, 0, None], 0.0, 100.0)


@pytest.mark.parametrize("k", [2, 3, 5, 8])
def test_model_axis_picks_the_first_maximum(k):
    B, N = 37, 12
    src = torch.zeros((N, 2))
    mask = torch.ones(N, dtype=torch.bool)
    for seed in range(20):
        Hs, ok = _tied_counts(B, N, seed)
        ref = transac.score_hypotheses(Hs, ok, src, src, mask, 1.0,
                                       _prefix_errors)
        with tpar.use_mesh(_cpu_mesh({"model": k})):
            got = transac.score_hypotheses(Hs, ok, src, src, mask, 1.0,
                                           _prefix_errors)
        for r, g in zip(ref, got):
            assert torch.equal(r, g), seed


@pytest.mark.parametrize("engine", ["homography", "affine_partial",
                                    "affine"])
def test_model_axis_leaves_ransac_unchanged(engine, monkeypatch):
    """find_homography / find_affine under a mesh with a 2- or 3-device
    "model" axis: the hypotheses are scored in 2 or 3 chunks, and the
    result equals the unsplit engine's bit for bit."""
    rng = np.random.default_rng(3)
    N = 96
    src = torch.as_tensor(rng.uniform(-80, 80, (N, 2)), dtype=torch.float32)
    A = np.array([[1.02, -0.05, 4.0], [0.04, 0.98, -3.0], [1e-4, 2e-4, 1]])
    ph = np.c_[src.numpy(), np.ones(N)] @ A.T
    dst = torch.as_tensor(ph[:, :2] / ph[:, 2:] + rng.normal(0, 0.5, (N, 2)),
                          dtype=torch.float32)
    dst[::5] += torch.as_tensor(rng.uniform(-40, 40, (len(dst[::5]), 2)),
                                dtype=torch.float32)
    mask = torch.as_tensor(rng.random(N) > 0.1)
    cfg = _tcfg(TINY).ransac
    calls = []
    inner = transac._score_chunk
    monkeypatch.setattr(transac, "_score_chunk",
                        lambda *a: calls.append(1) or inner(*a))
    if engine == "homography":
        u = torch.rand((cfg.num_hypotheses, 4),
                       generator=torch.Generator().manual_seed(0))

        def run():
            return transac.find_homography(src, dst, mask, cfg, u=u)
    else:
        p = 2 if engine == "affine_partial" else 3
        u = torch.rand((cfg.num_hypotheses, p),
                       generator=torch.Generator().manual_seed(0))

        def run():
            return taffine.find_affine(src, dst, mask, cfg,
                                       partial=p == 2, u=u)
    ref = run()
    assert len(calls) == 1 and bool(ref.ok)
    for k in (2, 3):
        calls.clear()
        with tpar.use_mesh(_cpu_mesh({"data": 1, "model": k})):
            got = run()
        assert len(calls) == k
        for f in dataclasses.fields(ref):
            assert torch.equal(getattr(ref, f.name), getattr(got, f.name))


# ---- stitch_pairs_sharded ----------------------------------------------


def test_sharded_data_mesh_matches_jax(jref):
    keys, (pj, vj, cj, mj) = jref["sharded"]
    draws = {b: pair_draws(keys[b], TINY.ransac.num_hypotheses)
             for b in range(8)}
    pt, vt, ct, mt = tpar.stitch_pairs_sharded(
        _pairs(8), _cpu_mesh({"data": 8}), _tcfg(TINY), draws=draws)
    assert pt.shape == pj.shape and vt.shape == vj.shape
    assert np.array_equal(ct.numpy(), cj)
    for k in ("num_inliers", "h_valid", "kpts1", "kpts2", "num_matches"):
        assert np.array_equal(mt[k].numpy(), mj[k]), k
    assert bool(mt["h_valid"].all())
    np.testing.assert_allclose(mt["focal"].numpy(), mj["focal"], rtol=1e-2)
    for b in range(8):
        d = np.abs(pt[b].numpy() - pj[b])
        assert d.mean() < 0.5
        assert np.quantile(d, 0.999) < 30.0


@pytest.fixture(scope="module")
def batched():
    """The port's unsplit batch of 4 pairs, its draws from seed 3."""
    return tpar.stitch_pairs_batched(_pairs(4, seed=9), _tcfg(TINY), seed=3,
                                     device="cpu")


@pytest.mark.parametrize("axes", [{"data": 4, "model": 2}, {"data": 3},
                                  {"data": 8}, {"data": 1, "model": 8}],
                         ids=str)
def test_sharded_equals_batched(batched, axes, monkeypatch):
    """The same seed through the split batch: bit for bit, with K1's and
    K2's wrappers called once per non-empty data shard."""
    calls = {"detect": 0, "warp": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tbatch, "detect_batched",
                        counting("detect", tbatch.detect_batched))
    monkeypatch.setattr(tpipe, "warp_batched",
                        counting("warp", tpipe.warp_batched))
    out = tpar.stitch_pairs_sharded(_pairs(4, seed=9), _cpu_mesh(axes),
                                    _tcfg(TINY), seed=3)
    shards = min(axes["data"], 4)
    assert calls == {"detect": shards, "warp": shards}
    _equal(out, batched)


def test_sharded_threads_on_distinct_devices(batched):
    """A mesh of two distinct devices runs its shards in two threads at
    once: the same batch."""
    mesh = tpar.make_mesh({"data": 2}, [CPU, torch.device("cpu", 0)])
    _equal(tpar.stitch_pairs_sharded(_pairs(4, seed=9), mesh, _tcfg(TINY),
                                     seed=3), batched)


def test_sharded_host_seam_raises_and_pins_vertical():
    pairs = _pairs(2)
    mesh = _cpu_mesh({"data": 2})
    for seam_kw in (dict(kind="graphcut"), dict(kind="graphcut_colorgrad"),
                    dict(kind="dp_color", full_components=True)):
        cfg = _tcfg(TINY.replace(seam=dataclasses.replace(TINY.seam,
                                                          **seam_kw)))
        with pytest.raises(ValueError, match="host"):
            tpar.stitch_pairs_sharded(pairs, mesh, cfg)
    assert TINY.seam.orient == "auto"
    _equal(tpar.stitch_pairs_sharded(pairs, mesh, _tcfg(TINY), seed=4),
           tpar.stitch_pairs_sharded(pairs, mesh, _tcfg(VERT), seed=4))


# ---- the chain panorama ------------------------------------------------


@pytest.fixture(scope="module")
def pano():
    """The port's stitch_chain_pano on the panning views with JAX's chain
    draws."""
    draws = chain_draws(jax.random.key(0), 4, TINY.ransac.num_hypotheses,
                        False)
    return tpar.stitch_chain_pano(_pan(), _tcfg(VERT), device="cpu",
                                  draws=draws), draws


def _iou(a, b):
    return (a & b).sum() / max((a | b).sum(), 1)


def test_chain_pano_matches_jax(jref, pano):
    pj, vj, cj, mj = jref["pano"]
    (pt, vt, ct, mt), _ = pano
    pt, vt, ct = pt.numpy(), vt.numpy(), ct.numpy()
    assert pt.shape == pj.shape and sorted(mt) == sorted(mj)
    assert np.array_equal(ct, cj)
    for k in ("num_inliers", "h_valid", "reachable", "canvas_overflow"):
        assert np.array_equal(mt[k].numpy(), mj[k]), k
    assert bool(mt["h_valid"].all() and mt["reachable"].all())
    np.testing.assert_allclose(float(mt["focal"]), float(mj["focal"]),
                               rtol=1e-3)
    assert np.abs(mt["roi_uv"].numpy() - mj["roi_uv"]).max() <= 0.5
    assert _iou(vt, vj) >= 0.999
    both = vt & vj
    mse = np.mean((pt[both] - pj[both]) ** 2)
    assert 10 * np.log10(255.0 ** 2 / max(mse, 1e-12)) >= 40.0


@pytest.mark.parametrize("axes", [{"data": 8}, {"data": 3},
                                  {"data": 2, "model": 2}], ids=str)
def test_chain_pano_sharded_equals_unsharded(pano, axes, monkeypatch):
    """Bit for bit, with K1's and K2's wrappers called once per non-empty
    data shard of the 4 views; without injected draws too (the generator's
    draws are taken in pair order before the split)."""
    (ref, draws) = pano
    calls = {"detect": 0, "warp": 0}
    inner_d, inner_w = tpano.detect_batched, tpano.warp_views

    def det(*a, **kw):
        calls["detect"] += 1
        return inner_d(*a, **kw)

    def warp(*a, **kw):
        calls["warp"] += 1
        return inner_w(*a, **kw)

    monkeypatch.setattr(tpano, "detect_batched", det)
    monkeypatch.setattr(tpano, "warp_views", warp)
    mesh = _cpu_mesh(axes)
    _equal(tpar.stitch_chain_pano_sharded(_pan(), mesh, _tcfg(VERT),
                                          draws=draws), ref)
    shards = min(axes["data"], 4)
    assert calls == {"detect": shards, "warp": shards}
    _equal(tpar.stitch_chain_pano_sharded(_pan(), mesh, _tcfg(VERT),
                                          seed=5),
           tpar.stitch_chain_pano(_pan(), _tcfg(VERT), seed=5,
                                  device="cpu"))


def test_chain_pano_equals_sequential_schedule():
    """Empty triple overlaps (50% overlap): the independent schedule's
    masks equal stitch_chain_impl's sequential ones, and so the pano."""
    views, _ = tio.synthetic_sequence(4, 144, 192, overlap=0.5, seed=6)
    p_a, v_a, c_a, _ = tpar.stitch_chain_pano(views, _tcfg(VERT), seed=2,
                                              device="cpu")
    g = torch.Generator().manual_seed(2)
    p_b, v_b, c_b, _ = tpipe.stitch_chain_impl(
        torch.as_tensor(np.stack(views)).float(), _tcfg(VERT), generator=g)
    assert torch.equal(v_a, v_b) and torch.equal(c_a, c_b)
    assert float((p_a - p_b).abs().max()) <= 1e-3


def test_triple_overlap_seams_partition_coverage(jref):
    """At 70% overlap view i+2 overlaps view i: the independent schedule's
    masks still partition the coverage, and equal JAX's on the same
    canvases."""
    warped, masks, _, _ = _front(_triple(), _tcfg(VERT))
    assert int((masks.sum(0) >= 3).sum()) > 0
    owned = tpano._independent_pair_seams(warped, masks, _tcfg(VERT), 256)
    assert torch.equal(owned.sum(0), masks.any(0).to(owned.sum(0).dtype))
    assert not bool((owned & ~masks).any())
    assert np.array_equal(owned.numpy(), jref["seams"])
    steps = tpano.MeshSteps(_cpu_mesh({"data": 2}))
    assert torch.equal(tpano._independent_pair_seams(
        warped, masks, _tcfg(VERT), 256, steps), owned)


def test_chain_pano_refuses_host_seams_and_ramp():
    views = _pan(3)
    mesh = _cpu_mesh({"data": 2})
    for seam_kw, blend in ((dict(kind="graphcut"), "feather"),
                           (dict(kind="dp_color", full_components=True),
                            "feather"),
                           ({}, "ramp")):
        cfg = _tcfg(VERT.replace(
            seam=dataclasses.replace(VERT.seam, **seam_kw),
            blend=dataclasses.replace(VERT.blend, kind=blend)))
        for call in (lambda: tpar.stitch_chain_pano(views, cfg,
                                                    device="cpu"),
                     lambda: tpar.stitch_chain_pano_sharded(views, mesh,
                                                            cfg)):
            with pytest.raises(ValueError,
                               match="ramp" if blend == "ramp" else "host"):
                call()


# ---- the host-seam pair ------------------------------------------------


@pytest.mark.parametrize("seam_megapix", [-1.0, 0.01])
def test_hostseam_sharded_equals_stitch_pair_split(seam_megapix):
    """The graph-cut pair under a {"data": 2, "model": 2} mesh equals
    stitch_pair's split (its front and `_host_seam_blend`) on the same
    draws; an on-device seam raises."""
    a, b, _ = synthetic_pair(144, 192, overlap=0.5, seed=3)
    cfg = _tcfg(TINY.replace(seam=dataclasses.replace(
        TINY.seam, kind="graphcut", seam_megapix=seam_megapix)))
    mesh = _cpu_mesh({"data": 2, "model": 2})
    got = tpar.stitch_pair_hostseam_sharded(a, b, mesh, cfg, seed=7)
    g = torch.Generator().manual_seed(7)
    warped, masks, corner, m = tpipe.stitch_pair_front_impl(
        torch.as_tensor(a), torch.as_tensor(b), cfg, generator=g)
    pano, valid, _ = tpipe._host_seam_blend(warped, masks, cfg)
    _equal(got, (pano, valid, corner, m))
    with pytest.raises(ValueError, match="on-device"):
        tpar.stitch_pair_hostseam_sharded(a, b, mesh, _tcfg(TINY))


def test_parallel_exports_the_jax_list():
    assert set(jpar.__all__) - {"shard_hint"} <= set(tpar.__all__)
    for name in tpar.__all__:
        assert callable(getattr(tpar, name)), name
