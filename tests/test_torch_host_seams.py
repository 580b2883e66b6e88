"""imagestitch_tpu_torch's host-seam split (`pipeline._host_seam_blend`,
`_host_seam_masks` and the device helpers around them) against
`imagestitch_tpu.pipeline`'s on the CPU (the kernels' plain versions),
with the JAX RANSAC draws injected.

- The split alone: on the 192x256 rotation pair's shared-frame canvases
  from JAX's jitted `stitch_pair_front` (the JAX pair test configuration),
  each host seam — the graph cut (COLOR, COLOR_GRAD; full resolution,
  where only the overlap's uint8 crop is read back, and at `seam_megapix`
  0.05) and the full DpSeamFinder (COLOR, COLOR_GRAD; also at
  `seam_megapix`) — gives seam masks EQUAL to JAX's and the same valid
  mask, and the blended canvas within 1e-3 (the same feather blend; the
  two libraries' float32 distance-transform weights and exp round apart
  in the last bits).
- The watch-list case (`imagestitch_tpu/pipeline.py:224`): with the pair's
  edge given as (1, 0), `_host_seam_masks` takes the full-canvas
  marginals in (masks[0], masks[1]) order, as JAX does: masks equal to
  JAX's, and a partition of the overlap.
- What crosses the bus, as the split's active `StageTimer` counts it
  (`readback_bytes`): N-view graph cuts read back the uint8-quantized
  canvases (1 byte a channel), the full DP the float32 ones (4 bytes).
- Entry points against JAX with the same draws: `stitch_pair` (graph
  cut and full DP; its "front" and "host_seam_blend" stages),
  `stitch_chain` (three views; the front's canvases and the split's seam
  masks), `Stitcher` (three views of a panning camera, seams along the
  spanning tree, from `dump_stages`' seams.npz; COLOR and COLOR_GRAD)
  and `StreamStitcher.calibrate` (the frozen seam masks, from whole
  float32 canvases with no edges), each with the graph cut at full
  resolution and at `seam_megapix`. The full DP along a 3-view tree runs
  in the port only: the JAX finder raises IndexError there (see
  test_torch_dp_full). The
  fronts are not bit for bit (the JAX batched detector's Harris, the
  float32 trig of the warp and the adjuster round apart in the last
  bits; see test_torch_stitcher and test_torch_chain), so the seam masks
  are held to agree on 99.5% of the covered pixels, the focal within 1e-3
  relative, the valid IoU >= 0.995 and the panos within 1.0 mean where
  both are valid (0.5 on the pair, whose fronts agree more closely).
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import imagestitch_tpu as jist  # noqa: E402
from imagestitch_tpu import config as jcfg  # noqa: E402
from imagestitch_tpu import pipeline as jpipe  # noqa: E402
from imagestitch_tpu.stream import StreamStitcher as JStream  # noqa: E402
from imagestitch_tpu.utils import io as jio  # noqa: E402
import imagestitch_tpu_torch as tist  # noqa: E402
from imagestitch_tpu_torch import pipeline as tpipe  # noqa: E402
from imagestitch_tpu_torch.convert import config_from_dict  # noqa: E402
from imagestitch_tpu_torch.utils.log import StageTimer  # noqa: E402
from imagestitch_tpu_torch.utils.io import synthetic_rotation_pair  # noqa

from test_torch_chain import (CHAIN_CFG, chain_draws, pair_draws,  # noqa
                              pan_sequence)
from test_torch_stitcher import ST_CFG, all_pair_draws  # noqa: E402

torch.set_num_threads(2)

PAIR_CFG = jcfg.PipelineConfig(
    detector=jcfg.DetectorConfig(nfeatures=256, max_keypoints=768),
    matcher=jcfg.MatcherConfig(max_matches=256),
    ransac=jcfg.RansacConfig(num_hypotheses=512),
    camera=jcfg.CameraConfig(ba_iters=10))
SEAMS = {
    "graphcut": jcfg.SeamConfig(kind="graphcut"),
    "graphcut_colorgrad": jcfg.SeamConfig(kind="graphcut_colorgrad"),
    "dp_full": jcfg.SeamConfig(kind="dp_color", full_components=True),
    "dp_full_colorgrad": jcfg.SeamConfig(kind="dp_colorgrad",
                                         full_components=True),
    "graphcut_megapix": jcfg.SeamConfig(kind="graphcut", seam_megapix=0.05),
    "dp_full_megapix": jcfg.SeamConfig(kind="dp_color",
                                       full_components=True,
                                       seam_megapix=0.05),
}
SEAM_AGREE = 0.995


def _tcfg(cfg):
    return config_from_dict(dataclasses.asdict(cfg))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _agree(a, b, cover):
    """Share of the covered pixels where two seam-mask stacks agree."""
    a, b = np.asarray(a, bool), np.asarray(b, bool)
    return float((a == b).all(axis=0)[cover].mean())


def _held(pj, vj, pt, vt):
    vj, vt = np.asarray(vj, bool), np.asarray(vt, bool)
    iou = (vj & vt).sum() / max((vj | vt).sum(), 1)
    both = vj & vt
    diff = np.abs(np.asarray(pt, np.float64) - np.asarray(pj, np.float64))
    return iou, float(diff[both].mean())


@pytest.fixture(scope="module")
def pair():
    a, b = synthetic_rotation_pair(192, 256)[:2]
    key = jax.random.key(0)
    warped, masks, _, mj = jpipe.stitch_pair_front(
        jnp.asarray(a), jnp.asarray(b), key, PAIR_CFG)
    return dict(a=a, b=b, warped=warped, masks=masks,
                draws=pair_draws(key, 512),
                focal=float(np.asarray(mj["focal"])))


@pytest.fixture(scope="module")
def splits(pair):
    out = {}
    for name, seam in SEAMS.items():
        cfg = PAIR_CFG.replace(seam=seam)
        pj, vj, sj = jpipe._host_seam_blend(pair["warped"], pair["masks"],
                                            cfg)
        timer = StageTimer("cpu")
        with timer.active():
            pt, vt, st = tpipe._host_seam_blend(
                torch.tensor(np.asarray(pair["warped"])),
                torch.tensor(np.asarray(pair["masks"])), _tcfg(cfg))
        out[name] = dict(j=(_np(pj), _np(vj), _np(sj)),
                         t=(pt.numpy(), vt.numpy(), _np(st)),
                         stages=timer.summary(), counts=timer.counts())
    return out


@pytest.mark.parametrize("name", list(SEAMS))
def test_host_seam_split_equals_jax(splits, name):
    pj, vj, sj = splits[name]["j"]
    pt, vt, st = splits[name]["t"]
    assert st.shape == sj.shape and np.array_equal(st, sj)
    assert np.array_equal(vt, vj)
    assert np.abs(pt - pj).max() <= 1e-3
    assert set(splits[name]["stages"]) == {"seam_readback", "seam", "blend"}
    assert set(splits[name]["counts"]) == {"readback_bytes"}


def test_fullres_graphcut_pair_reads_back_the_uint8_crop(pair, splits):
    n, Hc, Wc = np.asarray(pair["masks"]).shape
    crop = splits["graphcut"]["counts"]["readback_bytes"]
    assert crop < n * Hc * Wc * 4          # a crop, 1 byte per value
    assert crop % (n * 4) == 0             # 3 channels + the mask


def test_n_view_readback_quantizes_for_the_graph_cut(pair):
    warped = torch.tensor(np.asarray(pair["warped"]))
    masks = torch.tensor(np.asarray(pair["masks"]))
    w3 = torch.cat([warped, warped[:1]])
    m3 = torch.cat([masks, torch.zeros_like(masks[:1])])
    n, Hc, Wc = m3.shape
    for seam, per_px in (("graphcut", 3 + 1), ("dp_full", 12 + 1)):
        t = StageTimer("cpu")
        with t.active():
            tpipe._host_seam_blend(w3, m3, _tcfg(PAIR_CFG.replace(
                seam=SEAMS[seam])))
        assert t.counts() == {"readback_bytes": n * Hc * Wc * per_px}


@pytest.mark.parametrize("seam", ["graphcut", "graphcut_colorgrad"])
def test_reversed_edge_keeps_the_marginals_order(pair, seam):
    """Edge (1, 0): the marginals stay in (masks[0], masks[1]) order."""
    w = np.asarray(pair["warped"])
    m = np.asarray(pair["masks"])
    sets = [m[0] & ~m[1], m[1] & ~m[0], m[0], m[1]]
    marg = (tuple(s.sum(0).astype(np.float32) for s in sets),
            tuple(s.sum(1).astype(np.float32) for s in sets))
    cfg = PAIR_CFG.replace(seam=SEAMS[seam])
    kw = dict(edges=[(1, 0)], pair_marginals=marg, crop_origin=(0, 0))
    sj = jpipe._host_seam_masks(w, m, cfg, **kw)
    st = tpipe._host_seam_masks(w, m, _tcfg(cfg), **kw)
    assert np.array_equal(st, sj)
    ov = m[0] & m[1]
    assert not (st[0] & st[1] & ov).any() and (st[0] | st[1])[ov].all()


@pytest.mark.parametrize("name", ["graphcut", "graphcut_megapix",
                                  "dp_full"])
def test_stitch_pair_host_seam_matches_jax(pair, name):
    cfg = PAIR_CFG.replace(seam=SEAMS[name])
    pj, vj, _ = jpipe._host_seam_blend(pair["warped"], pair["masks"], cfg)
    pj, _ = jpipe._crop_valid(np.asarray(pj), np.asarray(vj))
    pj = np.clip(pj, 0, 255).astype(np.uint8)
    pt, mt = tist.stitch_pair(pair["a"], pair["b"], _tcfg(cfg),
                              device="cpu", draws=pair["draws"])
    assert {"front", "host_seam_blend"} <= set(mt)
    assert "stitch_pair_total" not in mt
    assert abs(mt["focal"] - pair["focal"]) / pair["focal"] < 1e-3
    assert pt.shape == pj.shape
    assert np.abs(pt.astype(np.float64) - pj).mean() < 0.5


@pytest.fixture(scope="module")
def chain():
    views, _ = jio.synthetic_sequence(3, 160, 224, overlap=0.5, seed=9)
    key = jax.random.key(0)
    warped, masks, _, _ = jpipe.stitch_chain_front(
        jnp.asarray(np.stack(views), jnp.float32), key, CHAIN_CFG)
    wt, mt, _, _ = tpipe.stitch_chain_front_impl(
        torch.as_tensor(np.stack(views)), _tcfg(CHAIN_CFG),
        chain_draws(key, 3, 512, False))
    return dict(views=list(views), j=(warped, masks), t=(wt, mt),
                draws=chain_draws(key, 3, 512, False))


@pytest.mark.parametrize("name", ["graphcut", "graphcut_megapix"])
def test_stitch_chain_host_seam_matches_jax(chain, name):
    cfg = CHAIN_CFG.replace(seam=SEAMS[name])
    pj, vj, sj = jpipe._host_seam_blend(*chain["j"], cfg)
    pt, vt, st = tpipe._host_seam_blend(*chain["t"], _tcfg(cfg))
    cover = np.asarray(chain["j"][1]).any(0)
    if name.endswith("megapix"):
        cover = np.ones(np.asarray(sj).shape[1:], bool)
    assert _agree(_np(st), _np(sj), cover) >= SEAM_AGREE
    iou, diff = _held(_np(pj), _np(vj), pt.numpy(), vt.numpy())
    assert iou >= 0.995 and diff < 1.0
    pe, me = tist.stitch_chain(chain["views"], _tcfg(cfg), device="cpu",
                               draws=chain["draws"])
    assert {"front", "host_seam_blend"} <= set(me)
    pc, _ = tpipe._crop_valid(pt.numpy(), vt.numpy())
    assert np.array_equal(pe, np.clip(pc, 0, 255).astype(np.uint8))


STITCHER_CASES = ("graphcut", "graphcut_megapix", "graphcut_colorgrad")


@pytest.fixture(scope="module")
def stitcher_runs(tmp_path_factory):
    views = pan_sequence(3)
    draws = all_pair_draws(0, 3, 512)
    out = {}
    for name in STITCHER_CASES:
        cfg = ST_CFG.replace(seam=SEAMS[name])
        dj = str(tmp_path_factory.mktemp(f"j_{name}"))
        dt = str(tmp_path_factory.mktemp(f"t_{name}"))
        pj, mj = jist.Stitcher(cfg).stitch(list(views), 0, dump_stages=dj)
        pt, mt = tist.Stitcher(_tcfg(cfg), device="cpu").stitch(
            list(views), draws=draws, dump_stages=dt)
        out[name] = dict(
            j=(pj, mj, np.load(os.path.join(dj, "seams.npz"))["seam_masks"],
               np.load(os.path.join(dj, "warped.npz"))["masks"]),
            t=(pt, mt, np.load(os.path.join(dt, "seams.npz"))["seam_masks"]))
    return out


@pytest.mark.parametrize("name", STITCHER_CASES)
def test_stitcher_host_seam_matches_jax(stitcher_runs, name):
    pj, mj, sj, masks = stitcher_runs[name]["j"]
    pt, mt, st = stitcher_runs[name]["t"]
    assert mt["reachable"] == list(mj["reachable"])
    assert abs(mt["focal"] - mj["focal"]) / mj["focal"] < 1e-3
    cover = masks.any(0)
    if name.endswith("megapix"):
        cover = np.ones(sj.shape[1:], bool)
    assert st.shape == sj.shape
    assert _agree(st, sj, cover) >= SEAM_AGREE
    for ax in (0, 1):
        assert abs(pt.shape[ax] - pj.shape[ax]) <= 0.02 * pj.shape[ax]


def test_stitcher_full_dp_on_three_views():
    """The full DP along a 3-view spanning tree: the JAX package's finder
    indexes past its component lists there (IndexError; see
    test_torch_dp_full), the port's seams partition the coverage."""
    views = pan_sequence(3)
    cfg = ST_CFG.replace(seam=SEAMS["dp_full"])
    with pytest.raises(IndexError):
        jist.Stitcher(cfg).stitch(list(views), 0)
    ts = tist.Stitcher(_tcfg(cfg), device="cpu")
    draws = all_pair_draws(0, 3, 512)
    pano, m = ts.stitch(list(views), draws=draws)
    assert m["reachable"] == [True] * 3 and pano.std() > 20


@pytest.mark.parametrize("name", ["graphcut", "graphcut_megapix"])
def test_stream_calibrate_host_seam_matches_jax(name):
    views = pan_sequence(3)
    cfg = ST_CFG.replace(seam=SEAMS[name])
    js = JStream(cfg)
    pj, mj = js.calibrate(list(views), 0)
    ts = tist.StreamStitcher(_tcfg(cfg), device="cpu")
    pt, mt = ts.calibrate(list(views), draws=all_pair_draws(0, 3, 512))
    assert abs(mt["focal"] - mj["focal"]) / mj["focal"] < 1e-3
    sj = np.asarray(js._seam_masks)
    st = ts.frozen("seam_masks").numpy()
    assert _agree(st, sj, np.ones(sj.shape[1:], bool)) >= SEAM_AGREE
    for ax in (0, 1):
        assert abs(pt.shape[ax] - pj.shape[ax]) <= 0.02 * pj.shape[ax]
