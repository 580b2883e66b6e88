"""imagestitch_tpu_torch's slab-load probe (`ops/slab_probe.py`) against
the TPU kernel of `tools/exp_dma_layouts.py`, run in Pallas interpret mode
on the CPU with the tool's own kernel bodies: the same (8, 128) output bit
for bit, the same origins for every step and chunk, the same tiled layout.
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from imagestitch_tpu_torch.ops import cuda_slab_probe  # noqa: E402
from imagestitch_tpu_torch.ops import slab_probe as sp  # noqa: E402
from imagestitch_tpu_torch.tools import exp_dma_layouts  # noqa: E402

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location(
        "exp_dma_layouts_tpu", REPO / "tools" / "exp_dma_layouts.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def sources(tool):
    """The tool's seeded (3, 1080, 1920) planar source and its tiled form,
    as NumPy arrays (the tool's own transpose)."""
    H, W, C = tool.H, tool.W, tool.C
    planar = np.random.default_rng(0).random((C, H, W)).astype(np.float32)
    tiled = np.ascontiguousarray(np.transpose(
        planar.reshape(C, H, W // 128, 128), (0, 2, 1, 3)))
    return planar, tiled


def _run_tpu_kernel(tool, src, h, tiled, steps):
    """`tools/exp_dma_layouts.py:build` with `steps` grid steps, in Pallas
    interpret mode."""
    kern = tool._kern_tiled if tiled else tool._kern_planar
    out = pl.pallas_call(
        functools.partial(kern, h=h),
        grid=(steps,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((8, 128), lambda i: (0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        scratch_shapes=[
            pltpu.VMEM((tool.NCH, tool.C, tool.SLAB_H, tool.SLAB_W),
                       jnp.float32),
            (pltpu.SemaphoreType.DMA((tool.NCH, tool.SLAB_W // 128))
             if tiled else pltpu.SemaphoreType.DMA((tool.NCH,))),
        ],
        interpret=True,
    )(jnp.asarray(src))
    return np.asarray(out)


def test_constants_match_tool(tool):
    assert (sp.NCH, sp.SLAB_H, sp.SLAB_W, sp.STEPS) == \
        (tool.NCH, tool.SLAB_H, tool.SLAB_W, tool.STEPS)


@pytest.mark.parametrize("h", [16, 24, 32, 48])
@pytest.mark.parametrize("tiled", [False, True], ids=["planar", "tiled"])
def test_origins_match_tool(tool, sources, h, tiled):
    """Every step and chunk of the full grid: the same (sy, sx), with the
    (pad_h, pad_w) each layout's kernel derives from its source's shape."""
    src = torch.as_tensor(sources[1] if tiled else sources[0])
    pad_h, pad_w = sp.source_hw(src, tiled)
    assert (pad_h, pad_w) == (tool.H, tool.W)
    step = np.arange(tool.STEPS)
    for ch in range(tool.NCH):
        jy, jx = tool._origins(jnp.asarray(step, jnp.int32), ch, pad_h,
                               pad_w, h)
        ty, tx = sp.origins(torch.as_tensor(step), ch, pad_h, pad_w, h)
        np.testing.assert_array_equal(np.asarray(jy), ty.numpy())
        np.testing.assert_array_equal(np.asarray(jx), tx.numpy())
        # the int path the kernel launcher and the entry point use
        assert sp.origins(int(step[-1]), ch, pad_h, pad_w, h) == \
            (int(jy[-1]), int(jx[-1]))


def test_to_tiled_matches_tool_transpose(sources):
    planar, tiled = sources
    out = sp.to_tiled(torch.as_tensor(planar))
    assert out.is_contiguous()
    np.testing.assert_array_equal(out.numpy(), tiled)


@pytest.mark.parametrize("h,steps", [(16, 1), (16, 5), (48, 2), (48, 5)])
@pytest.mark.parametrize("tiled", [False, True], ids=["planar", "tiled"])
def test_plain_matches_tpu_kernel(tool, sources, h, steps, tiled):
    """The plain version equals the TPU kernel (interpret mode) bit for bit
    on the full seeded source: max error 0."""
    src = sources[1] if tiled else sources[0]
    want = _run_tpu_kernel(tool, src, h, tiled, steps)
    got = sp.slab_probe_plain(torch.as_tensor(src), h, tiled, steps)
    assert got.shape == (8, 128) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_matches_tpu_kernel_full_grid(tool, sources):
    """All 468 steps, h=48, planar: the output is step 467's sum."""
    want = _run_tpu_kernel(tool, sources[0], 48, False, tool.STEPS)
    got = sp.slab_probe_plain(torch.as_tensor(sources[0]), 48, False)
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_is_last_step_sum_in_chunk_order(sources):
    """The output is the last step's blocks summed in chunk order in
    float32 (NumPy, sequentially), and both layouts agree."""
    planar, tiled = sources
    for h, steps in [(24, 7), (32, 130)]:
        ref = np.zeros((8, 128), np.float32)
        for ch in range(sp.NCH):
            sy, sx = sp.origins(steps - 1, ch, planar.shape[1],
                                planar.shape[2], h)
            ref = ref + planar[0, sy:sy + 8, sx:sx + 128]
        a = sp.slab_probe_plain(torch.as_tensor(planar), h, False, steps)
        b = sp.slab_probe_plain(torch.as_tensor(tiled), h, True, steps)
        np.testing.assert_array_equal(a.numpy(), ref)
        np.testing.assert_array_equal(b.numpy(), ref)


@pytest.mark.parametrize("h", [16, 24, 32, 48])
@pytest.mark.parametrize("tiled", [False, True], ids=["planar", "tiled"])
def test_tensor_map_views_match_plain_slabs(sources, h, tiled):
    """The 4-D tensor map the card's kernel copies each slab with, read on
    the CPU: a strided view of the source with the map's dims, byte
    strides and box, at the coordinates of every chunk of steps 0-31 and
    467, equals the slab the plain version gathers, exactly. Planar slabs
    land as (C, h, 3, 128), the memory order of (C, h, 384)."""
    src = torch.as_tensor(sources[1] if tiled else sources[0])
    spec = sp.tensor_map_spec(tuple(src.shape), tiled, h)
    assert spec.dims[::-1] == ((3, 15, 1080, 128) if tiled
                               else (3, 1080, 15, 128))
    el = (1, *(st // 4 for st in spec.strides))
    steps = torch.tensor([*range(32), 467])
    want = sp.gather_slabs(src, h, tiled, steps)
    pad_h, pad_w = sp.source_hw(src, tiled)
    for i, step in enumerate(steps.tolist()):
        for ch in range(sp.NCH):
            sy, sx = sp.origins(step, ch, pad_h, pad_w, h)
            coords = sp.tensor_map_coords(sy, sx, tiled)
            view = torch.as_strided(
                src, spec.box[::-1], el[::-1],
                sum(c * e for c, e in zip(coords, el)))
            slab = want[:, i, ch]
            assert torch.equal(view.reshape(slab.shape), slab)


@pytest.mark.parametrize("h", [16, 24, 32, 48])
@pytest.mark.parametrize("tiled", [False, True], ids=["planar", "tiled"])
def test_tensor_map_spec_is_one_box_per_slab(h, tiled):
    """What a TMA map allows and the kernel assumes: box sides of at most
    256 elements, an inner box of 512 bytes, byte strides that are
    multiples of 16 and dense, and one box holding the whole (C, h, 384)
    slab, its row origin and tile in dims 1 and 2."""
    shape = (3, 15, 1080, 128) if tiled else (3, 1080, 1920)
    spec = sp.tensor_map_spec(shape, tiled, h)
    assert all(1 <= b <= 256 for b in spec.box)
    assert spec.box[0] * 4 == 512
    assert all(st % 16 == 0 for st in spec.strides)
    assert spec.strides[0] == 4 * spec.dims[0]
    assert all(spec.strides[i + 1] == spec.strides[i] * spec.dims[i + 1]
               for i in range(2))
    assert np.prod(spec.box) == 3 * h * sp.SLAB_W
    assert spec.box[3] == spec.dims[3] == 3
    ydim, xdim = sp.coord_dims(tiled)
    assert {ydim, xdim} == {1, 2}
    assert (spec.box[ydim], spec.box[xdim]) == (h, sp.TILES)
    assert sp.tensor_map_coords(40, 640, tiled)[ydim] == 40
    assert sp.tensor_map_coords(40, 640, tiled)[xdim] == 5


@pytest.mark.parametrize("steps", [*range(1, 33), 100, 396, 467, 468])
def test_block_ranges_cover_every_slab_once(steps):
    """The persistent grid's schedule at min(132, steps) blocks: the ranges
    cover the NCH x steps slabs once, in order, sizes differing by at most
    one, and the last range ends with the last step's NCH slabs whole."""
    units = sp.NCH * steps
    blocks = min(132, steps)
    ranges = sp.block_ranges(units, blocks)
    assert len(ranges) == blocks
    assert [u for r in ranges for u in r] == list(range(units))
    sizes = {len(r) for r in ranges}
    assert max(sizes) - min(sizes) <= 1 and min(sizes) >= sp.NCH
    assert ranges[-1][-sp.NCH:] == range(units - sp.NCH, units)


def test_l2_ceilings_need_a_card_source(sources):
    src = torch.as_tensor(sources[0])
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_slab_probe.l2_ceiling_cuda(src, 1 << 20)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_slab_probe.l2_loads_cuda(src, 1 << 20)


def test_wrapper_on_cpu_runs_plain_and_checks_args(sources):
    n0 = cuda_slab_probe.launch_count
    src = torch.as_tensor(sources[0])
    out = cuda_slab_probe.slab_probe(src, 16, False, 3)
    assert torch.equal(out, sp.slab_probe_plain(src, 16, False, 3))
    assert cuda_slab_probe.launch_count == n0
    for bad in [(src, 20, False, 3), (src, 56, False, 3),
                (src, 16, True, 3), (src.double(), 16, False, 3),
                (src, 16, False, 0)]:
        with pytest.raises(ValueError):
            cuda_slab_probe.slab_probe(*bad)


def test_entry_point_runs_on_cpu(capsys):
    """The probe's entry point at a small step count on the CPU: one row
    per slab height and layout, both layouts give the same sum, and the
    GB moved follow from the shapes."""
    rows = exp_dma_layouts.run(device="cpu", hs=(16, 48), steps=2, reps=1,
                               flush_bytes=1 << 20)
    assert [(r["h"], r["layout"]) for r in rows] == [
        (16, "planar"), (16, "tiled"), (48, "planar"), (48, "tiled")]
    for r in rows:
        assert r["gb"] == 2 * 8 * 3 * r["h"] * 384 * 4 / 1e9
        assert r["warm_ms"] > 0 and r["cold_ms"] > 0
        assert r["device"] == "cpu"
    assert rows[0]["checksum"] == rows[1]["checksum"]
    assert rows[2]["checksum"] == rows[3]["checksum"]
    exp_dma_layouts.print_rows(rows)
    assert "h=48  tiled" in capsys.readouterr().out


def test_entry_point_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        exp_dma_layouts.run(steps=1, reps=1)
