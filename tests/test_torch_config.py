"""imagestitch_tpu_torch: configuration parity with the JAX package, the
no-JAX import rule, the device guards, and how the port reads the host
seams and SCANS mode from a configuration (as the JAX package does)."""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from imagestitch_tpu import config as jcfg  # noqa: E402
import imagestitch_tpu_torch  # noqa: E402
from imagestitch_tpu_torch import config as tcfg  # noqa: E402
from imagestitch_tpu_torch.convert import config_from_dict  # noqa: E402

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "imagestitch_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "imagestitch_tpu"}
CLASSES = ["DetectorConfig", "MatcherConfig", "RansacConfig", "CameraConfig",
           "WarpConfig", "ExposureConfig", "SeamConfig", "BlendConfig",
           "PipelineConfig"]


def _defaults(cls):
    out = []
    for f in dataclasses.fields(cls):
        d = f.default
        if d is dataclasses.MISSING:
            d = f.default_factory()
        if dataclasses.is_dataclass(d):
            d = dataclasses.asdict(d)
        out.append((f.name, d))
    return out


@pytest.mark.parametrize("name", CLASSES)
def test_config_fields_and_defaults_match(name):
    assert _defaults(getattr(tcfg, name)) == _defaults(getattr(jcfg, name))


def test_config_from_dict_round_trip():
    j = jcfg.PipelineConfig(
        detector=jcfg.DetectorConfig(nfeatures=256, max_keypoints=768),
        seam=jcfg.SeamConfig(dp_scale=1),
        warp=jcfg.WarpConfig(kind="spherical"))
    t = config_from_dict(dataclasses.asdict(j))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert config_from_dict(dataclasses.asdict(jcfg.PipelineConfig())) \
        == tcfg.PipelineConfig()


def test_config_validation_matches():
    for cls, kw in [("DetectorConfig", {"wta_k": 5}),
                    ("SeamConfig", {"dp_scale": 3}),
                    ("BlendConfig", {"kind": "nope"}),
                    ("ExposureConfig", {"kind": "nope"})]:
        with pytest.raises(AssertionError):
            getattr(jcfg, cls)(**kw)
        with pytest.raises(AssertionError):
            getattr(tcfg, cls)(**kw)


def test_unported_kinds_raise_with_roadmap_item():
    """No kind is refused any more. The configurations this test once
    refused, the host seams (ROADMAP item 15) and SCANS mode (item 16),
    are read as the JAX package reads them: `_needs_host_seam` and
    `_normalize_scans` give JAX's answers on them and on every other
    configuration here (the runs are in test_torch_host_seams.py and
    test_torch_scans.py). The item-13 kinds (the fisheye warp, the ramp
    blend) run in tests/test_torch_projectors.py and
    tests/test_torch_options_pipeline.py."""
    from imagestitch_tpu import pipeline as jpipe
    from imagestitch_tpu_torch import pipeline as tpipe
    assert tcfg.WarpConfig(kind="fisheye").kind == "fisheye"
    with pytest.raises(AssertionError):
        tcfg.WarpConfig(kind="nope")
    with pytest.raises(AssertionError):
        tcfg.PipelineConfig(matcher=tcfg.MatcherConfig(motion="affine"))
    for cfg in [
            tcfg.PipelineConfig(seam=tcfg.SeamConfig(kind="graphcut")),
            tcfg.PipelineConfig(seam=tcfg.SeamConfig(
                kind="graphcut_colorgrad", seam_megapix=0.1)),
            tcfg.PipelineConfig(seam=tcfg.SeamConfig(full_components=True)),
            tcfg.PipelineConfig(seam=tcfg.SeamConfig(
                kind="voronoi", full_components=True)),
            tcfg.PipelineConfig(mode="scans"),
            tcfg.PipelineConfig(mode="scans", matcher=tcfg.MatcherConfig(
                motion="affine")),
            tcfg.PipelineConfig(),
            tcfg.PipelineConfig(detector=tcfg.DetectorConfig(kind="sift")),
            tcfg.PipelineConfig(blend=tcfg.BlendConfig(kind="multiband")),
            tcfg.PipelineConfig(blend=tcfg.BlendConfig(kind="ramp")),
            tcfg.PipelineConfig(warp=tcfg.WarpConfig(kind="fisheye")),
            tcfg.PipelineConfig(
                detector=tcfg.DetectorConfig(wta_k=4),
                camera=tcfg.CameraConfig(ba_kind="reproj",
                                         wave_correct=True),
                exposure=tcfg.ExposureConfig(kind="channels_blocks"),
                seam=tcfg.SeamConfig(kind="voronoi"), work_megapix=0.5,
                compose_megapix=0.2, crop="interior")]:
        jc = jcfg.PipelineConfig(**{
            f.name: getattr(jcfg, type(getattr(cfg, f.name)).__name__)(
                **dataclasses.asdict(getattr(cfg, f.name)))
            if dataclasses.is_dataclass(getattr(cfg, f.name))
            else getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
        assert tpipe._needs_host_seam(cfg) == jpipe._needs_host_seam(jc)
        assert dataclasses.asdict(tpipe._normalize_scans(cfg)) == \
            dataclasses.asdict(jpipe._normalize_scans(jc))


def _python_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_source_imports_no_jax():
    """AST scan: no import whose top-level module is jax, flax or the JAX
    package (compared by exact name: `imagestitch_tpu_torch` is fine)."""
    bad = []
    for path in _python_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad += [f"{path.name}: {n}" for n in names
                    if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_port_import_loads_no_jax_modules():
    mods = sorted(
        "imagestitch_tpu_torch." + ".".join(
            p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py")
    code = ("import sys\n"
            f"for m in {mods!r}:\n"
            "    __import__(m)\n"
            "import chip_smoke\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r})\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_every_jax_module_has_a_counterpart():
    """Each module of imagestitch_tpu/ has one in the port at the same
    path, a Pallas kernel module (`ops/pallas_<k>.py`) its CUDA wrapper
    (`ops/cuda_<k>.py`)."""
    jax_pkg = REPO / "imagestitch_tpu"
    missing = []
    for p in sorted(jax_pkg.rglob("*.py")):
        rel = p.relative_to(jax_pkg)
        if rel.name.startswith("pallas_"):
            rel = rel.with_name("cuda_" + rel.name[len("pallas_"):])
        if not (PORT / rel).exists():
            missing.append(str(rel))
    assert not missing, missing


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    img = np.zeros((64, 64, 3), np.uint8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        imagestitch_tpu_torch.stitch_pair(img, img)


def test_cpu_wrappers_never_build(monkeypatch):
    """On CPU tensors the kernel wrappers run the plain versions: the
    CUDA library is never built or loaded."""
    from imagestitch_tpu_torch.ops import (cuda_build, cuda_detect,
                                           cuda_sift, cuda_slab_probe,
                                           cuda_warp)

    def boom():
        raise AssertionError("kernel library requested for a CPU tensor")

    monkeypatch.setattr(cuda_build, "load_library", boom)
    n0, w0 = cuda_detect.launch_count, cuda_warp.launch_count
    s0, p0 = cuda_sift.launch_count, cuda_slab_probe.launch_count
    img = torch.rand(1, 32, 40) * 255
    maps = cuda_detect.detect_maps(img, 20.0)
    assert all(m.shape == img.shape for m in maps)
    small = torch.rand(1, 25, 31) * 255
    levels = cuda_detect.detect_maps_levels([img, small], 20.0)
    assert [tuple(m.shape for m in lv) for lv in levels] == \
        [(img.shape,) * 3, (small.shape,) * 3]
    dog, score, gx, gy, gs = cuda_sift.sift_octave_maps(img[0], True)
    assert dog.shape == (5, 32, 40) and score.shape == (3, 32, 40)
    assert gx.shape == gy.shape == (4, 32, 40) and gs.shape == (32, 40)
    out, valid = cuda_warp.warp_batched(
        torch.rand(1, 20, 30, 3), torch.eye(3)[None], 1.0,
        torch.zeros(1, 2, dtype=torch.int32),
        torch.tensor([[0.0, 0.0, 29.0, 19.0]]), (20, 30), "plane")
    assert out.shape == (1, 20, 30, 3) and bool(valid.all())
    probe = cuda_slab_probe.slab_probe(torch.rand(3, 64, 512), 16, False, 4)
    assert probe.shape == (8, 128)
    assert (cuda_detect.launch_count, cuda_warp.launch_count,
            cuda_sift.launch_count, cuda_slab_probe.launch_count) == \
        (n0, w0, s0, p0)


def test_kernel_wrappers_refuse_other_devices():
    from imagestitch_tpu_torch.ops import (cuda_detect, cuda_sift,
                                           cuda_slab_probe, cuda_warp)
    meta = torch.empty(1, 8, 8, device="meta")
    with pytest.raises(ValueError):
        cuda_detect.detect_maps(meta, 20.0)
    with pytest.raises(ValueError):
        cuda_detect.detect_maps_levels([meta, meta[:, :6]], 20.0)
    with pytest.raises(ValueError):       # mixed devices
        cuda_detect.detect_maps_levels([torch.zeros(1, 8, 8), meta], 20.0)
    with pytest.raises(ValueError):
        cuda_sift.sift_octave_maps(meta[0], True)
    with pytest.raises(ValueError):
        cuda_warp.warp_batched(meta[..., None], torch.eye(3)[None], 1.0,
                               torch.zeros(1, 2), torch.zeros(1, 4), (4, 4))
    with pytest.raises(ValueError):
        cuda_slab_probe.slab_probe(torch.empty(3, 64, 512, device="meta"),
                                   16, False, 4)


@pytest.mark.parametrize("n_levels", [0, 1, 9])
def test_detect_levels_cuda_refuses_what_the_kernel_does_not_take(
        n_levels):
    """The multi-level launch takes 1 to 8 levels of CUDA tensors and
    raises on anything else before it builds or launches."""
    from imagestitch_tpu_torch.ops import cuda_detect
    n0 = cuda_detect.launch_count
    levels = [torch.zeros(1, 16, 16)] * n_levels
    with pytest.raises(ValueError):
        cuda_detect.detect_maps_levels_cuda(levels, 20.0)
    assert cuda_detect.launch_count == n0
