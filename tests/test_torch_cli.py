"""imagestitch_tpu_torch's command line (`python -m imagestitch_tpu_torch.
cli`) against `imagestitch_tpu.cli` on the CPU (`--device cpu`).

- `demo` at 192x256 writes a PNG; JAX's `demo` on the same scene writes
  one whose height and width are within 2% (each side draws its own
  RANSAC samples: `tests/test_torch_pipeline.py`'s tolerance for the
  port's own draws).
- `stitch` on two PNG files gives `stitch_pair`'s pano on the same arrays,
  bit for bit, and `--metrics` prints its metrics as JSON; on three files
  it gives `stitch`'s pano.
- Every option and choice of the JAX CLI parses and stitches the demo;
  SCANS mode and the host seams (the choices that once raised
  NotImplementedError) write `stitch_pair`'s pano with the same
  configuration, bit for bit; without a card the default device raises.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from imagestitch_tpu import cli as jcli  # noqa: E402
import imagestitch_tpu_torch as tist  # noqa: E402
from imagestitch_tpu_torch import cli  # noqa: E402
from imagestitch_tpu_torch.utils.io import (imread, imwrite,  # noqa: E402
                                            synthetic_pair,
                                            synthetic_sequence)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_demo_matches_jax_cli(tmp_path, capsys):
    out_t, out_j = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    assert cli.main(["demo", "--size", "192x256", "-o", out_t,
                     "--device", "cpu"]) == 0
    assert jcli.main(["demo", "--size", "192x256", "-o", out_j]) == 0
    pt, pj = imread(out_t), imread(out_j)
    assert pt.shape[1] > 256
    for ax in (0, 1):
        assert abs(pt.shape[ax] - pj.shape[ax]) <= 0.02 * pj.shape[ax]
    assert f"wrote {out_t} ({pt.shape[1]}x{pt.shape[0]})" in \
        capsys.readouterr().out


def test_stitch_files_equal_the_entry_points(tmp_path, capsys):
    a, b, _ = synthetic_pair(160, 224, overlap=0.5, seed=3)
    files = []
    for i, im in enumerate((a, b)):
        files.append(str(tmp_path / f"v{i}.png"))
        imwrite(files[-1], im)
    out = str(tmp_path / "pair.png")
    capsys.readouterr()
    assert cli.main(["stitch", *files, "-o", out, "--device", "cpu",
                     "--seed", "2", "--metrics"]) == 0
    want, m = tist.stitch_pair(a, b, seed=2, device="cpu")
    assert np.array_equal(imread(out), want)
    printed = capsys.readouterr().out
    metrics = json.loads(printed[printed.index("{"):])
    assert metrics["num_inliers"] == m["num_inliers"]

    views, _ = synthetic_sequence(3, 160, 224, overlap=0.5, seed=9)
    files = []
    for i, im in enumerate(views):
        files.append(str(tmp_path / f"s{i}.png"))
        imwrite(files[-1], im)
    out = str(tmp_path / "seq.png")
    assert cli.main(["stitch", *files, "-o", out, "--device", "cpu"]) == 0
    want, _ = tist.stitch(views, device="cpu")
    assert np.array_equal(imread(out), want)


@pytest.mark.parametrize("args,item", [
    (["--mode", "scans"], 16),
    (["--seam", "graphcut"], 15),
    (["--seam", "graphcut_colorgrad"], 15),
    (["--full_seam_components"], 15),
])
def test_unported_choices_raise_with_roadmap_item(tmp_path, args, item):
    """The ROADMAP items 15 and 16 choices run now: the demo's PNG is
    `stitch_pair`'s pano with the same configuration, bit for bit."""
    out = str(tmp_path / "x.png")
    assert cli.main(["demo", "--size", "128x160", "-o", out, "--device",
                     "cpu", *args]) == 0
    if args[0] == "--mode":
        change = dict(mode="scans")
    elif args[0] == "--seam":
        change = dict(seam=tist.SeamConfig(kind=args[1]))
    else:
        change = dict(seam=tist.SeamConfig(full_components=True))
    cfg = tist.PipelineConfig().replace(**change)
    assert (cfg.mode == "scans") == (item == 16)
    img1, img2, _ = synthetic_pair(128, 160)
    want, _ = tist.stitch_pair(img1, img2, cfg, device="cpu")
    assert np.array_equal(imread(out), want)


@pytest.mark.parametrize("args", [
    ["--warp", "spherical"], ["--warp", "plane"], ["--seam", "none"],
    ["--blend", "multiband"], ["--blend", "none"], ["--exposure", "none"],
    ["--seam_megapix", "0.2"], ["--compose_megapix", "0.2"],
    ["--warp", "fisheye"], ["--warp", "stereographic"],
    ["--seam", "dp_colorgrad"], ["--seam", "voronoi"],
    ["--blend", "ramp"], ["--exposure", "gain_blocks"],
    ["--exposure", "channels"], ["--exposure", "channels_blocks"],
    ["--ba", "reproj"], ["--work_megapix", "0.015"],
    ["--crop", "interior"]])
def test_ported_choices_run(tmp_path, args):
    out = str(tmp_path / "x.png")
    assert cli.main(["demo", "--size", "128x160", "-o", out, "--device",
                     "cpu", *args]) == 0
    assert imread(out).ndim == 3


def test_cli_runs_as_a_module_and_needs_a_card(tmp_path):
    r = subprocess.run([sys.executable, "-m", "imagestitch_tpu_torch.cli",
                        "demo", "--help"], cwd=REPO, capture_output=True,
                       text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr
    for opt in ("--size", "--device", "--mode", "--warp", "--seam",
                "--blend", "--exposure", "--ba", "--crop", "--seed",
                "--metrics"):
        assert opt in r.stdout, opt
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["demo", "--size", "64x96", "-o",
                      str(tmp_path / "x.png")])
