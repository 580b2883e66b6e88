"""The port's fresh-process warm start (`imagestitch_tpu_torch.tools.
warm_start_probe`) and its runnable example (`examples/
stitch_photo_torch.py`) on the CPU.

- The probe, run as a fresh process with `cpu` at 192x256 after an
  in-process `aot.stitch_pair_program` build into the default directory,
  prints one JSON line with exactly the JAX probe's keys
  (`tools/warm_start_probe.py:53-61`), was_cached and h_valid true, and
  pano_sum equal to the in-process `stitch_pair_impl` with a generator
  seeded 0 (the same function on the same inputs with the same number of
  CPU threads: equal to the bit).
- The example, run as a script with `--device cpu`, prints
  `examples/stitch_photo.py`'s metrics line for the port's `stitch_pair`
  on `photo_rotation_pair()` (held to the JAX golden by
  `tests/test_torch_io.py`) and writes its pano, bit for bit.
- Neither imports JAX; without a card both raise by default.
"""

import ast
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from imagestitch_tpu_torch import aot, stitch_pair  # noqa: E402
from imagestitch_tpu_torch.config import PipelineConfig  # noqa: E402
from imagestitch_tpu_torch.pipeline import (_generator,  # noqa: E402
                                            stitch_pair_impl)
from imagestitch_tpu_torch.tools import warm_start_probe  # noqa: E402
from imagestitch_tpu_torch.utils.io import (imread,  # noqa: E402
                                            photo_rotation_pair,
                                            synthetic_pair)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "examples", "stitch_photo_torch.py")
JAX_KEYS = ["warm_start_s", "deserialize_s", "compile_s", "run_s",
            "was_cached", "h_valid", "pano_sum"]


def _example():
    spec = importlib.util.spec_from_file_location("stitch_photo_torch",
                                                  EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fresh(args, timeout=300):
    """`args` run by a fresh python in the repo, on as many CPU threads as
    this process."""
    env = dict(os.environ, PYTHONPATH=REPO,
               OMP_NUM_THREADS=str(torch.get_num_threads()))
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_probe_fresh_process_matches_in_process_stitch():
    call, _ = aot.stitch_pair_program(192, 256, PipelineConfig(),
                                      device="cpu")
    i1, i2, _ = synthetic_pair(192, 256, overlap=0.4, seed=0)
    a, b = torch.as_tensor(i1).float(), torch.as_tensor(i2).float()
    pano = call(a, b, _generator(torch.device("cpu"), 0))[0]
    ref = stitch_pair_impl(a, b, PipelineConfig(),
                           generator=_generator(torch.device("cpu"), 0))[0]
    assert torch.equal(pano, ref)

    p = _fresh(["-m", "imagestitch_tpu_torch.tools.warm_start_probe",
                "192", "256", "cpu"])
    assert p.returncode == 0, p.stderr
    lines = p.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert list(out) == JAX_KEYS
    assert out["was_cached"] is True and out["h_valid"] is True
    assert out["pano_sum"] == float(ref.sum())
    assert out["warm_start_s"] >= out["deserialize_s"] >= 0
    assert out["compile_s"] >= 0 and out["run_s"] > 0


def test_probe_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        warm_start_probe.main(["64", "64"])


def test_example_script_on_the_cpu(tmp_path):
    out = str(tmp_path / "pano.png")
    p = _fresh([EXAMPLE, out, "--device", "cpu"])
    assert p.returncode == 0, p.stderr
    img1, img2, _, focal_true = photo_rotation_pair()
    pano, metrics = stitch_pair(img1, img2, device="cpu")
    assert metrics["h_valid"]
    assert p.stdout.splitlines() == [
        _example().summary(pano, metrics, focal_true), f"wrote {out}"]
    assert np.array_equal(imread(out), pano)


def test_example_default_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example().main([str(tmp_path / "pano.png")])
    assert not os.path.exists(tmp_path / "pano.png")


@pytest.mark.parametrize("path", [
    "examples/stitch_photo_torch.py",
    "imagestitch_tpu_torch/tools/serve_demo.py",
    "imagestitch_tpu_torch/tools/warm_start_probe.py"])
def test_entry_points_import_no_jax(path):
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    assert names
    for name in names:
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "imagestitch_tpu"), name
