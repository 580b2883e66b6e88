"""A run end to end on the CPU at a small size: the last line's keys, the
traced run's, `correct` against a timed path broken underneath, and the
import check at the end of a run."""

from __future__ import annotations

import io
import json
import shutil
import subprocess
import sys
import types
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest
import torch

import imagestitch_tpu_torch as ist
from stitchbench import harness, run
from stitchbench.calibrate import invert_middle, reference_answers
from stitchbench.tests.small import run_small, small_cell

PAIR = "default_1080p.pair_closed1"
CHAIN = "detailed_1080p.chain4_closed1"
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def pair_line():
    return run_small(small_cell(PAIR))


def test_last_line_keys(pair_line):
    out = dict(pair_line)
    extra = out.pop("_extra")
    assert list(out)[:5] == KEYS and list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"latency_p50_ms", "latency_p90_ms",
                                   "panos_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert out["device"]["count"] == 1 and out["attempted"] >= 1
    assert set(out["checks"]) == {"focal_rel_err", "extent_rel_err",
                                  "tile_mad"}
    assert extra["first_call_s"] > 0
    assert out["correct"] is True, out["checks"]


def test_emit_prints_checks_last_on_stderr_and_the_line_last(pair_line):
    so, se = io.StringIO(), io.StringIO()
    with redirect_stdout(so), redirect_stderr(se):
        run.emit(dict(pair_line))
    line = json.loads(so.getvalue().strip().splitlines()[-1])
    assert list(line)[-1] == "checks" and "_extra" not in line
    tail = se.getvalue().strip().splitlines()[-3:]
    assert [t.split()[1] for t in tail] == list(line["checks"])
    assert all(" limit " in t for t in tail)


def test_traced_run_keys():
    out = run_small(small_cell(CHAIN), trace=True)
    assert set(out["metrics"]) == {"first_call_s", "front_ms.chain4",
                                   "host_seam_blend_ms.chain4",
                                   "device_idle_pct"}
    assert out["device"]["window_s"] > 0 and "busy_s" in out["device"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["breakdown"]["idle_gaps"][0][0] in (
        "stitchbench.request", "front", "host_seam_blend")
    assert out["attempted"] == 1 and out["failed"] == 0


@pytest.mark.parametrize("fault", ["pano", "focal"])
def test_an_answer_altered_where_it_is_produced_is_not_correct(
        monkeypatch, fault):
    real = ist.stitch_pair

    def broken(*a, **k):
        pano, m = real(*a, **k)
        if fault == "pano":
            return invert_middle(pano), m
        return pano, {**m, "focal": 1.05 * m["focal"]}

    monkeypatch.setattr(ist, "stitch_pair", broken)
    out = run_small(small_cell(PAIR))
    assert out["failed"] == 0 and out["correct"] is False
    key = "tile_mad" if fault == "pano" else "focal_rel_err"
    assert out["checks"][key]["value"] > out["checks"][key]["limit"]


def test_a_request_that_raises_fails_the_run(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("no panorama")

    monkeypatch.setattr(ist, "stitch_pair", boom)
    cell = small_cell(PAIR)
    out = run_small(cell)
    assert out["failed"] == out["attempted"] >= 1
    assert out["correct"] is False


def test_forbidden_modules_compare_top_level_names_whole():
    assert harness.forbidden_modules(
        ["imagestitch_tpu_torch", "imagestitch_tpu_torch.pipeline",
         "jax_like", "jaxtyping", "flaxen"]) == []
    assert harness.forbidden_modules(
        ["imagestitch_tpu.pipeline", "jaxlib.xla_client", "jax",
         "flax.linen"]) == ["flax", "imagestitch_tpu", "jax", "jaxlib"]
    assert "imagestitch_tpu" not in harness.forbidden_modules()


def test_a_run_with_jax_loaded_prints_no_result(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: {
        "correct": True, "checks": {}})
    rc = run.main(["--workload", PAIR, "--seed", "1", "--seconds", "1",
                   "--trace", "0"], device="cpu")
    cap = capsys.readouterr()
    assert rc != 0 and cap.out == "" and "jax" in cap.err


def test_no_result_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and stitchbench/."""
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "stitchbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.'); "
            "from stitchbench import run; "
            "sys.exit(run.main(['--workload', '%s', '--seed', '1', "
            "'--seconds', '1', '--trace', '0'], device='cpu'))" % PAIR)
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "imagestitch_tpu_torch" in p.stderr
    p = subprocess.run([sys.executable, "stitchbench/run.py", "--workload",
                        PAIR, "--seed", "1", "--seconds", "1", "--trace",
                        "0"], cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_pool_is_the_seed_s():
    cell = small_cell(PAIR)
    import torch
    a = harness.make_pool(cell["config"], cell["traffic"], 2**31 + 5,
                          torch.device("cpu"))
    b = harness.make_pool(cell["config"], cell["traffic"], 2**31 + 5,
                          torch.device("cpu"))
    c = harness.make_pool(cell["config"], cell["traffic"], 2**31 + 6,
                          torch.device("cpu"))
    assert all(np.array_equal(x.views, y.views) for x, y in zip(a, b))
    assert not np.array_equal(a[0].views, c[0].views)


@pytest.mark.parametrize("mix,readers", [
    ("rig4_compose", ["readback_crop_ms.rig"]),
    ("serve_b8_closed8", ["dispatch_ms.serve", "readback_crop_ms.serve"])])
def test_prepared_mix_runs_as_a_cell(mix, readers):
    """A prepared mix as a cell: entries in BENCHMARK.json and nothing
    else, driven end to end (traced, so its readers read)."""
    b = harness.load_benchmark()
    name = f"default_1080p.{mix}"
    b["workloads"].append({"name": name, "config": "default_1080p",
                           "traffic": mix, "chips": 1, "why": "prepared"})
    for r in readers:
        b["per_layer"].append({"name": r, "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "stages",
                               "moves": "latency_p50_ms",
                               "workloads": [name]})
    out = run_small(small_cell(name, b), trace=True)
    assert set(readers) <= set(out["metrics"])
    assert out["attempted"] >= 1 and out["failed"] == 0
    judged = set(out["checks"])
    assert judged == ({"extent_rel_err", "tile_mad"} if "serve" in mix else
                      {"focal_rel_err", "extent_rel_err", "tile_mad"})
    assert all(c["value"] is not None for c in out["checks"].values())


def test_the_control_is_not_correct():
    """The control: the reference put in the program's place, its
    geometry in bfloat16 (the precision below the configuration's
    float32), over four pool items (yaw 15 to 30 deg), all compared and
    judged by the harness's own comparison and limits."""
    cell = small_cell(PAIR, pool=4)
    cpu = torch.device("cpu")
    pool = harness.make_pool(cell["config"], cell["traffic"], 2**31 + 11, cpu)
    reqs = reference_answers(pool, cell["config"], cpu, torch.bfloat16)
    worst = harness.judge_requests(reqs, pool, cell["config"], cpu,
                                   set(range(len(reqs))))
    checks, within = harness.verdict(worst, cell["config"]["limits"],
                                     harness.load_driver("pair").judged)
    assert not within, checks


@pytest.mark.parametrize("workload", [PAIR, CHAIN])
def test_a_run_without_the_bundle_adjustment_is_not_correct(workload):
    """The program's own path without the ray bundle adjustment that both
    configurations state (the chain cell's control), over four pool
    items, all compared."""
    cell = small_cell(workload, pool=4, traced_requests=4)
    cell["config"]["pipeline"] = {"camera": {"ba_refine": False}}
    out = run_small(cell, trace=True)
    assert out["failed"] == 0 and out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())
