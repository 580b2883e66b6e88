"""BENCHMARK.json against the benchmark's contract, and every name in it
found: configurations, traffic mixes, metric readers."""

from __future__ import annotations

import json
import re

import pytest

from stitchbench import find, harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return harness.load_benchmark()


def line_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_limits(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "stitchbench/run.py"]
    assert bench["paths"] == ["stitchbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 << 10


def test_configs(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line_ok(c["source"])
        assert line_ok(c["why"]) and c["file"].startswith("stitchbench/")
        conf = harness.load_json(harness.ROOT / c["file"])
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
        assert set(conf["limits"]) == {"focal_rel_err", "extent_rel_err",
                                       "tile_mad"}
        find.part("surfaces", conf["reference"]["surface"])
        used = [w for w in bench["workloads"] if w["config"] == c["name"]]
        assert used, f"{c['name']} is used by no cell"


def test_workloads_resolve(bench):
    names = [w["name"] for w in bench["workloads"]]
    assert len(names) == len(set(names))
    pairs = {(w["config"], w["traffic"]) for w in bench["workloads"]}
    assert len(pairs) == len(names)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and line_ok(w["why"])
        assert w["chips"] in (1, 4)
        cell = harness.resolve_cell(bench, w["name"])
        assert issubclass(harness.load_driver(cell["traffic"]["driver"]),
                          harness.ClosedLoop)
        e2e = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell["per_layer"]


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    layers = {}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
        harness.end_to_end(m["name"], [0.5, 0.6], 2, 1.2, 20.0)
    setup = [m for m in bench["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and line_ok(m["layer"])
        assert m["source"] in SOURCES
        assert callable(harness.load_reader(m["name"]))
        layers.setdefault(m["layer"], m["layer"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))


def test_every_file_name_is_a_name():
    for p in harness.BENCH_DIR.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        assert NAME.match(p.name), p


@pytest.mark.parametrize("mix", ["rig4_compose", "serve_b8_closed8",
                                 "pan4_closed1"])
def test_prepared_mix_is_one_entry_away(bench, mix):
    """A cell from a prepared mix needs only entries in BENCHMARK.json: its
    traffic file, driver and readers are there."""
    b = json.loads(json.dumps(bench))
    conf = "detailed_1080p" if mix == "pan4_closed1" else "default_1080p"
    name = f"{conf}.{mix}"
    b["workloads"].append({"name": name, "config": conf, "traffic": mix,
                           "chips": 1, "why": "prepared"})
    readers = {"rig4_compose": ["readback_crop_ms.rig"],
               "serve_b8_closed8": ["dispatch_ms.serve",
                                    "readback_crop_ms.serve"],
               "pan4_closed1": ["bundle_adjust_ms.pan4",
                                "seam_blend_ms.pan4"]}[mix]
    for r in readers:
        b["per_layer"].append({"name": r, "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "stages",
                               "moves": "latency_p50_ms",
                               "workloads": [name]})
    cell = harness.resolve_cell(b, name)
    assert issubclass(harness.load_driver(cell["traffic"]["driver"]),
                      harness.ClosedLoop)
    got = {m["name"] for m in cell["per_layer"]}
    assert set(readers) <= got
    assert {"latency_p50_ms", "panos_per_s", "setup_s"} <= {
        m["name"] for m in cell["end_to_end"]}
    for r in readers:
        assert callable(harness.load_reader(r))


@pytest.mark.parametrize("mix", [p.stem for p in
                                 (harness.BENCH_DIR / "traffic").glob("*.json")])
def test_every_mix_finds_its_driver_and_poses(mix):
    t = harness.load_json(harness.BENCH_DIR / "traffic" / f"{mix}.json")
    assert issubclass(harness.load_driver(t["driver"]), harness.ClosedLoop)
    poses = harness.load_poses(t["poses"])
    assert poses.views(t) >= 2 and callable(poses.draw)
    assert callable(poses.cameras)


def test_a_new_part_is_a_new_file(tmp_path, monkeypatch):
    """A driver, poses, a surface or a reader that a later mix or
    configuration needs is one new file in its folder, found by its name
    with no other file edited."""
    folders = ("drivers", "poses", "surfaces", "metrics")
    for folder in folders:
        (tmp_path / folder).mkdir()
        (tmp_path / folder / "added.by_name.py").write_text("VALUE = 7\n")
    monkeypatch.setattr(find, "BENCH_DIR", tmp_path)
    monkeypatch.setattr(find, "_loaded", {})
    for folder in folders:
        assert find.part(folder, "added.by_name").VALUE == 7
        assert find.names(folder) == ["added.by_name"]
    with pytest.raises(KeyError):
        find.part("drivers", "missing")
