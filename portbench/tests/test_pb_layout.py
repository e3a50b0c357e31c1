"""The benchmark's files: every cell, configuration, traffic mix, entry
and metric of BENCHMARK.json is found by its name, and a cell or a metric
added as new files is found with no edit to any file that was there."""

from __future__ import annotations

import hashlib
import pathlib
import json
import re

import pytest

from portbench import harness
from pbtest import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_by_name(cell):
    c = harness.Cell(cell)
    assert c.limits is not None and c.limits["numbers"]
    assert callable(c.entry().make)
    scene = c.scene()
    assert len(scene.times) == c.traffic["scene_args"]["n_frames"]
    cam = c.config["pipeline"]["camera"]
    assert all(scene.cam[k] == cam[k] for k in ("fx", "fy", "cx", "cy", "bf", "width", "height"))
    assert [m["name"] for m in c.e2e if m["name"] != "setup_s"]
    assert c.per_layer
    for m in c.e2e + c.per_layer:
        if m["name"] != "setup_s":
            assert callable(c.reader(m).read)


def test_benchmark_json_keeps_to_its_rules():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]) and e["name"] not in names
            names.add(e["name"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (REPO / "portbench" / "metrics" / f"{m['name']}.py").is_file() or \
            m["name"] == "setup_s"
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert "workloads" not in moved or w in moved["workloads"]
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/") and len(c["source"]) <= 200
        assert set(c) == {"name", "source", "file", "reduced", "why"} and len(c["why"]) <= 200
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (REPO / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_and_a_metric_added_as_files_are_found(tmp_path):
    """A new drive (scene file + traffic file), a new cell and a new
    per-layer metric (reader file) in a copy of the benchmark: the harness
    finds all of them, and no file that was there changes but
    BENCHMARK.json, which gains entries only."""
    from pbtest import small_root

    root = small_root(tmp_path)
    before = _digests(root)
    pb = root / "portbench"
    (pb / "scenes" / "static_road.py").write_text(
        "from portbench.scenes import junction\n\n\n"
        "def build(**args):\n"
        "    return junction.build(**{**args, 'n_concurrent': 0})\n")
    traffic = json.loads((pb / "traffic" / "junction144-urban-noisy.json").read_text())
    traffic["scene"] = "static_road"
    (pb / "traffic" / "static-noisy.json").write_text(json.dumps(traffic))
    (pb / "metrics" / "frames_in_window.py").write_text(
        "def read(rec):\n    return float(len(rec['frames']))\n")
    (pb / "limits" / "live-static.json").write_text(
        (pb / "limits" / "live-junction.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "live-static", "config": "kitti03-rgbd-live",
                               "traffic": "static-noisy", "chips": 1, "why": "ego only"})
    for m in bench["end_to_end"]:
        if "live-junction" in m.get("workloads", []):
            m["workloads"].append("live-static")
    bench["per_layer"].append({"name": "frames_in_window", "unit": "frames", "better": "higher",
                               "source": "host_clock", "layer": "live system",
                               "moves": "live_ms_per_frame", "workloads": ["live-static"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.Cell("live-static", root=root)
    assert cell.scene().movers == []
    assert [m["name"] for m in cell.per_layer] == ["frames_in_window"]
    assert cell.reader(cell.per_layer[0]).read({"frames": [1, 2, 3]}) == 3.0
    after = _digests(root)
    changed = {p for p in before if before[p] != after[p]}
    assert changed == {pathlib.Path("BENCHMARK.json")}


def test_an_entry_point_registers_from_a_file_of_its_own(tmp_path):
    from pbtest import small_root

    root = small_root(tmp_path)
    pb = root / "portbench"
    (pb / "entries" / "echo.py").write_text("def make(*a, **kw):\n    return 'echo'\n")
    cfg = json.loads((pb / "configs" / "kitti03-rgbd-live.json").read_text())
    cfg["entry"] = "echo"
    (pb / "configs" / "echo.json").write_text(json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "echo", "source": "x", "file": "portbench/configs/echo.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "echo-junction", "config": "echo",
                               "traffic": "junction144-urban-noisy", "chips": 1, "why": "x"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert harness.Cell("echo-junction", root=root).entry().make() == "echo"
