"""The harness is driven by data: a configuration, a traffic mix, a metric and
a cell added as new files and entries are found by name, with no file
edited; and ``BENCHMARK.json`` keeps to the names and shapes it must have."""

import json
import re
import shutil

import torch

from portbench.harness import registry
from portbench.harness.context import Ctx
from portbench.run import run_cell
from portbench.tests.conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_names_units_and_lines():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert all(PATH.match(p) and ".." not in p for p in s["paths"])
    assert 1 <= s["run_seconds"] <= 51 and isinstance(s["run_seconds"], int)
    metrics = s["end_to_end"] + s["per_layer"]
    for group in (s["configs"], s["workloads"], metrics):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for e in s["configs"] + s["workloads"] + s["per_layer"]:
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
    assert len(json.dumps(s)) <= 64 * 1024


def test_every_cell_reports_and_finds_its_files():
    s = spec()
    e2e = {m["name"] for m in s["end_to_end"]}
    assert "setup_s" in e2e
    for m in s["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    for m in s["per_layer"]:
        assert m["moves"] in e2e
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    for w in s["workloads"]:
        cell = registry.load_cell(ROOT, w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer, w["name"]
        assert all(m["moves"] in reported for m in cell.per_layer)
        assert (BENCH / "kinds" / f"{cell.traffic['kind']}.py").is_file()
        assert set(cell.limits) and all(v > 0 for v in cell.limits.values())
    for c in s["configs"]:
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]


def test_new_files_are_found_by_name(tmp_path):
    """A copy of the benchmark gains a configuration, a mix, a metric and a
    cell: new files and new entries only, then runs the new cell."""
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    s = spec()
    bench = tmp_path / "portbench"
    cfg = json.loads((bench / "configs" / "1d_edm.json").read_text())
    (bench / "configs" / "other_1d.json").write_text(json.dumps(cfg | {"name": "other_1d"}))
    mix = json.loads((bench / "traffic" / "heun25_b128.json").read_text())
    mix |= {"batch": 2, "num_steps": 3, "check_rows_per_batch": 1, "check_rows": 2,
            "reference_block": 2}
    (bench / "traffic" / "euler_b2.json").write_text(json.dumps(mix))
    (bench / "limits" / "other_1d.euler_b2.json").write_text(
        json.dumps({"signal_err": 0.05, "wave_err": 1e-4}))
    (bench / "metrics" / "gen.batches.py").write_text(
        "def read(run):\n    return float(run['result'].units)\n")
    s["configs"].append({"name": "other_1d", "source": "https://arxiv.org/abs/2410.19343",
                         "file": "portbench/configs/other_1d.json", "reduced": [],
                         "why": "a test"})
    s["workloads"].append({"name": "other_1d.euler_b2", "config": "other_1d",
                           "traffic": "euler_b2", "chips": 1, "why": "a test"})
    s["end_to_end"].append({"name": "gen.batches", "unit": "batches", "better": "higher",
                            "bound": 0.25, "source": "host_clock",
                            "workloads": ["other_1d.euler_b2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(s))
    cell = registry.load_cell(tmp_path, "other_1d.euler_b2", bench)
    assert cell.traffic["batch"] == 2 and cell.config["name"] == "other_1d"
    assert {m["name"] for m in cell.end_to_end} == {"wf_per_s", "setup_s", "gen.batches"} - {
        "wf_per_s"} | {"setup_s", "gen.batches"}
    ctx = Ctx(device=torch.device("cpu"), seed=5, seconds=0.1, trace=False)
    out = run_cell(cell, ctx)
    assert out["metrics"]["gen.batches"]["value"] >= 1
    assert out["correct"], out["checks"]
    after = {p: p.read_bytes() for p in before}
    assert after == before  # no file that was there changed
