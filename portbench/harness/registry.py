"""Find a cell's parts by name: ``BENCHMARK.json`` at the checkout's root
names the cells; ``configs/<config>.json``, ``traffic/<traffic>.json``,
``limits/<cell>.json`` and ``metrics/<metric>.py`` hold the rest, and the
traffic file's ``kind`` names ``kinds/<kind>.py``.  A new cell, configuration,
mix or metric is a new file and a new entry; no file here changes."""

from __future__ import annotations

import functools
import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the cell's end-to-end metric entries
    per_layer: list  # the cell's per-layer metric entries
    chips: int
    bench_dir: Path = BENCH_DIR  # where its files and the kinds and readers are


def _load_json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    return json.loads(path.read_text())


def _applies(metric: dict, cell: str, reported: set[str]) -> bool:
    """A metric with ``workloads`` belongs to the cells it lists; one without,
    to every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def load_cell(root: Path, name: str, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, with its files read."""
    spec = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have: {', '.join(cells)})")
    w = cells[name]
    for key in ("config", "traffic"):
        if not NAME.match(w[key]):
            raise ValueError(f"{key} name {w[key]!r} of {name} is not a plain name")
    config = _load_json(bench_dir / "configs" / f"{w['config']}.json")
    traffic = _load_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    limits = _load_json(bench_dir / "limits" / f"{name}.json")
    e2e = [m for m in spec["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _applies(m, name, reported)]
    return Cell(name, config, traffic, limits, e2e, per_layer, int(w["chips"]), bench_dir)


@functools.cache
def _load_file(path: Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def kind(name: str, bench_dir: Path = BENCH_DIR):
    """The module ``kinds/<name>.py``."""
    if not NAME.match(name):
        raise ValueError(f"traffic kind {name!r} is not a plain name")
    return _load_file(bench_dir / "kinds" / f"{name}.py", f"portbench_kind_{name}")


def reader(name: str, bench_dir: Path = BENCH_DIR):
    """``read(run) -> float | None`` of ``metrics/<name>.py``."""
    if not NAME.match(name):
        raise ValueError(f"metric {name!r} is not a plain name")
    module = _load_file(bench_dir / "metrics" / f"{name}.py",
                        "portbench_metric_" + name.replace(".", "_").replace("-", "_"))
    return module.read
