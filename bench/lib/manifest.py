"""Finds a cell's files by the names in BENCHMARK.json.

  BENCHMARK.json                  the metrics and the cells
  bench/configs/<config>.json     a configuration (its `file` entry)
  bench/workloads/<cell>.json     a cell's engine or job settings and limits
  bench/traffic/<traffic>.json    a traffic mix's parameters
  bench/metrics/<metric>.py       a per-layer metric's reader: read(run)
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_entry(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_file(man: dict, name: str, root: Path = ROOT) -> dict:
    for c in man["configs"]:
        if c["name"] == name:
            return load_json(root / c["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def cell_files(man: dict, name: str, root: Path = ROOT,
               overrides: "dict | None" = None):
    """(the config file, the cell file, the mix) of cell `name`.
    `overrides` ({"cell": {...}, "mix": {...}}, tests only) updates the
    cell's and the mix's settings, a dict value key by key."""
    w = cell_entry(man, name)
    conf = config_file(man, w["config"], root)
    cell = load_json(root / "bench" / "workloads" / f"{name}.json")
    mix = load_json(root / "bench" / "traffic" / f"{w['traffic']}.json")
    for key, d in (("cell", cell), ("mix", mix)):
        for k, v in (overrides or {}).get(key, {}).items():
            d[k] = dict(d[k], **v) if isinstance(v, dict) else v
    return conf, cell, mix


def _listed(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def end_to_end(man: dict, cell: str) -> "list[dict]":
    return [m for m in man["end_to_end"] if _listed(m, cell)]


def per_layer(man: dict, cell: str) -> "list[dict]":
    """The per-layer metrics this cell reports: those listing it, and
    those without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end(man, cell)}
    return [m for m in man["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def reader(name: str, root: Path = ROOT):
    """The `read(run)` function of bench/metrics/<name>.py."""
    path = root / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
