"""Finds what ``BENCHMARK.json`` names: a cell, its configuration file, its
traffic mix and the readers of its metrics, each by name."""

from __future__ import annotations

import importlib
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def benchmark() -> dict:
    return _json(os.path.join(ROOT, "BENCHMARK.json"))


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    """``configs/<name>.json``."""
    return _json(os.path.join(HERE, "configs", f"{name}.json"))


def mix(name: str) -> dict:
    """``mixes/<name>.json``."""
    return _json(os.path.join(HERE, "mixes", f"{name}.json"))


def metrics(bench: dict, cell_name: str, trace: bool) -> list:
    """The cell's metrics: its end-to-end ones, or with ``trace`` its
    per-layer ones; a metric without ``workloads`` belongs to every cell."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell_name in m.get("workloads", [cell_name])]


def reader(metric_name: str):
    """The ``read(record)`` of ``metrics/<family>.py``, the family being the
    name up to its first dot (``search_ms.testset`` -> ``search_ms``)."""
    family = metric_name.split(".")[0]
    return importlib.import_module(f"perfbench.metrics.{family}").read
