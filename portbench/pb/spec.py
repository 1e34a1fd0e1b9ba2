"""What a cell is, found by name: ``BENCHMARK.json``'s entries and the
files under ``portbench/`` that they name.

* a configuration: ``configs/<name>.json``;
* a traffic mix: ``traffic/<name>.json``;
* a corpus generator: ``corpora/<generator>.py`` (``generate(root, spec)``);
* a per-layer metric: ``metrics/<name>.py`` (``read(ctx)``, None when it
  finds nothing to read);
* a kernel's operations and bytes: ``roofline/<kernel>.py``.

A later cell, metric or configuration is added by adding such files and
``BENCHMARK.json`` entries; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH_DIR)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module."""
    path = os.path.join(BENCH_DIR, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One workload: its configuration and traffic (the data files'
    contents), its end-to-end and per-layer metrics, and where its data
    is cached."""

    name: str
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    cache_dir: str

    @property
    def check(self) -> dict:
        """The output check's sizes: the configuration's, with the
        traffic's keys over them."""
        return {**self.config.get("check", {}),
                **self.traffic.get("check", {})}


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict | None = None,
         cache_dir: str | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``bench``)."""
    if bench is None:
        bench = load_json(os.path.join(REPO, "BENCHMARK.json"))
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    config = load_json(os.path.join(BENCH_DIR, "configs",
                                    f"{w['config']}.json"))
    traffic = load_json(os.path.join(BENCH_DIR, "traffic",
                                     f"{w['traffic']}.json"))
    return Cell(name=name, config=config, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)],
                cache_dir=cache_dir or os.path.join(BENCH_DIR, "cache"))
