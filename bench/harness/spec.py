"""Cells, configurations, traffic mixes and limits, found by the names that
``BENCHMARK.json`` gives them.

* a configuration ``<name>``: ``bench/configs/<name>.json`` (the sizes as
  run), ``bench/configs/<name>.py`` (its plain reference, with the model
  FLOPs of a step) and ``bench/ports/<name>.py`` (how the program runs
  it);
* a traffic mix ``<name>``: ``bench/traffic/<name>.json``, whose
  ``entry`` names ``bench/entries/<entry>.py``, the module that drives
  the program and measures a run;
* a cell ``<name>``: the limits of its correctness check, the precision
  of its control and the readings they were set from, in
  ``bench/cells/<name>.json``;
* a metric ``<name>``, end-to-end or per-layer: its reader
  ``bench/metrics/<name>.py``."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str) -> ModuleType:
    """A module from a file path (names with ``-`` or ``.`` included)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise ImportError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mod_name(kind: str, name: str) -> str:
    return "bench_" + kind + "_" + "".join(
        c if c.isalnum() else "_" for c in name)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: Dict
    traffic: Dict
    limits: Dict
    control: str
    reference: ModuleType
    port: ModuleType
    entry: ModuleType
    end_to_end: List[Dict]
    per_layer: List[Dict]


def benchmark(root: str = ROOT) -> Dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(name: str, bench: Dict = None) -> Cell:
    """The cell called ``name`` with everything it names, and the metrics
    it reports (those without a ``workloads`` key, and those that list
    it)."""
    bench = bench or benchmark()
    rows = [w for w in bench["workloads"] if w["name"] == name]
    if not rows:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (known: "
                       f"{', '.join(w['name'] for w in bench['workloads'])})")
    w = rows[0]
    conf_dir = os.path.join(BENCH_DIR, "configs")
    checked = load_json(os.path.join(BENCH_DIR, "cells", name + ".json"))
    traffic = load_json(os.path.join(BENCH_DIR, "traffic",
                                     w["traffic"] + ".json"))

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        traffic_name=w["traffic"],
        config=load_json(os.path.join(conf_dir, w["config"] + ".json")),
        traffic=traffic, limits=checked["limits"],
        control=checked["control"],
        reference=load_module(os.path.join(conf_dir, w["config"] + ".py"),
                              _mod_name("config", w["config"])),
        port=load_module(os.path.join(BENCH_DIR, "ports",
                                      w["config"] + ".py"),
                         _mod_name("port", w["config"])),
        entry=load_module(os.path.join(BENCH_DIR, "entries",
                                       traffic["entry"] + ".py"),
                          _mod_name("entry", traffic["entry"])),
        end_to_end=mine(bench["end_to_end"]),
        per_layer=mine(bench["per_layer"]))


def metric_reader(name: str) -> ModuleType:
    return load_module(os.path.join(BENCH_DIR, "metrics", name + ".py"),
                       _mod_name("metric", name))
