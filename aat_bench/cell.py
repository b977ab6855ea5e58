"""A benchmark cell as ``BENCHMARK.json`` and the files beside it define
it, and the code the harness finds by name.

Nothing here names a cell, a configuration or a metric: a cell's
configuration is the JSON file ``BENCHMARK.json`` gives for it, its traffic
mix is ``traffic/<traffic>.json``, the configuration names its generator
(``generators/<generator>.py``), the mix names its entry
(``entries/<entry>.py``), and each metric is read by
``metrics/<metric>.py``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def load_bench(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find(bench: dict, name: str, root: str = ROOT,
         bench_dir: str = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``bench``, its configuration and traffic read
    from their files."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       f"{sorted(cells)}")
    w = cells[name]
    cfg_file = {c["name"]: c["file"] for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, cfg_file)) as f:
        config = json.load(f)
    with open(os.path.join(bench_dir, "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return Cell(name, int(w["chips"]), config, traffic,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def load_module(kind: str, name: str, bench_dir: str = BENCH_DIR):
    """``<bench_dir>/<kind>/<name>.py`` as a module (names may hold dots,
    so it is loaded from its path)."""
    path = os.path.join(bench_dir, kind, name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    key = "aat_bench_file_" + "".join(
        c if c.isalnum() else "_" for c in os.path.abspath(path))
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod
