"""Finding a cell's parts by name.

`BENCHMARK.json` names the cells; each cell names a configuration
(`configs/<config>.json`, the file that BENCHMARK.json gives), a traffic
mix (`traffic/<traffic>.json`) and, through the metric entries, one
reader module per per-layer metric (`metrics/<name>.py`, with `.` and
`-` in a name read as `_`; end-to-end metrics alike).  A configuration
names its driver (`drivers/<driver>.py`, which also makes the
reference's inputs) and its plain reference (`reference/<reference>.py`,
the contract in `reference/__init__.py`), a traffic mix its kind of load
(`loops/<loop>.py`).  Adding a cell, a configuration, a reference, a mix
or a metric adds files and entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field
from types import ModuleType
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, bench: dict | None = None, root: str = ROOT) -> Cell:
    """The cell `name` with its configuration, traffic mix and the
    metrics it reports.  Raises KeyError for an unknown cell and
    FileNotFoundError for a missing file."""
    bench = bench if bench is not None else load_benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    w = work[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _json(os.path.join(root, cfg["file"]))
    _reference_file(config, cfg["file"])
    traffic = _json(os.path.join(HERE, "traffic", f"{w['traffic']}.json"))
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def _module(path: str, mod_name: str) -> ModuleType:
    """The module at `path` under the name `mod_name`: the one already
    imported from that file, else loaded and entered in sys.modules (which
    dataclasses and pickling look up by the module's name)."""
    held = sys.modules.get(mod_name)
    if held is not None and os.path.abspath(getattr(held, "__file__", "")) == path:
        return held
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[mod_name]
        raise
    return mod


def module_name(metric: str) -> str:
    return metric.replace(".", "_").replace("-", "_")


def metric_reader(metric: str) -> ModuleType:
    """metrics/<name>.py: a module with `read(trace) -> float | None`."""
    stem = module_name(metric)
    return _module(os.path.join(HERE, "metrics", f"{stem}.py"),
                   f"proofbench.metrics.{stem}")


def driver(config: dict) -> ModuleType:
    """drivers/<driver>.py: a module with `setup(config, traffic, seed,
    device) -> Driver` and `inputs(traffic, seed, k, device) -> (statement,
    key)`, the reference's inputs of job k."""
    stem = config["driver"]
    return _module(os.path.join(HERE, "drivers", f"{stem}.py"),
                   f"proofbench.drivers.{stem}")


REFERENCES = os.path.join(HERE, "reference")


def _reference_file(config: dict, where: str) -> str:
    if "reference" not in config:
        raise KeyError(f"{where} names no plain reference: it needs the key "
                       "'reference', the name of reference/<reference>.py")
    path = os.path.join(REFERENCES, f"{config['reference']}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{where} names the reference {config['reference']!r}, "
                                f"and there is no file {os.path.relpath(path, ROOT)}")
    return path


def reference(config: dict) -> ModuleType:
    """reference/<reference>.py: the configuration's plain reference, a
    module with `prove`, `parts` and `proof_bytes`."""
    path = _reference_file(config, f"configuration {config.get('name')!r}")
    return _module(path, f"proofbench.reference.{config['reference']}")


def loop(traffic: dict) -> ModuleType:
    """loops/<loop>.py: a module with `run(seconds, first_index, phases,
    call, sync) -> window.Window`."""
    stem = traffic["loop"]
    return _module(os.path.join(HERE, "loops", f"{stem}.py"),
                   f"proofbench.loops.{stem}")


def readers(metrics: List[dict]) -> Dict[str, ModuleType]:
    return {m["name"]: metric_reader(m["name"]) for m in metrics}
