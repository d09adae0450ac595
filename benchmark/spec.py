"""BENCHMARK.json and the files it names, found by name:

- configs/<config>.json: a configuration (a deployment of the codec);
- traffic/<traffic>.json: a traffic mix, read by generator.py;
- operations/<op>.py: the operation a mix's "op" names (generator.py);
- end_to_end/<metric>.py and layer_metrics/<metric>.py: each metric's
  reader, a module with read(window) or read(trace); a per-layer reader may
  also have SPANS (the port's functions it reads, tracing.py) and a
  roofline's KERNEL (its wrapper, its kernels' names, its bytes).

A cell reports every metric whose "workloads" lists it, and every metric
without that key.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SPEC = os.path.join(ROOT, "BENCHMARK.json")


class SpecError(ValueError):
    """BENCHMARK.json, or a file it names, is missing or wrong."""


def load_json(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        raise SpecError(f"{path}: {e}") from e


def load_module(kind: str, name: str, needs: str = "read"):
    """The module <kind>/<name>.py (its name may hold dots), which must
    have `needs`; loaded once."""
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.isfile(path):
        raise SpecError(f"no file {path}")
    full = f"benchmark.{kind}.{name.replace('.', '_')}"
    mod = sys.modules.get(full)
    if mod is None:
        spec = importlib.util.spec_from_file_location(full, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[full] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[full]
            raise
    got = getattr(mod, needs, None)
    if got is None or (needs == "read" and not callable(got)):
        raise SpecError(f"{path} has no {needs}")
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list        # BENCHMARK.json entries this cell reports
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, spec_path: str = SPEC) -> Cell:
    spec = load_json(spec_path)
    cells = {w["name"]: w for w in spec.get("workloads", [])}
    if name not in cells:
        raise SpecError(f"no workload {name!r} in {spec_path}: "
                        f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec.get("configs", [])}
    if w["config"] not in configs:
        raise SpecError(f"workload {name} names no known config")
    config = load_json(os.path.join(ROOT, configs[w["config"]]["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
    return Cell(name=name, chips=w["chips"], config=config, traffic=traffic,
                end_to_end=[m for m in spec["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in spec["per_layer"]
                           if _reports(m, name)])
