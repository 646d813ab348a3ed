"""Find a cell's configuration, traffic mix and metric readers by name.

``BENCHMARK.json`` names each cell's configuration (whose ``file`` is a
JSON object under ``perfbench/configs``) and traffic mix (the JSON file
``perfbench/traffic/<traffic>.json``); each per-layer metric is the
module ``perfbench/metrics/<name>.py`` with a ``read(rec)`` function.
Adding a configuration, a mix or a metric is adding a file and an entry.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config_name: str
    config: dict          # the configuration file's object
    traffic: dict         # the traffic file's object
    chips: int
    end_to_end: tuple     # metric entries this cell reports with --trace 0
    per_layer: tuple      # metric entries this cell reports with --trace 1


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, bench: dict | None = None,
              root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` (or of ``bench``),
    with its configuration and traffic files loaded."""
    if bench is None:
        bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have: {', '.join(sorted(cells))})")
    w = cells[name]
    cfgs = {c["name"]: c for c in bench["configs"]}
    centry = cfgs[w["config"]]
    return Cell(
        name=name, config_name=w["config"],
        config=load_json(root / centry["file"]),
        traffic=load_json(root / "perfbench" / "traffic"
                          / f"{w['traffic']}.json"),
        chips=int(w["chips"]),
        end_to_end=tuple(m for m in bench["end_to_end"]
                         if _applies(m, name)),
        per_layer=tuple(m for m in bench["per_layer"]
                        if _applies(m, name)))


def metric_reader(name: str, root: Path = ROOT):
    """``read`` of ``perfbench/metrics/<name>.py``, loaded by file so a
    new metric needs no import anywhere else.  A quantity split by the
    end-to-end metric it moves (``decode_step_ms.open``) is read by the
    file of its first part (``decode_step_ms.py``) unless it has its own."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    if not path.exists():
        path = path.with_name(name.split(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
