"""Finds what a cell needs by the names in ``BENCHMARK.json``: its
configuration (``configs/<config>.json``), traffic mix
(``traffic/<traffic>.json``), the limits of its check
(``limits/<cell>.json``), its family's plain reference
(``reference/<family>.py``) and the readers of its per-layer metrics
(``metrics/<metric>.py``).  Adding a cell, a configuration or a metric
is adding files and entries; nothing here names one.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict
    family: object
    end_to_end: List[Dict]
    per_layer: List[Dict]         # each with its loaded ``reader`` module


def _json(path: Path) -> Dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def reader(name: str):
    """The reader module of per-layer metric ``name``
    (``metrics/<name>.py``; a name may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family(name: str):
    return importlib.import_module(f"portbench.reference.{name}")


def load(cell_name: str, repo: Path) -> Cell:
    """The cell ``cell_name`` of ``repo``'s ``BENCHMARK.json``, with the
    files it names from this package."""
    bench = _json(repo / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json; "
                       f"known: {sorted(cells)}")
    w = cells[cell_name]
    cfg = _json(HERE / "configs" / f"{w['config']}.json")
    per_layer = []
    for m in bench["per_layer"]:
        if _applies(m, cell_name):
            per_layer.append(dict(m, reader=reader(m["name"])))
    return Cell(name=cell_name, chips=w["chips"], config=cfg,
                traffic=_json(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=_json(HERE / "limits" / f"{cell_name}.json"),
                family=family(cfg["family"]),
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, cell_name)],
                per_layer=per_layer)
