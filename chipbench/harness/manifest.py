"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration (the manifest's ``file``), its traffic mix
(``traffic/<traffic>.json``), its limits (``limits/<cell>.json``) and
each metric's reader (``metrics/<metric>.py``, a ``read(record)`` that
returns a number or None)."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

from .ranks import Ranks

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    ranks: Ranks = field(default_factory=Ranks)     # set by the run for its rank


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(manifest: dict, name: str, root: Path = ROOT) -> Cell:
    w = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == w["config"])
    bench = root / BENCH.name
    return Cell(
        name=name, config_name=w["config"], traffic_name=w["traffic"], chips=int(w["chips"]),
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads((bench / "limits" / f"{name}.json").read_text()),
    )


def metrics_of(manifest: dict, cell_name: str, kind: str) -> List[dict]:
    """The ``kind`` ("end_to_end" or "per_layer") metrics a cell reports:
    those that list it, or that list no cells (an end-to-end metric:
    every cell; a per-layer one: every cell that reports its ``moves``)."""
    e2e = {m["name"]: m for m in manifest["end_to_end"]}

    def reports(m: dict) -> bool:
        return "workloads" not in m or cell_name in m["workloads"]

    out = []
    for m in manifest[kind]:
        if kind == "per_layer" and "workloads" not in m:
            if reports(e2e[m["moves"]]):
                out.append(m)
        elif reports(m):
            out.append(m)
    return out


def reader(name: str, root: Path = ROOT) -> Callable:
    """``read`` of ``metrics/<name>.py`` (loaded by path: a name may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"chipbench_metric_{name}",
                                                  root / BENCH.name / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(manifest: dict, cell_name: str, kind: str, record, root: Path = ROOT
                 ) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of the metrics whose readers found something."""
    out = {}
    for m in metrics_of(manifest, cell_name, kind):
        v: Optional[float] = reader(m["name"], root)(record)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
