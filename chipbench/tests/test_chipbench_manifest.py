"""BENCHMARK.json against the contract's form, and the harness finding
every cell's files by name, also those a later change adds as new files
and entries only."""

import json
import re
import shutil

import pytest

from chipbench.tests.tiny import ROOT  # noqa: I001  (first: puts src/ on the path)
from chipbench.harness import manifest
from chipbench.harness.record import Record

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def m():
    return manifest.load(ROOT)


def test_keys_names_and_units(m):
    assert set(m) == KEYS["top"]
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in m[part]:
            extra = {"workloads"} if part in ("end_to_end", "per_layer") else set()
            assert KEYS[part] <= set(e) <= KEYS[part] | extra, e
            assert NAME.match(e["name"]), e["name"]
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]
        names = [e["name"] for e in m[part]]
        assert len(names) == len(set(names))
    for e in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        assert e["source"] in SOURCES
    for e in m["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25 and e["source"] in ("host_clock", "device_trace")
    assert 1 <= m["run_seconds"] <= 51
    assert any(e["name"] == "setup_s" for e in m["end_to_end"])


def test_every_cell_reports_its_metrics(m):
    e2e = {e["name"]: e for e in m["end_to_end"]}
    chips = [w["chips"] for w in m["workloads"]]    # four only for a quarter of the cells, or one
    assert set(chips) <= {1, 4} and chips.count(4) <= max(1, len(chips) // 4)
    for w in m["workloads"]:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        mine = {e["name"] for e in manifest.metrics_of(m, w["name"], "end_to_end")}
        assert "setup_s" in mine and len(mine) >= 2
        assert manifest.metrics_of(m, w["name"], "per_layer")
    for e in m["per_layer"]:
        assert e["moves"] in e2e
        for cell in e.get("workloads", []):
            assert e["name"] in {x["name"] for x in manifest.metrics_of(m, cell, "per_layer")}
            assert e["moves"] in {x["name"] for x in manifest.metrics_of(m, cell, "end_to_end")}
    layers = {}
    for e in m["per_layer"]:
        layers.setdefault(e["layer"], set()).add(e["name"])
    assert all(len(layer) <= 200 for layer in layers)


def test_every_cell_finds_its_files(m):
    for w in m["workloads"]:
        cell = manifest.cell(m, w["name"], ROOT)
        assert cell.traffic["kind"] in ("train", "serve")
        assert cell.limits and all(v >= 0 for v in cell.limits.values())
        assert cell.config["source"] == next(
            c["source"] for c in m["configs"] if c["name"] == w["config"])
        assert cell.config["reduced"] == next(
            c["reduced"] for c in m["configs"] if c["name"] == w["config"])
    for e in m["end_to_end"] + m["per_layer"]:
        assert callable(manifest.reader(e["name"], ROOT))
    for c in m["configs"]:
        assert c["file"].startswith("chipbench/configs/")


def test_readers_find_nothing_in_an_empty_record(m):
    """A reader that finds nothing returns None (never 0 for a share)."""
    for kind in ("train", "serve"):
        rec = Record("x", kind)
        for e in m["per_layer"]:
            assert manifest.reader(e["name"], ROOT)(rec) is None, e["name"]


def test_a_cell_config_mix_and_metric_added_as_new_files_only(m, tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "chipbench", root / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    m2 = json.loads(json.dumps(m))
    conf = json.loads((ROOT / "chipbench/configs/qwen3-1.7b.json").read_text())
    conf["num_hidden_layers"] = 14
    conf["reduced"] = ["num_hidden_layers"]
    (root / "chipbench/configs/qwen3-1.7b-half.json").write_text(json.dumps(conf))
    mix = json.loads((ROOT / "chipbench/traffic/serve_shared.json").read_text())
    mix["suffix_tokens"] = 64
    (root / "chipbench/traffic/serve_short.json").write_text(json.dumps(mix))
    (root / "chipbench/limits/qwen3-1.7b-half.serve_short.json").write_text(
        json.dumps({"logit_gap": 1.0}))
    (root / "chipbench/metrics/requests.serve_short.py").write_text(
        "def read(rec):\n    return rec.counters.get('requests')\n")
    m2["configs"].append({"name": "qwen3-1.7b-half", "source": conf["source"],
                          "file": "chipbench/configs/qwen3-1.7b-half.json",
                          "reduced": ["num_hidden_layers"], "why": "half depth"})
    m2["workloads"].append({"name": "qwen3-1.7b-half.serve_short", "config": "qwen3-1.7b-half",
                            "traffic": "serve_short", "chips": 1, "why": "short suffixes"})
    for e in m2["end_to_end"]:
        if "workloads" in e and "qwen3-1.7b.serve_shared" in e["workloads"]:
            e["workloads"].append("qwen3-1.7b-half.serve_short")
    m2["per_layer"].append({"name": "requests.serve_short", "unit": "requests",
                            "better": "higher", "source": "program_counter",
                            "layer": "engine, host", "moves": "ttft_ms_p90",
                            "workloads": ["qwen3-1.7b-half.serve_short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m2))
    m3 = manifest.load(root)
    cell = manifest.cell(m3, "qwen3-1.7b-half.serve_short", root)
    assert cell.config["num_hidden_layers"] == 14 and cell.traffic["suffix_tokens"] == 64
    assert cell.limits == {"logit_gap": 1.0}
    rec = Record(cell.name, "serve", counters={"requests": 7})
    got = manifest.read_metrics(m3, cell.name, "per_layer", rec, root)
    assert got["requests.serve_short"] == {"value": 7.0, "unit": "requests"}
    assert {e["name"] for e in manifest.metrics_of(m3, cell.name, "end_to_end")} == {
        "ttft_ms_p90", "setup_s"}
