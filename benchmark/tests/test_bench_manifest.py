"""BENCHMARK.json against the benchmark's contract: its keys, names and
units, bounds, cells and metrics, and that every name it gives finds its
file (configuration, traffic, driver, per-layer reader)."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
E2E = [m["name"] for m in MANIFEST["end_to_end"]]
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(MANIFEST) == TOP
    assert MANIFEST["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    for word in MANIFEST["command"]:
        assert line(word)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fit_a_full_check():
    """2 + 14 x 24 runs at run_seconds + 60, 2 x 90 s of compile per cell
    and 1200 s spare fit in 43200 s."""
    s = MANIFEST["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("config", MANIFEST["configs"], ids=lambda c: c["name"])
def test_config(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(config["name"]) and line(config["source"]) and line(config["why"])
    assert config["file"].startswith(MANIFEST["paths"][0] + "/")
    body = json.loads((ROOT / config["file"]).read_text())
    assert body["name"] == config["name"] and body["source"] == config["source"]
    assert config["reduced"] == [] and config["name"] in {w["config"] for w in MANIFEST["workloads"]}


@pytest.mark.parametrize("cell", MANIFEST["workloads"], ids=lambda w: w["name"])
def test_cell(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and line(cell["why"])
    assert cell["chips"] in (1, 4) and cell["config"] in {c["name"] for c in MANIFEST["configs"]}
    traffic = json.loads((ROOT / "benchmark/traffic" / f"{cell['traffic']}.json").read_text())
    assert (ROOT / "benchmark/drivers" / f"{traffic['driver']}.py").is_file()
    reported = {m["name"] for m in MANIFEST["end_to_end"]
                if cell["name"] in m.get("workloads", [cell["name"]])}
    assert "setup_s" in reported and len(reported) >= 2
    assert any(cell["name"] in m.get("workloads", []) for m in MANIFEST["per_layer"])


def test_cells_unique_and_chips():
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(set(pairs)) == len(pairs) and len(set(CELLS)) == len(CELLS)
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("metric", MANIFEST["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end(metric):
    assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("metric", MANIFEST["per_layer"], ids=lambda m: m["name"])
def test_per_layer(metric):
    assert set(metric) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"]) and line(metric["layer"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert metric["moves"] in E2E
    # every cell it lists reports the end-to-end metric it moves
    moved = next(m for m in MANIFEST["end_to_end"] if m["name"] == metric["moves"])
    for cell in metric["workloads"]:
        assert cell in CELLS and cell in moved.get("workloads", CELLS)
    assert (ROOT / "benchmark/metrics" / f"{metric['name']}.py").is_file()


def test_names_unique():
    names = E2E + [m["name"] for m in MANIFEST["per_layer"]]
    assert len(set(names)) == len(names)
    assert len({c["name"] for c in MANIFEST["configs"]}) == len(MANIFEST["configs"])


def test_files_under_paths_are_named_from_name_characters():
    for path in (ROOT / "benchmark").rglob("*"):
        if "__pycache__" in path.parts or not path.is_file():
            continue
        assert PATH.match(str(path.relative_to(ROOT))), path
