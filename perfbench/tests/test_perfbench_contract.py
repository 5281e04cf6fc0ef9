"""BENCHMARK.json against the benchmark's contract, and every name in it
against a file of its own under perfbench/."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    assert len(BENCH["command"]) <= 32 and all(line(w) for w in BENCH["command"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert line(c["source"]) and line(c["why"])
        assert c["file"] == f"perfbench/configs/{c['name']}.json" and c["file"] not in files
        files.add(c["file"])
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"] and len(c["reduced"]) <= 16


def test_workloads():
    names = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert 1 <= len(BENCH["workloads"]) <= 24 and four <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in names
        assert w["chips"] in (1, 4) and line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = json.loads((ROOT / "perfbench/traffic" / f"{w['traffic']}.json").read_text())
        assert (ROOT / "perfbench/drivers" / f"{traffic['driver']}.py").is_file()


def metrics_of(cell):
    out = {}
    for section in ("end_to_end", "per_layer"):
        for m in BENCH[section]:
            if m.get("workloads") is None or cell in m["workloads"]:
                out[m["name"]] = section
    return out


def test_metrics():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    seen = set()
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for section, folder in (("end_to_end", "end_to_end"), ("per_layer", "metrics")):
        for m in BENCH[section]:
            extra = {"workloads"} if "workloads" in m else set()
            keys = {"name", "unit", "better", "source", "bound"} if section == "end_to_end" else \
                {"name", "unit", "better", "source", "layer", "moves"}
            assert set(m) == keys | extra
            assert NAME.match(m["name"]) and m["name"] not in seen and UNIT.match(m["unit"])
            seen.add(m["name"])
            assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
            assert set(m.get("workloads", [])) <= cells
            assert (ROOT / "perfbench" / folder / f"{m['name']}.py").is_file()
            if section == "end_to_end":
                assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
            else:
                assert line(m["layer"]) and m["moves"] in e2e
                for cell in m.get("workloads", cells):
                    assert m["moves"] in metrics_of(cell)
            if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
                assert m["source"] == "device_trace"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_enough(cell):
    mine = metrics_of(cell)
    assert "setup_s" in mine
    assert sum(1 for k, s in mine.items() if s == "end_to_end" and k != "setup_s") >= 1
    assert any(s == "per_layer" for s in mine.values())
