"""BENCHMARK.json keeps to the benchmark's contract: keys, names, lengths,
files, and every piece the harness finds by name is there."""

from __future__ import annotations

import json
import re

from conftest import ROOT, bench
from kfxbench.core import bench as bench_mod

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|projection|head|"
                    r"expansion|experts_per_tok|_dim$|_rank$)")


def _line_ok(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert b["paths"] == ["kfxbench"]
    assert 1 <= len(b["command"]) <= 32
    assert all(_line_ok(w) and not w.startswith("/") and ".." not in w
               for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_configs():
    b = bench()
    files = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line_ok(c["why"])
        assert _line_ok(c["source"])
        assert c["file"].startswith("kfxbench/") and c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        assert not any(WIDTHS.search(k) for k in c["reduced"])
        assert (ROOT / "kfxbench" / "drivers" /
                f"{cfg['path']}.py").exists()
        assert any(w["config"] == c["name"] for w in b["workloads"])


def test_workloads():
    b = bench()
    names = [c["name"] for c in b["configs"]]
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line_ok(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (ROOT / "kfxbench" / "traffic" /
                f"{w['traffic']}.json").exists()
        assert (ROOT / "kfxbench" / "limits" / f"{w['name']}.json").exists()
    assert len({w["name"] for w in b["workloads"]}) == len(b["workloads"])


def test_metrics():
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    seen = set()
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in seen
        seen.add(m["name"])
        assert set(m.get("workloads", cells)) <= cells
        assert bench_mod.metric(m["name"]).NAME == m["name"]
    layers = {}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line_ok(m["layer"])
        assert m["moves"] in e2e
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        layers.setdefault(m["layer"], m["layer"])
    for w in cells:
        got = {m["name"] for m in bench_mod.cell_metrics(b, w, "end_to_end")}
        assert "setup_s" in got and len(got) >= 2
        assert bench_mod.cell_metrics(b, w, "per_layer")


def test_file_names_under_paths():
    allowed = re.compile(r"^[A-Za-z0-9_./-]+$")
    for p in (ROOT / "kfxbench").rglob("*"):
        if "__pycache__" in p.parts or ".cache" in p.parts:
            continue
        assert allowed.match(str(p.relative_to(ROOT))), p
