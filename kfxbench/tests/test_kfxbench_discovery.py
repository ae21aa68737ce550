"""A configuration, a traffic mix, a kind of traffic and a metric dropped
in as new files, with new entries in BENCHMARK.json, are found by name;
no file that was there changes."""

from __future__ import annotations

import hashlib
import json
import shutil
import sys

from conftest import ROOT


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def _copy(tmp_path):
    bench_dir = tmp_path / "kfxbench"
    shutil.copytree(ROOT / "kfxbench", bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    return bench_dir, _digests(bench_dir)


def _import_copy(tmp_path, monkeypatch):
    monkeypatch.syspath_prepend(str(tmp_path))
    for name in [m for m in sys.modules if m.split(".")[0] == "kfxbench"]:
        monkeypatch.delitem(sys.modules, name)
    from kfxbench import run as harness

    assert harness.ROOT == tmp_path
    return harness


def test_new_files_and_entries_are_found(tmp_path, monkeypatch):
    bench_dir, before = _copy(tmp_path)
    cfg = json.loads((bench_dir / "configs" /
                      "deepseek-llm-7b.json").read_text())
    cfg["name"] = "dsllm7b-int8kv"
    cfg["port"]["engine"]["kv_quant"] = "int8"
    (bench_dir / "configs" / "dsllm7b-int8kv.json").write_text(
        json.dumps(cfg))
    mix = json.loads((bench_dir / "traffic" / "chat.json").read_text())
    mix["clients"] = 96
    (bench_dir / "traffic" / "chat-wide.json").write_text(json.dumps(mix))
    (bench_dir / "limits" / "dsllm7b-int8kv-chat-wide.json").write_text(
        json.dumps({"logit_gap": 1.0}))
    (bench_dir / "metrics" / "engine_queue_s.py").write_text(
        'NAME = "engine.queue_s"\n\n\ndef read(rec):\n'
        '    return 1.5 if rec.get("serve") else None\n')
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][1], name="dsllm7b-int8kv",
                                 file="kfxbench/configs/dsllm7b-int8kv.json"))
    bench["workloads"].append({"name": "dsllm7b-int8kv-chat-wide",
                               "config": "dsllm7b-int8kv",
                               "traffic": "chat-wide", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "engine.queue_s", "unit": "s",
                               "better": "lower", "source": "host_clock",
                               "layer": "engine (serving/engine.py)",
                               "moves": "ttft_p95_ms"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(bench_dir)
    assert {k: v for k, v in after.items() if k in before} == before

    import torch

    harness = _import_copy(tmp_path, monkeypatch)
    from kfxbench.core import bench as bench_mod

    ctx = harness.context(bench, "dsllm7b-int8kv-chat-wide", 1, 1.0, True,
                          torch.device("cpu"), 0.0)
    assert ctx.config["port"]["engine"]["kv_quant"] == "int8"
    assert ctx.traffic["clients"] == 96
    assert ctx.limits == {"logit_gap": 1.0}
    assert bench_mod.driver(ctx.config["path"]).run
    names = [m["name"] for m in bench_mod.cell_metrics(
        bench, "dsllm7b-int8kv-chat-wide", "per_layer")]
    assert "engine.queue_s" in names
    assert bench_mod.metric("engine.queue_s").read({"serve": {"requests": []}}) == 1.5


PACED = '''"""Every client sends one seeded prompt again and again, a pause
before each."""

import time

import numpy as np

from kfxbench.core.traffic import seed64


def requests(mix, vocab, seed):
    return Paced(mix, vocab, seed)


class Paced:
    def __init__(self, mix, vocab, seed):
        self.clients = mix["clients"]
        rng = np.random.default_rng([seed64(seed), 9])
        self.prompt = rng.integers(0, vocab, mix["prompt"]).tolist()
        self.max_new, self.pause_s = mix["output"], mix["pause_s"]

    def prefill_range(self):
        return len(self.prompt), len(self.prompt)

    def stream(self, client):
        while True:
            time.sleep(self.pause_s)
            yield list(self.prompt), self.max_new
'''


def test_new_kind_of_traffic_drives_the_serve_driver(tmp_path, monkeypatch):
    from conftest import TINY_MODEL

    bench_dir, before = _copy(tmp_path)
    (bench_dir / "generators" / "paced.py").write_text(PACED)
    (bench_dir / "traffic" / "paced.json").write_text(json.dumps(
        {"kind": "paced", "clients": 3, "prompt": 20, "output": 4,
         "pause_s": 0.05}))
    cfg = json.loads((bench_dir / "configs" /
                      "deepseek-llm-7b.json").read_text())
    engine = dict(cfg["port"]["engine"], n_slots=4, kv_pages=64)
    cfg = dict(cfg, **TINY_MODEL, name="tiny-lm",
               max_position_embeddings=256,
               port=dict(cfg["port"], engine=engine))
    (bench_dir / "configs" / "tiny-lm.json").write_text(json.dumps(cfg))
    (bench_dir / "limits" / "tiny-lm-paced.json").write_text(
        json.dumps({"logit_gap": 0.3}))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][1], name="tiny-lm",
                                 file="kfxbench/configs/tiny-lm.json"))
    bench["workloads"].append({"name": "tiny-lm-paced", "config": "tiny-lm",
                               "traffic": "paced", "chips": 1,
                               "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(bench_dir)
    assert {k: v for k, v in after.items() if k in before} == before

    import time

    import torch

    harness = _import_copy(tmp_path, monkeypatch)
    ctx = harness.context(bench, "tiny-lm-paced", 3, 3.0, False,
                          torch.device("cpu"), time.perf_counter())
    rec = harness.drive(bench, ctx)
    from kfxbench.core import bench as bench_mod
    from kfxbench.core import compare

    assert all(q["n_prompt"] == 20 for q in rec["serve"]["requests"])
    assert rec["attempted"] > 0 and rec["failed"] == 0
    assert bench_mod.metric("serve_tokens_per_s").read(rec) > 0
    assert compare.passed(rec["checks"])
