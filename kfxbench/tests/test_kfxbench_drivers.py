"""Each driver's plumbing at a tiny size on the CPU: the record it
returns, the metrics read from it and the result line's shape."""

from __future__ import annotations

import json
import math

import pytest

from conftest import bench, tiny_context
from kfxbench import run as harness
from kfxbench.core import bench as bench_mod
from kfxbench.core import devtrace


@pytest.mark.parametrize("workload", ["coder1.3b-train-s4k",
                                      "dsllm7b-serve-chat",
                                      "dsllm7b-serve-sessions"])
def test_driver_record_and_result_line(workload):
    b = bench()
    ctx = tiny_context(workload, seconds=1.5)
    rec = harness.drive(b, ctx)
    line = json.loads(json.dumps(harness.result_line(rec, ctx, "cpu")))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    want = {m["name"] for m in bench_mod.cell_metrics(b, workload,
                                                      "end_to_end")}
    assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert math.isfinite(m["value"]) and m["value"] > 0
    assert line["attempted"] > 0
    assert rec["setup_s"] > 0 and rec["window_s"] >= 1.5
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_serving_per_layer_metrics_read_the_window():
    ctx = tiny_context("dsllm7b-serve-sessions", seconds=2.0, trace=True)
    rec = harness.drive(bench(), ctx)
    got = rec["metrics"]
    # No card: the device's metrics find nothing to read and are left out.
    assert "device.idle_pct.serve" not in got
    assert got["engine.step_ms"]["value"] > 0
    assert 0 < got["engine.prefix_hit_pct"]["value"] < 100
    assert got["serve.mfu"]["value"] > 0


def test_trace_summary():
    events = [("void kfx::(anonymous namespace)::flash_fwd_wgmma_kernel<128>"
               "(CUtensorMap)", 0.0, 10.0),
              ("gemm", 5.0, 10.0), ("gemm", 30.0, 5.0),
              ("copy", 40.0, 1.0)]
    s = devtrace.summarize(events, 1e-4)
    assert s["busy_s"] == pytest.approx(21e-6)
    assert s["window_s"] == pytest.approx(41e-6)
    assert s["idle_gaps"][0] == ["after gemm", pytest.approx(15e-6)]
    assert s["device_ops"][0] == ["gemm", pytest.approx(15e-6)]
    assert devtrace.short(events[0][0]) == "kfx::flash_fwd_wgmma_kernel"
    assert s["counts"]["gemm"] == 2


def test_flash_roofline_reads_the_ports_kernels():
    from kfxbench.core import flops

    name = "void kfx::(anonymous namespace)::flash_{}_wgmma_kernel<128>(x)"
    least = flops.flash_least_seconds(4, 4096, 16, 128)["seconds"]
    trace = {"by_name": {name.format("fwd"): 2 * least,
                         name.format("dq"): 3 * least,
                         name.format("dkv"): 5 * least,
                         "pytorch_flash::flash_fwd_kernel<x>(y)": 9.0},
             "counts": {name.format("fwd"): 2, name.format("dq"): 2,
                        name.format("dkv"): 2,
                        "pytorch_flash::flash_fwd_kernel<x>(y)": 5}}
    rec = {"trace": trace, "train": {"batch": 4, "seq_len": 4096,
                                     "heads": 16, "head_dim": 128}}
    got = bench_mod.metric("flash_roofline").read(rec)
    assert got == pytest.approx(100.0 * 2 / 10)


def _serve(stamps, t_open, t_close):
    """A serving record whose one request got a token at each stamp."""
    return {"t_open": t_open, "t_close": t_close,
            "requests": [{"n_prompt": 8, "t_submit": 0.0, "times": stamps,
                          "t_done": 0.0, "failed": False}]}


def test_serve_rate_credits_the_deliveries_at_the_edges_pro_rata():
    rate = bench_mod.metric("serve_tokens_per_s")

    def burst(t, n):
        return [t + 1e-4 * i for i in range(n)]

    stamps = burst(0.0, 4) + burst(4.0, 10) + burst(8.0, 10)
    # The window [1, 10]: a quarter of the delivery at 4 s was made before
    # it, half of the one at 12 s inside it.
    got = rate.read({"serve": _serve(stamps + burst(12.0, 10), 1.0, 10.0)})
    assert got == pytest.approx((10 * 0.75 + 10 + 10 * 0.5) / 9.0, rel=1e-3)
    # No delivery after the close: the stall counts against the rate.
    got = rate.read({"serve": _serve(stamps, 1.0, 10.0)})
    assert got == pytest.approx((10 * 0.75 + 10) / 9.0, rel=1e-3)


def test_serving_comparison_samples_requests_the_window_finished():
    from kfxbench.core import bench as b

    serve = b.driver("serve")
    recs = []
    for i, t_done in enumerate([0.5, 2.0, 3.0, 4.0, 11.0]):
        r = serve.Record(i, [1, 2], 0.0, t_done=t_done)
        r.tokens = [5] * (50 if t_done in (0.5, 11.0) else 10 + i)
        recs.append(r)
    picked = serve.sample(recs, 2 ** 31 + 1, 1.0, 10.0)
    assert sorted(r.t_done for r in picked) == [2.0, 3.0, 4.0]
    assert picked[0].t_done == 4.0          # the longest comes first
