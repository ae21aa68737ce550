"""The port's timeline reconstruction (kubeflow_tpu_torch/obs/
timeline.py), its runners' spans, and the CLI verbs over the telemetry
plane (``kfx trace``, ``top``, ``query``, ``alerts``) against the
reference's.

The reference's own tests run against the port through
``_torch_ported``: tests/test_trace.py TestTimeline and
TestCrossProcessReconstruction (a 2-replica JAXJob of the port's
jax_runner whose merged timeline spans admission -> reconcile ->
gang.spawn -> runner.init -> rendezvous.wait -> xla.compile ->
train.window -> checkpoint -> runner.eval across three processes),
tests/test_telemetry.py TestQuerySurfaces (``/query`` and ``/alerts``
through the port's apiserver and its ``Client``), TestTopWatchRates and
TestTraceFilters, and tests/test_obs.py TestTracePropagation (the trace
ID from admission to the runner's env and the events, `kfx top`). Beside
TestQuerySurfaces, the CLI verbs' answers to the same bad queries.

Beside them, both packages on the same inputs: span files written from a
numpy seed (several processes, nesting, orphans, overlaps and gaps) give
equal ``load_spans``, ``build_tree``, ``critical_path``,
``render_waterfall`` and ``chrome_trace``.
"""

import json
import os
import time

import numpy as np
import pytest

pytest.importorskip("jax")

from _torch_ported import ported  # noqa: E402

_trace = ported("test_trace.py")
_telemetry = ported("test_telemetry.py")
_obs = ported("test_obs.py")
_isolated_sink = _trace._isolated_sink


class TestTimeline(_trace.TestTimeline):
    pass


class TestCrossProcessReconstruction(_trace.TestCrossProcessReconstruction):
    pass


class TestQuerySurfaces(_telemetry.TestQuerySurfaces):
    def test_bad_query_params_cli_rc2(self, plane, capsys):
        """The apiserver's 400s are the CLI's rc 2 with the same
        message; the JSON forms of query and alerts round-trip."""
        from kubeflow_tpu_torch.cli import KfxCLI

        cli = KfxCLI(plane)
        assert cli.query("kfx_gangs", "stddev", "", 60) == 2
        assert "stddev" in capsys.readouterr().err
        assert cli.query("kfx_gangs", "latest", "noequals", 60) == 2
        assert "want key=value" in capsys.readouterr().err
        cli.query("kfx_gangs", "latest", "", 60, as_json=True)
        out = json.loads(capsys.readouterr().out)
        assert out["family"] == "kfx_gangs"
        cli.alerts(as_json=True)
        alerts = json.loads(capsys.readouterr().out)["alerts"]
        assert any(a["name"] == "router-5xx-rate" for a in alerts)


class TestTopWatchRates(_telemetry.TestTopWatchRates):
    pass


class TestTraceFilters(_telemetry.TestTraceFilters):
    pass


class TestTracePropagation(_obs.TestTracePropagation):
    pass


# -- both packages on the same inputs ----------------------------------------


def _write_spans(root, seed):
    """Span logs of three processes under one trace (plus a stray
    trace), with nesting, an orphan, overlapping siblings and gaps."""
    rng = np.random.default_rng(seed)
    t0 = 1.7e9
    recs = {"plane": [], "worker-0": [], "worker-1": []}
    recs["plane"].append({"name": "admission", "span": "s0", "parent": "",
                          "ts": t0, "dur": 0.01})
    ids = ["s0"]
    for i in range(1, 40):
        proc = list(recs)[int(rng.integers(0, 3))]
        parent = ids[int(rng.integers(0, len(ids)))] \
            if rng.random() < 0.9 else "missing"
        ts = t0 + float(rng.uniform(0, 30))
        recs[proc].append({"name": f"op{int(rng.integers(0, 8))}",
                           "span": f"s{i}", "parent": parent, "ts": ts,
                           "dur": float(rng.uniform(0, 5)),
                           "attr": str(int(rng.integers(0, 9)))})
        ids.append(f"s{i}")
    recs["plane"].append({"name": "other", "span": "x", "parent": "",
                          "ts": t0, "dur": 1.0, "trace": "zz"})
    for proc, lines in recs.items():
        d = os.path.join(root, proc, "spans")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"{proc}-1.jsonl"), "w") as f:
            for r in lines:
                f.write(json.dumps({"trace": "tt", "status": "ok",
                                    "proc": proc, **r}) + "\n")
    return [os.path.join(root, p, "spans") for p in recs]


@pytest.mark.parametrize("seed", range(4))
def test_timeline_equal(tmp_path, seed):
    from kubeflow_tpu.obs import timeline as ref
    from kubeflow_tpu_torch.obs import timeline as port

    dirs = _write_spans(str(tmp_path), seed)
    out = {}
    for tag, tl in (("ref", ref), ("port", port)):
        spans = tl.load_spans(tl.span_files(dirs), "tt")
        path, covered, wall = tl.critical_path(spans)
        out[tag] = (spans, json.dumps(tl.build_tree(spans), sort_keys=True),
                    [r["span"] for r in path], covered, wall,
                    tl.render_waterfall(spans),
                    json.dumps(tl.chrome_trace(spans), sort_keys=True))
    assert out["port"] == out["ref"]
    assert len(out["port"][0]) == 40   # the stray trace left out
