"""The port's flight recorder (kubeflow_tpu_torch/obs/flightrec.py) and
its surfaces in the DecodeEngine, LMPredictor and ModelServer, against the
reference's (kubeflow_tpu/obs/flightrec.py, tests/test_flightrec.py
TestFlightRecorderUnit, TestEngineFlight and TestFlightHTTP; the
engine.wedge chaos case waits for the port's chaos points), on the
reference's tiny fixture (vocab 64, d 32, H 2, D 16, L 2, d_ff 64,
max_seq_len 64, f32) on the CPU.

Tolerances: none. The recorder is host bookkeeping, so records, trails
and timings are held equal in keys and exact in the values both sides
compute from the same inputs; greedy tokens are held equal with the
recorder on and off (plain and speculative), and the healthz snapshot
must parse with the reference's ``kfx flight`` reader."""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from kubeflow_tpu.models import transformer as ref  # noqa: E402
from kubeflow_tpu.obs import flightrec as ref_flightrec  # noqa: E402
from kubeflow_tpu_torch.models import transformer as port  # noqa: E402
from kubeflow_tpu_torch.obs import flightrec  # noqa: E402
from kubeflow_tpu_torch.obs.flightrec import (  # noqa: E402
    MAX_EVENTS, FlightRecorder, render_timeline)
from kubeflow_tpu_torch.serving.engine import DecodeEngine  # noqa: E402

from test_torch_generate import TINY  # noqa: E402

TIMING_KEYS = ("queue_wait_s", "prefill_s", "decode_s", "stalled_s",
               "spec_accept")
RECORD_KEYS = ("it", "ts", "active", "prefilling", "pages_free",
               "draft_pages_free", "spec_proposed", "spec_accepted",
               "stall_s", "queue_depth", "preemptions")


@pytest.fixture(scope="module")
def tiny_lm():
    """(port config, the reference's param tree as numpy)."""
    cfg_r = ref.TransformerConfig(**TINY, dtype=jnp.float32)
    params = ref.TransformerLM(cfg_r).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    return port.TransformerConfig(**TINY, dtype="float32"), params


class _FakeReq:
    """The duck-typed slice of Request the recorder reads."""

    def __init__(self, **kw):
        self.rid = 1
        self.events = []
        self.tokens = [7, 8, 9]
        self.error = None
        self.preempts = 0
        self.stall_s = 0.0
        self.spec_prop = 0
        self.spec_acc = 0
        self.t_enqueue = 100.0
        self.t_admitted = 100.5
        self.t_first = 101.5
        self.t_done = 102.0
        for k, v in kw.items():
            setattr(self, k, v)


def _fill(rec, n, **kw):
    args = dict(prefilling=[], pages_free=3, draft_pages_free=0,
                spec_proposed=0, spec_accepted=0, stall_s=0.0,
                queue_depth=1, preemptions=0)
    args.update(kw)
    for i in range(n):
        rec.record_iteration(iteration=i, active=[(0, i)], **args)


# -- recorder unit -----------------------------------------------------------


class TestFlightRecorderUnit:
    def test_ring_is_bounded_and_keeps_newest(self):
        rec = FlightRecorder(ring_size=16, recent_size=8)
        _fill(rec, 40)
        assert len(rec) == 16
        records = rec.snapshot()["records"]
        assert [r["it"] for r in records] == list(range(24, 40))
        assert records[-1]["active"] == [(0, 39)]
        assert set(records[-1]) == set(RECORD_KEYS)

    def test_recent_ring_is_bounded(self):
        rec = FlightRecorder(ring_size=16, recent_size=8)
        for i in range(20):
            rec.retire(_FakeReq(rid=i))
        reqs = rec.requests()["requests"]
        assert len(reqs) == 8
        assert [r["rid"] for r in reqs] == list(range(12, 20))
        assert reqs[-1]["timing"]["queue_wait_s"] == 0.5

    def test_event_trail_drops_middle_not_unbounded(self):
        req = _FakeReq()
        for i in range(MAX_EVENTS + 50):
            FlightRecorder.event(req, "prefill_chunk", start=i)
        assert len(req.events) == MAX_EVENTS + 1
        assert req.events[-1]["ev"] == "dropped"
        assert req.events[-1]["n"] == 50
        assert req.events[0]["ev"] == "prefill_chunk"

    def test_timing_breakdown_math(self):
        req = _FakeReq(stall_s=0.25, spec_prop=10, spec_acc=7)
        t = FlightRecorder.timing(req)
        assert t["queue_wait_s"] == pytest.approx(0.5)
        assert t["prefill_s"] == pytest.approx(1.0)
        assert t["decode_s"] == pytest.approx(0.5)
        assert t["stalled_s"] == pytest.approx(0.25)
        assert t["spec_accept"] == pytest.approx(0.7)
        assert FlightRecorder.timing(_FakeReq())["spec_accept"] is None
        # The reference computes the same breakdown from the same request.
        assert t == ref_flightrec.FlightRecorder.timing(req)

    def test_env_knobs(self, monkeypatch):
        monkeypatch.setenv("KFX_FLIGHT", "0")
        assert not flightrec.enabled_from_env()
        monkeypatch.delenv("KFX_FLIGHT")
        assert flightrec.enabled_from_env()
        monkeypatch.setenv("KFX_FLIGHT_RING", "4")   # floor is 16
        assert flightrec.ring_size_from_env() == 16
        monkeypatch.setenv("KFX_FLIGHT_RING", "bogus")
        assert flightrec.ring_size_from_env() == flightrec.DEFAULT_RING
        monkeypatch.setenv("KFX_FLIGHT_RECENT", "9")
        assert flightrec.recent_size_from_env() == 9

    def test_render_timeline_marks_wedged_tail(self):
        rec = FlightRecorder(ring_size=16, recent_size=8)
        for i in range(5):
            rec.record_iteration(iteration=i, active=[(1, 42)],
                                 prefilling=[(0, 43)], pages_free=2,
                                 draft_pages_free=0, spec_proposed=8,
                                 spec_accepted=5, stall_s=0.001,
                                 queue_depth=3, preemptions=1)
        hb = {"wedged": True, "iterations": 4, "stalled_s": 7.5,
              "busy": True, "compiling": False}
        records = rec.snapshot()["records"]
        out = render_timeline(records, heartbeat=hb)
        assert "s1:r42" in out and "s0:r43*" in out
        assert "spec 5/8" in out
        assert "<== WEDGED after this iteration" in out
        assert "iterations=4" in out
        assert render_timeline([]) == "(flight ring empty)"
        # The reference's renderer draws the port's records identically.
        assert out == ref_flightrec.render_timeline(records, heartbeat=hb)

    def test_payload_keys_match_reference(self):
        """Snapshot, request and record dicts carry the reference's keys,
        so the reference's readers parse the port's files."""
        ours = FlightRecorder(ring_size=16, recent_size=8)
        theirs = ref_flightrec.FlightRecorder(ring_size=16, recent_size=8)
        for rec in (ours, theirs):
            _fill(rec, 3)
            rec.retire(_FakeReq(events=[{"ev": "admit", "ts": 1.0}]))
        assert set(ours.snapshot({"wedged": False})) == \
            set(theirs.snapshot({"wedged": False}))
        a, b = ours.requests(), theirs.requests()
        assert set(a) == set(b)
        assert a["requests"] == b["requests"]
        strip = lambda rs: [{k: v for k, v in r.items() if k != "ts"}
                            for r in rs]
        assert strip(ours.snapshot()["records"]) == \
            strip(theirs.snapshot()["records"])


# -- engine hooks ------------------------------------------------------------


def _engine(tiny_lm, **kw):
    cfg, params = tiny_lm
    kw.setdefault("n_slots", 2)
    kw.setdefault("chunk_tokens", 4)
    kw.setdefault("kv_page_size", 16)
    return DecodeEngine(cfg, params, device="cpu", **kw)


class TestEngineFlight:
    @pytest.fixture(scope="class")
    def engine(self, tiny_lm):
        eng = _engine(tiny_lm, name="lm-flight", prefill_chunk_tokens=16,
                      stall_threshold_s=0.5)
        yield eng
        eng.close()

    @pytest.mark.parametrize("draft", [0, 1], ids=["plain", "spec"])
    def test_recorder_on_by_default_and_output_identical_off(
            self, tiny_lm, draft):
        """The recorder is built unless KFX_FLIGHT=0, and the greedy
        tokens are identical with it detached: the hooks observe, never
        steer (plain chunks and speculative iterations)."""
        eng = _engine(tiny_lm, name=f"lm-flight-{draft}",
                      draft_layers=draft)
        try:
            assert eng.flight is not None
            prompts = [[5, 9, 11, 3], [2, 4]]
            with_rec = eng.generate(prompts, max_new_tokens=8)
            recorder = eng.flight
            eng.flight = None
            try:
                without = eng.generate(prompts, max_new_tokens=8)
            finally:
                eng.flight = recorder
            assert with_rec == without
            assert len(recorder) > 0
            if draft:
                last = recorder.requests()["requests"][-1]
                assert last["timing"]["spec_accept"] is not None
                rec = recorder.snapshot()["records"][-1]
                assert rec["spec_proposed"] > 0
                assert rec["draft_pages_free"] > 0
        finally:
            eng.close()

    def test_iteration_records_and_request_trail(self, engine):
        # 40-token prompt over 16-token chunks: chunked admission, so the
        # trail carries per-chunk events.
        prompt = [(i % 50) + 2 for i in range(40)]
        out = engine.generate([prompt], max_new_tokens=6)
        assert len(out[0]) == 6
        snap = engine.flight.snapshot(heartbeat=engine.heartbeat())
        assert snap["records"], "no iteration records after traffic"
        its = [r["it"] for r in snap["records"]]
        assert its == sorted(its)
        assert snap["heartbeat"]["iterations"] >= its[-1]
        assert any(r["prefilling"] for r in snap["records"])
        reqs = engine.flight.requests()["requests"]
        assert reqs, "no retired requests in the recent ring"
        last = reqs[-1]
        names = [e["ev"] for e in last["events"]]
        assert names[0] == "admit"
        assert "first_token" in names and names[-1] == "retire"
        assert names.count("prefill_chunk") >= 2
        t = last["timing"]
        assert t["queue_wait_s"] >= 0 and t["prefill_s"] > 0
        assert last["tokens"] == 6 and last["error"] is None
        # The gauge mirrors the ring (refreshed with the other gauges;
        # the engine is idle here).
        engine._touch_gauges()
        fam = engine._reg().gauge("kfx_lm_flight_ring_records")
        assert dict((lbl["model"], v) for lbl, v in fam.samples())[
            "lm-flight"] == len(engine.flight)

    def test_preempt_event_in_trail(self, tiny_lm):
        """A pool of one max-length request's pages preempts the younger
        of two requests; its trail records the preemption."""
        eng = _engine(tiny_lm, name="lm-flight-pre", kv_pages=4)
        try:
            eng.generate([[1, 2, 3] * 5, [4, 5, 6] * 5], max_new_tokens=40)
            assert eng.page_stats()["preemptions"] >= 1
            trails = [[e["ev"] for e in r["events"]]
                      for r in eng.flight.requests()["requests"]]
            assert any("preempt" in t for t in trails), trails
            assert all(t[-1] == "retire" for t in trails)
            assert eng.flight.snapshot()["records"][-1]["preemptions"] >= 1
        finally:
            eng.close()

    def test_kfx_flight_0_disables_recorder(self, tiny_lm, monkeypatch):
        monkeypatch.setenv("KFX_FLIGHT", "0")
        eng = _engine(tiny_lm, n_slots=1, name="lm-noflight")
        try:
            assert eng.flight is None
            assert len(eng.generate([[3, 5]], max_new_tokens=4)[0]) == 4
        finally:
            eng.close()

    @pytest.mark.parametrize("draft", [0, 1], ids=["plain", "spec"])
    def test_record_reads_no_tensor(self, tiny_lm, monkeypatch, draft):
        """``_record_flight`` is host bookkeeping: with every read-back of
        a tensor made to raise while it runs, the engine still serves and
        records (on the card a read-back is a device sync)."""
        eng = _engine(tiny_lm, name=f"lm-flight-nosync-{draft}",
                      draft_layers=draft)
        inside = []

        def forbid(name):
            real = getattr(torch.Tensor, name)

            def guarded(self, *a, **kw):
                if inside:
                    raise AssertionError(f"Tensor.{name} in _record_flight")
                return real(self, *a, **kw)
            monkeypatch.setattr(torch.Tensor, name, guarded)

        for name in ("item", "tolist", "cpu", "numpy", "__bool__",
                     "__float__", "__int__", "__index__"):
            forbid(name)
        real_record = eng._record_flight
        errors = []

        def watched():
            inside.append(1)
            try:
                real_record()
            except AssertionError as e:
                errors.append(e)
                raise
            finally:
                inside.pop()
        eng._record_flight = watched
        try:
            out = eng.generate([[5, 9, 11, 3], [2, 4]], max_new_tokens=6)
            assert [len(o) for o in out] == [6, 6]
            assert not errors, errors
            assert len(eng.flight) > 0
        finally:
            eng.close()


# -- model server surfaces ---------------------------------------------------


class TestFlightHTTP:
    @pytest.fixture(scope="class")
    def lm_server(self, tiny_lm, tmp_path_factory):
        from kubeflow_tpu_torch.serving.lm_server import (
            LMPredictor, export_lm)
        from kubeflow_tpu_torch.serving.server import ModelServer

        cfg, params = tiny_lm
        root = str(tmp_path_factory.mktemp("flight-lm"))
        export_lm(os.path.join(root, "lm"), cfg, params)
        p = LMPredictor(os.path.join(root, "lm"), name="lm", device="cpu")
        p.load()
        srv = ModelServer(port=0)
        srv.register(p)
        srv.start()
        yield srv, p
        srv.stop()
        p.close()

    def _get(self, port, path):
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            return r.status, json.load(r)

    def _post(self, port, body):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/models/lm:generate",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        return urllib.request.urlopen(req, timeout=60)

    def _generate(self, port, body):
        with self._post(port, body) as r:
            return r.headers, json.load(r)

    def test_generate_returns_timing_block_and_header(self, lm_server):
        srv, _ = lm_server
        headers, body = self._generate(
            srv.port, {"prompt_tokens": [[5, 9, 11], [2, 4]],
                       "max_new_tokens": 4})
        assert [len(g) for g in body["generated_tokens"]] == [4, 4]
        assert len(body["timing"]) == 2
        for t in body["timing"]:
            assert tuple(t) == TIMING_KEYS
        hdr = headers.get("X-Kfx-Timing")
        assert hdr and "queue_wait_s=" in hdr and "decode_s=" in hdr

    def test_stream_done_event_carries_timing(self, lm_server):
        srv, _ = lm_server
        with self._post(srv.port, {"prompt_tokens": [[5, 9, 11]],
                                   "max_new_tokens": 4,
                                   "stream": True}) as r:
            events = [json.loads(line[len(b"data: "):])
                      for line in r.read().splitlines()
                      if line.startswith(b"data: ")]
        done = events[-1]
        assert done["done"] is True and done["n_tokens"] == 4
        assert tuple(done["timing"]) == TIMING_KEYS

    def test_debug_flight_and_requests_endpoints(self, lm_server):
        srv, p = lm_server
        self._generate(srv.port, {"prompt_tokens": [[2, 4, 6]],
                                  "max_new_tokens": 4})
        status, doc = self._get(srv.port, "/debug/flight")
        assert status == 200
        snap = doc["models"]["lm"]
        assert snap["records"] and snap["ring_size"] >= 16
        assert snap["heartbeat"]["wedged"] is False
        status, doc = self._get(srv.port, "/debug/requests")
        assert status == 200
        reqs = doc["models"]["lm"]["requests"]
        assert reqs and reqs[-1]["timing"]["decode_s"] >= 0
        names = [e["ev"] for e in reqs[-1]["events"]]
        assert names[0] == "admit" and names[-1] == "retire"
        assert "first_token" in names

    def test_debug_flight_404_when_recorder_off(self, lm_server):
        srv, p = lm_server
        recorder = p._engine.flight
        p._engine.flight = None
        try:
            for path in ("/debug/flight", "/debug/requests"):
                with pytest.raises(urllib.error.HTTPError) as ei:
                    self._get(srv.port, path)
                assert ei.value.code == 404
            # No recorder, no timing block and no header.
            headers, body = self._generate(
                srv.port, {"prompt_tokens": [[1, 3]], "max_new_tokens": 2})
            assert "timing" not in body
            assert headers.get("X-Kfx-Timing") is None
        finally:
            p._engine.flight = recorder

    def test_healthz_writes_snapshot_file(self, lm_server, tmp_path,
                                          monkeypatch):
        """/healthz writes an atomic flight snapshot into
        $KFX_WORKDIR/flight/, which the reference's ``kfx flight``
        reader and renderer parse."""
        srv, _ = lm_server
        monkeypatch.setenv("KFX_WORKDIR", str(tmp_path))
        monkeypatch.setenv("KFX_COMPONENT", "default-0")
        srv._flight_snap_ts = 0.0
        self._generate(srv.port, {"prompt_tokens": [[1, 3]],
                                  "max_new_tokens": 2})
        self._get(srv.port, "/healthz")
        path = tmp_path / "flight" / f"default-0-{os.getpid()}.json"
        assert path.exists(), "healthz did not persist a flight snapshot"
        doc = json.loads(path.read_text())
        assert doc["pid"] == os.getpid()
        assert doc["models"]["lm"]["records"]
        from kubeflow_tpu.cli import _flight_models

        models = _flight_models(doc)
        assert "lm" in models
        out = ref_flightrec.render_timeline(models["lm"]["records"])
        assert "it " in out and "kv[" in out
        # Throttled: a second probe within KFX_FLIGHT_SNAP_S leaves it.
        mtime = path.stat().st_mtime_ns
        self._get(srv.port, "/healthz")
        assert path.stat().st_mtime_ns == mtime
