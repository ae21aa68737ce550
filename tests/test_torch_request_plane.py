"""The port's request plane (kubeflow_tpu_torch/serving/engine.py QoS
classes, deadlines and tenant rate budgets; lm_server.py's knobs and body
fields; server.py's deadline header and Retry-After) against the
reference's (kubeflow_tpu/serving/engine.py, lm_server.py, server.py), on
the reference's tiny fixture (vocab 64, d 32, L 2, f32) on the CPU.

Each case of the reference's tests/test_engine.py ``TestRequestPlane``
runs the SAME traffic through the JAX DecodeEngine and the port's, each
under its own package's chaos plan, and compares the outcome (exception
class, tokens, admission stamps, stream sentinel) and the families
(shed counters, class gauge, tenant ledger). The QoS preemption case runs
on wide-gap weights, so the preempted requests' greedy tokens are also
held to the port's LMGenerator and to the JAX engine. The serving cases
port ``TestRequestPlaneServing``'s that the port's SSE tests do not hold
(per-request class and deadline validation on the stream, the HTTP
admission contract), plus the three fixes of the port's server: ``qos``,
``tenant`` and ``deadline_ms`` reach the engine, ``X-KFX-Deadline-Ms``
merges into the body, and a shed's own ``retry_after_s`` is the
``Retry-After``."""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu import chaos as ref_chaos  # noqa: E402
from kubeflow_tpu.models import transformer as ref  # noqa: E402
from kubeflow_tpu.serving import engine as ref_engine  # noqa: E402
from kubeflow_tpu.serving import lm_server as ref_lm  # noqa: E402
from kubeflow_tpu.serving import server as ref_server  # noqa: E402
from kubeflow_tpu_torch import chaos as port_chaos  # noqa: E402
from kubeflow_tpu_torch.models import transformer as port  # noqa: E402
from kubeflow_tpu_torch.models.generate import LMGenerator  # noqa: E402
from kubeflow_tpu_torch.serving import engine as port_engine  # noqa: E402
from kubeflow_tpu_torch.serving import lm_server  # noqa: E402
from kubeflow_tpu_torch.serving import server as port_server  # noqa: E402

from test_torch_generate import MIN_GAP, TINY, recompute, wide_gap  # noqa: E402,E501

SHED_FAMILIES = ("kfx_lm_deadline_shed_total", "kfx_lm_rate_limited_total")


def _value(metric, **labels):
    """The sample of ``metric`` with exactly ``labels`` (None if absent):
    one reader for both packages' registries."""
    for lab, v in metric.samples():
        if lab == labels:
            return v
    return None


@pytest.fixture(scope="module")
def tiny():
    """(reference config, port config, wide-gap reference param tree)."""
    cfg_r = ref.TransformerConfig(**TINY, dtype=jnp.float32)
    params = ref.TransformerLM(cfg_r).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    params = wide_gap(jax.tree_util.tree_map(np.asarray, params))
    return cfg_r, port.TransformerConfig(**TINY, dtype="float32"), params


class Side:
    """One package's engine module, chaos module and engine, so a scenario
    runs the same traffic through either."""

    def __init__(self, tag, mod, chaos, eng):
        self.tag, self.mod, self.chaos, self.eng = tag, mod, chaos, eng

    def install(self, spec):
        self.chaos.install(self.chaos.parse_spec(spec) if spec else None)

    def counter(self, family):
        return _value(self.eng._reg().counter(family), model=self.eng.name)


def _make(tiny, tag, name, **kw):
    cfg_r, cfg_p, params = tiny
    kw.setdefault("n_slots", 1)
    kw.setdefault("chunk_tokens", 4)
    kw.setdefault("kv_page_size", 16)
    if tag == "ref":
        return Side(tag, ref_engine, ref_chaos, ref_engine.DecodeEngine(
            cfg_r, params, name=f"ref-{name}", draft_layers=0, **kw))
    return Side(tag, port_engine, port_chaos, port_engine.DecodeEngine(
        cfg_p, params, name=f"port-{name}", device="cpu", **kw))


@pytest.fixture(scope="module")
def sides(tiny):
    """The one-slot engines of both packages: queue behavior (deadline
    expiry, EWMA feasibility, batch shedding) is deterministic when one
    request decodes at a time."""
    made = [_make(tiny, "ref", "rp"), _make(tiny, "port", "rp")]
    made[0].eng.warm([8])
    yield made
    for s in made:
        s.eng.close()


def _both(sides, scenario):
    """Run ``scenario(side)`` on the reference, then on the port; assert
    both outcomes equal and return the port's."""
    out = {}
    for s in sides:
        try:
            out[s.tag] = scenario(s)
        finally:
            s.install(None)
    assert out["port"] == out["ref"], out
    return out["port"]


# -- engine ---------------------------------------------------------------------

def test_request_plane_families_seeded(sides):
    """The class gauge (both classes), the shed counters and the KV
    transfer families exist at zero before any traffic, in both."""
    def scenario(s):
        reg, name = s.eng._reg(), s.eng.name
        g = reg.gauge("kfx_lm_class_active")
        out = {cls: _value(g, model=name, qos=cls)
               for cls in ("interactive", "batch")}
        out.update({f: _value(reg.counter(f), model=name)
                    for f in SHED_FAMILIES})
        out["migrations"] = _value(reg.counter("kfx_lm_kv_migrations_total"),
                                   model=name, reason="drain")
        out["pages"] = _value(
            reg.counter("kfx_lm_kv_pages_transferred_total"), model=name)
        out["offload"] = _value(reg.gauge("kfx_lm_kv_offload_pages"),
                                model=name, tier="host")
        return out
    assert _both(sides, scenario) == {
        "interactive": 0, "batch": 0, SHED_FAMILIES[0]: 0,
        SHED_FAMILIES[1]: 0, "migrations": 0, "pages": 0, "offload": 0}
    assert port_engine.QOS_CLASSES == ref_engine.QOS_CLASSES


def test_qos_validated_defaulted_and_billed(sides):
    """An unknown class is a ValueError; the default is interactive; each
    class bills its own ledger row."""
    def scenario(s):
        with pytest.raises(ValueError, match="qos"):
            s.eng.submit([1, 2], max_new_tokens=2, qos="best-effort")
        r = s.eng.submit([1, 2], max_new_tokens=2, tenant="qa")
        b = s.eng.submit([1, 2], max_new_tokens=2, qos="batch",
                         tenant="qa")
        r.result(60)
        b.result(60)
        rows = sorted((row["qos"], row["requests"], row["promptTokens"],
                       row["generatedTokens"])
                      for row in s.eng.usage.snapshot()
                      if row["tenant"] == "qa")
        return r.qos, b.qos, rows
    assert _both(sides, scenario) == (
        "interactive", "batch",
        [("batch", 1, 2, 2), ("interactive", 1, 2, 2)])


def test_deadline_expired_in_queue_sheds_before_prefill(sides):
    """A queued request whose deadline lapses sheds at the slot boundary
    without a prefill: DeadlineInfeasible (a 503-class error), no tokens,
    no admission stamp, the stream's sentinel, the counter bumped."""
    def scenario(s):
        pre = s.counter("kfx_lm_deadline_shed_total")
        # A cold queue-wait estimate, whatever ran before: the doomed
        # request must pass enqueue and expire in the queue.
        s.eng._qwait_ewma = 0.0
        # The slot holder's admission stalls 0.4 s, far past the doomed
        # request's 50 ms deadline.
        s.install("engine.admit:mode=delay,delay=0.4,count=1")
        long_req = s.eng.submit([1, 2, 3], max_new_tokens=8)
        sink = []
        doomed = s.eng.submit([4, 5], max_new_tokens=4, deadline_s=0.05,
                              on_token=sink.append)
        with pytest.raises(s.mod.DeadlineInfeasible) as ei:
            doomed.result(60)
        long_req.result(120)
        return (isinstance(ei.value, s.mod.EngineOverloaded),
                doomed.tokens, doomed.t_admitted, sink,
                s.counter("kfx_lm_deadline_shed_total") - pre)
    assert _both(sides, scenario) == (True, [], 0.0, [None], 1)


def test_deadline_infeasible_at_enqueue_with_warm_ewma(sides):
    """With a queue and a warm queue-wait EWMA, a request whose deadline
    is under the estimate is refused AT SUBMIT with Retry-After 1 s."""
    def scenario(s):
        s.install("engine.admit:mode=delay,delay=0.25,count=1")
        a = s.eng.submit([1, 2], max_new_tokens=2)
        b = s.eng.submit([3, 4], max_new_tokens=2)
        b.result(120)
        a.result(120)
        s.install(None)
        warm = s.eng._qwait_ewma > 0.01
        pre = s.counter("kfx_lm_deadline_shed_total")
        # Hold the slot for the submits below (chaos, not wall-clock).
        s.install("engine.admit:mode=delay,delay=0.5,count=1")
        c = s.eng.submit([1, 2], max_new_tokens=32)
        d = s.eng.submit([3, 4], max_new_tokens=2)
        with pytest.raises(s.mod.DeadlineInfeasible) as ei:
            s.eng.submit([5, 6], max_new_tokens=2, deadline_s=0.001)
        d.result(120)
        c.result(120)
        return (warm, ei.value.retry_after_s,
                s.counter("kfx_lm_deadline_shed_total") - pre)
    assert _both(sides, scenario) == (True, 1.0, 1)


def test_batch_shed_for_interactive_arrival(sides):
    """At a full queue an interactive arrival evicts the NEWEST queued
    batch request; a batch arrival is refused outright."""
    def scenario(s):
        old_cap = s.eng.max_queue
        s.eng.max_queue = 2
        s.install("engine.admit:mode=delay,delay=1.0,count=1")
        try:
            busy = s.eng.submit([1, 2, 3], max_new_tokens=8)
            deadline = time.monotonic() + 30
            while s.eng._queue and time.monotonic() < deadline:
                time.sleep(0.001)  # popped for (stalled) admission
            b1 = s.eng.submit([4, 5], max_new_tokens=2, qos="batch")
            b2 = s.eng.submit([6, 7], max_new_tokens=2, qos="batch")
            with pytest.raises(s.mod.EngineOverloaded, match="queue full"):
                s.eng.submit([10, 11], max_new_tokens=2, qos="batch")
            keep = s.eng.submit([8, 9], max_new_tokens=2)
            with pytest.raises(s.mod.EngineOverloaded,
                               match="shed for interactive"):
                b2.result(60)
            return (len(keep.result(120)), len(b1.result(120)),
                    len(busy.result(120)), b2.tokens)
        finally:
            s.eng.max_queue = old_cap
    assert _both(sides, scenario) == (2, 2, 8, [])


def test_rate_limited_tenant_sheds_with_retry_after(tiny):
    """Token-weighted budget {base: 200 tok/s, 0.1 s burst = 20 tokens}:
    the first request (26 tokens) admits and overdraws, the next sheds as
    RateLimited with the deficit's Retry-After (the same in both), the
    counter counts it, and the refilled bucket admits again."""
    outs = {}
    for tag in ("ref", "port"):
        s = _make(tiny, tag, "rate", n_slots=2, rate_limits={"": 200.0},
                  rate_burst_s=0.1)
        try:
            r1 = s.eng.submit([1, 2], max_new_tokens=24)
            with pytest.raises(s.mod.RateLimited) as ei:
                s.eng.submit([3, 4], max_new_tokens=24)
            retry = ei.value.retry_after_s
            r1.result(120)
            deadline = time.monotonic() + 30
            while True:
                try:
                    r3 = s.eng.submit([5, 6], max_new_tokens=2)
                    break
                except s.mod.RateLimited:
                    assert time.monotonic() < deadline, "never refilled"
                    time.sleep(0.05)
            r3.result(120)
            outs[tag] = (isinstance(ei.value, s.mod.EngineOverloaded),
                         retry, s.counter("kfx_lm_rate_limited_total"))
        finally:
            s.eng.close()
    # Deficit 6 tokens + cost 26, over 200 tok/s; refill between the two
    # submits shaves microseconds.
    for tag in outs:
        assert outs[tag][0] and outs[tag][2] >= 1, outs
        assert abs(outs[tag][1] - 32 / 200.0) < 0.02, outs
    assert abs(outs["port"][1] - outs["ref"][1]) < 0.02


def test_qos_preemption_batch_victim_first(tiny):
    """Pool exhaustion with both classes in flight: every victim is a
    batch slot (batch is submitted first, so the class outranks age),
    and every request's greedy tokens equal the port's LMGenerator and
    the JAX engine's."""
    _, cfg_p, params = tiny
    gen = LMGenerator(cfg_p, params, device="cpu")
    outs = {}
    for tag in ("ref", "port"):
        s = _make(tiny, tag, "qos", n_slots=4, kv_pages=8,
                  prefix_cache=False)
        try:
            batch = [s.eng.submit([i + 1, i + 2, i + 3], max_new_tokens=40,
                                  qos="batch") for i in range(2)]
            inter = [s.eng.submit([i + 11, i + 12, i + 13],
                                  max_new_tokens=40) for i in range(2)]
            toks = [r.result(120) for r in batch + inter]
            outs[tag] = (toks, sum(r.preempts for r in batch) >= 1,
                         [r.preempts for r in inter],
                         s.counter("kfx_lm_kv_preemptions_total") >= 1)
        finally:
            s.eng.close()
    assert outs["port"] == outs["ref"]
    toks, batch_preempted, inter_preempts, counted = outs["port"]
    assert batch_preempted and inter_preempts == [0, 0] and counted
    for i, p in enumerate([[1, 2, 3], [2, 3, 4], [11, 12, 13],
                           [12, 13, 14]]):
        assert recompute(cfg_p, params, p, 40)[1] > MIN_GAP
        assert toks[i] == gen.generate([p], max_new_tokens=40)[0]


def test_generate_deadline_is_the_wait_budget(sides):
    """``generate(deadline_s=...)`` waits on the request's own deadline:
    a request queued behind a 0.4 s stall with a 0.1 s deadline sheds
    (DeadlineInfeasible at the slot boundary), it never times out."""
    def scenario(s):
        s.install("engine.admit:mode=delay,delay=0.4,count=1")
        holder = s.eng.submit([1, 2, 3], max_new_tokens=4)
        with pytest.raises(s.mod.DeadlineInfeasible):
            s.eng.generate([[4, 5]], max_new_tokens=2, deadline_s=0.1)
        return len(holder.result(120))
    assert _both(sides, scenario) == 4


# -- serving --------------------------------------------------------------------

@pytest.fixture(scope="module")
def export(tiny, tmp_path_factory):
    cfg_r, _, params = tiny
    d = str(tmp_path_factory.mktemp("rp") / "lm")
    ref_lm.export_lm(d, cfg_r, params)
    return d


def _predictor(pkg, export, **kw):
    if pkg == "ref":
        p = ref_lm.LMPredictor(export, name="lm", warm_buckets=[8], **kw)
    else:
        p = lm_server.LMPredictor(export, name="lm", warm_buckets=[8],
                                  device="cpu", **kw)
    p.load()
    return p


def _serve(pkg, export, **kw):
    p = _predictor(pkg, export, **kw)
    srv = (ref_server if pkg == "ref" else port_server).ModelServer(port=0)
    srv.register(p)
    srv.start()
    return srv, p


def _post(url, body, headers=None, timeout=60):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def test_stream_validation(export, monkeypatch):
    """The stream path validates the class and the deadline before any
    byte streams: an unknown class and a non-number deadline are
    ValueErrors (400s), as in the reference."""
    monkeypatch.setenv("KFX_LM_ENGINE", "1")
    monkeypatch.setenv("KFX_LM_SPEC", "0")
    p = _predictor("port", export)
    try:
        with pytest.raises(ValueError, match="exactly one prompt"):
            p.generate_stream({"prompt_tokens": [[1], [2]]})
        with pytest.raises(ValueError, match="stream_skip"):
            p.generate_stream({"prompt_tokens": [[1]], "stream_skip": True})
        with pytest.raises(ValueError, match="qos"):
            p.generate_stream({"prompt_tokens": [[1]], "qos": "bulk"})
        with pytest.raises(ValueError, match="deadline_ms"):
            p.generate_stream({"prompt_tokens": [[1]],
                               "deadline_ms": True})
        with pytest.raises(ValueError, match="qos"):
            p.generate({"prompt_tokens": [[1]], "qos": "bulk"})
    finally:
        p.close()


def _shed_behind_stall(p, chaos, url, body, headers=None):
    """POST ``body`` while the one-slot engine's holder is stalled 0.4 s in
    admission, then wait for the engine to shed it at the slot boundary.
    Returns (HTTP code, shed counter delta)."""
    import threading

    eng = p._engine
    reg = eng._reg()
    pre = _value(reg.counter("kfx_lm_deadline_shed_total"),
                 model=eng.name) or 0
    chaos.install(chaos.parse_spec(
        "engine.admit:mode=delay,delay=0.4,count=1"))
    try:
        holder = threading.Thread(target=_post, args=(
            url, {"prompt_tokens": [[3, 4]], "max_new_tokens": 2}))
        holder.start()
        deadline = time.monotonic() + 30
        while eng._admitting is None and eng.queue_depth == 0:
            assert time.monotonic() < deadline
            time.sleep(0.002)
        code, _, _ = _post(url, body, headers)
        holder.join(60)
    finally:
        chaos.install(None)
    deadline = time.monotonic() + 30
    while eng.queue_depth or eng._admitting is not None:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    post = _value(reg.counter("kfx_lm_deadline_shed_total"),
                  model=eng.name) or 0
    return code, post - pre


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_body_fields_reach_the_engine(export, monkeypatch, pkg):
    """The server's first fix: ``{"qos": "bogus"}`` is a 400 (the engine
    refuses the class), and ``qos``, ``tenant`` and ``deadline_ms`` ride
    into the engine: the ledger bills the batch class to the named
    tenant, and a 50 ms deadline behind a 0.4 s admission stall is shed
    by the engine at the slot boundary (the client's wait, which the
    deadline also bounds, ends first: a 500 in both packages)."""
    monkeypatch.setenv("KFX_LM_ENGINE", "1")
    monkeypatch.setenv("KFX_LM_SPEC", "0")
    srv, p = _serve(pkg, export, max_batch_size=1)
    chaos = ref_chaos if pkg == "ref" else port_chaos
    url = f"http://127.0.0.1:{srv.port}/v1/models/lm:generate"
    try:
        code, _, body = _post(url, {"prompt_tokens": [[1, 2]],
                                    "qos": "bogus"})
        assert code == 400 and "qos" in json.loads(body)["error"]
        code, _, _ = _post(url, {"prompt_tokens": [[1, 2]],
                                 "max_new_tokens": 3, "qos": "batch",
                                 "tenant": "acme"})
        assert code == 200
        rows = [(r["qos"], r["requests"], r["generatedTokens"])
                for r in p._engine.usage.snapshot()
                if r["tenant"] == "acme"]
        assert rows == [("batch", 1, 3)]
        assert _shed_behind_stall(p, chaos, url, {
            "prompt_tokens": [[5, 6]], "max_new_tokens": 2,
            "deadline_ms": 50}) == (500, 1)
    finally:
        srv.stop()


def test_server_sse_endpoint_and_admission(export, monkeypatch):
    """The reference's HTTP admission case on both servers, same traffic:
    a stream with ``X-KFX-Deadline-Ms`` matches the buffered answer; an
    overdrawn tenant sheds with a pre-stream 503 on the stream and the
    buffered path, whose ``Retry-After`` is the shed's own deficit-derived
    value (the server's third fix), equal in both; a malformed deadline
    header is a 400 (the second fix)."""
    monkeypatch.setenv("KFX_LM_ENGINE", "1")
    monkeypatch.setenv("KFX_LM_SPEC", "0")
    # 4 tok/s x 5 s = a 20-token budget; each request weighs 3 + 10.
    monkeypatch.setenv("KFX_LM_RATE_LIMITS", json.dumps({"": 4}))
    monkeypatch.setenv("KFX_LM_RATE_BURST_S", "5")
    seen = {}
    for pkg in ("ref", "port"):
        srv, _ = _serve(pkg, export)
        url = f"http://127.0.0.1:{srv.port}/v1/models/lm:generate"
        body = {"prompt_tokens": [[5, 9, 11]], "max_new_tokens": 10}
        try:
            code, _, raw = _post(url, dict(body))
            assert code == 200
            want = json.loads(raw)["generated_tokens"][0]
            code, headers, raw = _post(url, {**body, "stream": True},
                                       {"X-KFX-Deadline-Ms": "30000"})
            assert code == 200
            assert headers["Content-Type"] == "text/event-stream"
            events = [json.loads(seg.split(b"data: ", 1)[1])
                      for seg in raw.split(b"\n\n") if b"data: " in seg]
            assert [e["token"] for e in events if "token" in e] == want
            assert events[-1]["done"] is True
            code, headers, raw = _post(url, {**body, "stream": True})
            assert code == 503 and "budget" in json.loads(raw)["error"]
            retry = [float(headers["Retry-After"])]
            code, headers, raw = _post(url, dict(body))
            assert code == 503
            retry.append(float(headers["Retry-After"]))
            code, _, _ = _post(url, dict(body),
                               {"X-KFX-Deadline-Ms": "soon"})
            assert code == 400
            seen[pkg] = (want, retry)
        finally:
            srv.stop()
    assert seen["port"][0] == seen["ref"][0]
    # Deficit 6 + cost 13 at 4 tok/s: 4.75 s, printed to one decimal.
    for pkg, (_, retry) in seen.items():
        assert all(4.0 <= r <= 5.0 for r in retry), (pkg, retry)
    # The deficit refills between the shed and the next submit: the two
    # servers agree to the refill of a few hundred ms.
    assert np.allclose(seen["port"][1], seen["ref"][1], atol=0.4), seen


def test_deadline_header_reaches_the_engine(export, monkeypatch):
    """The header alias reaches the engine, not only its parse: a 50 ms
    ``X-KFX-Deadline-Ms`` behind a 0.4 s admission stall is shed by the
    engine; the body's ``deadline_ms`` wins over the header."""
    monkeypatch.setenv("KFX_LM_ENGINE", "1")
    monkeypatch.setenv("KFX_LM_SPEC", "0")
    srv, p = _serve("port", export, max_batch_size=1)
    url = f"http://127.0.0.1:{srv.port}/v1/models/lm:generate"
    body = {"prompt_tokens": [[5, 6]], "max_new_tokens": 2}
    try:
        assert _shed_behind_stall(p, port_chaos, url, body, {
            "X-KFX-Deadline-Ms": "50"}) == (500, 1)
        assert _shed_behind_stall(p, port_chaos, url, dict(
            body, deadline_ms=30000), {"X-KFX-Deadline-Ms": "50"}) == (200, 0)
    finally:
        srv.stop()


@pytest.mark.parametrize("make,want", [
    (lambda: port_engine.RateLimited("over", retry_after_s=4.75), "4.8"),
    (lambda: port_engine.DeadlineInfeasible("late"), "1.0"),
    (lambda: port_engine.RequestMigrated("gone", peer="h:1"), "0.1"),
    (lambda: port_engine.EngineOverloaded("full"), "1")])
def test_retry_after_is_the_sheds_own(make, want):
    """The server's third fix, per class: an EngineOverloaded that carries
    ``retry_after_s`` answers it (one decimal, the reference's format); a
    plain overload answers 1 s. The reference's server formats the same
    errors the same way."""
    e = make()
    assert port_server.ModelServer._retry_after(e) == {"Retry-After": want}
    retry = getattr(e, "retry_after_s", None)
    assert (f"{retry:.1f}" if retry else "1") == want
