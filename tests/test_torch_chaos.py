"""The port's chaos points (kubeflow_tpu_torch/chaos and its sites in the
engine, the server, the checkpointer and the JAXJob runner) against the
reference's (kubeflow_tpu/chaos, tests/test_chaos.py, test_engine.py,
test_flightrec.py, test_training.py), on the CPU:

  * TestPlan (the reference's, 8 cases) on the port's copy;
  * the same spec and seed give identical decision lists in both
    packages, and a ``state=`` file written by one is read by the other;
  * the engine's admit, kv_alloc (503 + Retry-After), spec_verify (a
    full-rejection wave, exact output) and wedge (record before the
    stall) points, on the reference's tiny fixture (vocab 64, d 32, H 2,
    D 16, L 2, d_ff 64, max_seq_len 64, f32);
  * serving.predict on :predict and :generate, and /metrics;
  * checkpoint.save corruption and checkpoint.restore, then the crash
    story of tests/test_chaos.py (runner.crash on a corrupted save, the
    restart resumes from the older step) in two runner processes.

Tolerances: none; decisions, tokens and step numbers are held equal.
Every wait is bounded (result and join timeouts of at most 60 s)."""

import json
import os
import re
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from kubeflow_tpu import chaos as ref_chaos  # noqa: E402
from kubeflow_tpu.models import transformer as ref  # noqa: E402
from kubeflow_tpu_torch import chaos  # noqa: E402
from kubeflow_tpu_torch.models import transformer as port  # noqa: E402
from kubeflow_tpu_torch.obs.metrics import default_registry  # noqa: E402
from kubeflow_tpu_torch.serving import lm_server  # noqa: E402
from kubeflow_tpu_torch.serving import server as port_server  # noqa: E402
from kubeflow_tpu_torch.serving.engine import (  # noqa: E402
    DecodeEngine, EngineOverloaded, PageAllocError)

from test_torch_generate import TINY  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 60


@pytest.fixture(autouse=True)
def _clean_chaos():
    chaos.reset()
    ref_chaos.reset()
    yield
    chaos.reset()
    ref_chaos.reset()


@pytest.fixture(scope="module")
def tiny_lm():
    """(port config, the reference's param tree as numpy)."""
    cfg_r = ref.TransformerConfig(**TINY, dtype=jnp.float32)
    params = ref.TransformerLM(cfg_r).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    return port.TransformerConfig(**TINY, dtype="float32"), params


def _engine(tiny_lm, **kw):
    cfg, params = tiny_lm
    kw.setdefault("n_slots", 4)
    kw.setdefault("chunk_tokens", 4)
    kw.setdefault("kv_page_size", 16)
    return DecodeEngine(cfg, params, device="cpu", **kw)


@pytest.fixture(scope="module")
def engine(tiny_lm):
    eng = _engine(tiny_lm, name="lm")
    yield eng
    eng.close()


# -- the plan: the reference's TestPlan on the port's copy -------------------

class TestPlan:
    def test_spec_grammar(self):
        plan = chaos.parse_spec(
            "seed=42;state=/tmp/x.json;"
            "store.read:p=0.25,count=3,after=2,delay=0.1,mode=delay;"
            "gang.kill;serving.request:match=127.0.0.1:9")
        assert plan.seed == 42
        assert plan.state_path == "/tmp/x.json"
        r = plan.rules["store.read"]
        assert (r.p, r.count, r.after, r.delay, r.mode) == \
            (0.25, 3, 2, 0.1, "delay")
        assert plan.rules["gang.kill"].p == 1.0
        assert plan.rules["serving.request"].match == "127.0.0.1:9"

    def test_spec_rejects_typos(self):
        with pytest.raises(ValueError):
            chaos.parse_spec("store.read:probability=0.5")
        with pytest.raises(ValueError):
            chaos.parse_spec("sed=42")
        with pytest.raises(ValueError):
            chaos.parse_spec("checkpoint.sav:mode=corrupt")

    def test_same_seed_same_decisions(self):
        mk = lambda: chaos.parse_spec("seed=9;store.read:p=0.4")  # noqa
        p1, p2 = mk(), mk()
        seq1 = [bool(p1.draw("store.read")) for _ in range(32)]
        seq2 = [bool(p2.draw("store.read")) for _ in range(32)]
        assert seq1 == seq2
        assert any(seq1) and not all(seq1)

    def test_per_point_streams_are_independent(self):
        p1 = chaos.parse_spec("seed=5;store.read:p=0.5;store.write:p=0.5")
        seq1 = []
        for _ in range(16):
            seq1.append(bool(p1.draw("store.read")))
            p1.draw("store.write")
        p2 = chaos.parse_spec("seed=5;store.read:p=0.5;store.write:p=0.5")
        seq2 = [bool(p2.draw("store.read")) for _ in range(16)]
        assert seq1 == seq2

    def test_after_and_count(self):
        plan = chaos.parse_spec("runner.crash:after=2,count=2")
        got = [bool(plan.draw("runner.crash")) for _ in range(6)]
        assert got == [False, False, True, True, False, False]

    def test_match_does_not_consume_draws(self):
        plan = chaos.parse_spec("gang.spawn:count=1,match=bad")
        assert plan.draw("gang.spawn", target="good-0") is None
        assert plan.draw("gang.spawn", target="bad-1") is not None
        assert plan.injected_counts() == {"gang.spawn": 1}

    def test_state_file_shares_budget(self, tmp_path):
        spec = f"seed=3;state={tmp_path}/s.json;runner.crash:count=2"
        p1 = chaos.parse_spec(spec)
        assert [bool(p1.draw("runner.crash")) for _ in range(3)] == \
            [True, True, False]
        p2 = chaos.parse_spec(spec)
        assert [bool(p2.draw("runner.crash")) for _ in range(3)] == \
            [False] * 3
        assert p2.injected_counts() == {"runner.crash": 2}

    def test_env_spec_activates_and_counts(self, monkeypatch):
        monkeypatch.setenv("KFX_CHAOS", "rendezvous.delay:count=1,delay=0")
        assert chaos.draw("rendezvous.delay") is not None
        assert chaos.draw("rendezvous.delay") is None
        assert chaos.injected_counts() == {"rendezvous.delay": 1}
        counter = default_registry().counter("kfx_chaos_injected_total")
        assert sum(v for lab, v in counter.samples()
                   if lab == {"point": "rendezvous.delay"}) >= 1


# -- the port against the reference ------------------------------------------

CROSS_SPEC = ("seed=11;engine.admit:p=0.3;checkpoint.save:p=0.5,after=3;"
              "serving.predict:p=0.7,count=9")
CROSS_POINTS = ("engine.admit", "checkpoint.save", "serving.predict")


def test_decisions_match_reference():
    """One spec and one seed, drawn 64 times at three points in turns:
    the same decision list in both packages."""
    want, got = [], []
    for mod, out in ((ref_chaos, want), (chaos, got)):
        plan = mod.parse_spec(CROSS_SPEC)
        for _ in range(64):
            out.append(tuple(bool(plan.draw(p)) for p in CROSS_POINTS))
    assert got == want
    assert 0 < sum(map(sum, got)) < 64 * 3


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_state_file_is_shared_with_reference(tmp_path, writer):
    """A state file one package wrote is read by the other: the budget is
    shared and the streams fast-forward to where the writer stopped."""
    spec = (f"seed=4;state={tmp_path}/s.json;"
            "runner.crash:p=0.5,count=6;engine.wedge:count=1")
    first, second = (ref_chaos, chaos) if writer == "reference" \
        else (chaos, ref_chaos)
    p1 = first.parse_spec(spec)
    head = [bool(p1.draw("runner.crash")) for _ in range(7)]
    assert p1.draw("engine.wedge") is not None
    p2 = second.parse_spec(spec)
    tail = [bool(p2.draw("runner.crash")) for _ in range(9)]
    assert p2.draw("engine.wedge") is None     # the budget of 1 is spent
    one = first.parse_spec(spec.replace(f"state={tmp_path}/s.json;", ""))
    assert head + tail == [bool(one.draw("runner.crash"))
                           for _ in range(16)]
    assert p2.injected_counts() == p1.injected_counts()


def test_startup_delay_injected(monkeypatch):
    """rendezvous.delay (the reference's TestRendezvousDelay): every start
    of the matching replica sleeps, another replica does not."""
    from kubeflow_tpu_torch.runtime.rendezvous import apply_startup_chaos

    monkeypatch.setenv("KFX_REPLICA_TYPE", "Worker")
    monkeypatch.setenv("KFX_REPLICA_INDEX", "1")
    chaos.install(chaos.parse_spec(
        "rendezvous.delay:delay=0.05,match=worker-1"))
    assert apply_startup_chaos() >= 0.05
    assert apply_startup_chaos() >= 0.05
    monkeypatch.setenv("KFX_REPLICA_INDEX", "0")
    assert apply_startup_chaos() == 0.0


# -- the engine's points ------------------------------------------------------

def test_chaos_engine_admit(engine):
    chaos.install(chaos.parse_spec("engine.admit:count=1"))
    req = engine.submit([1, 2, 3], max_new_tokens=4)
    with pytest.raises(RuntimeError, match=r"chaos\[engine.admit\]"):
        req.result(WAIT_S)
    assert chaos.injected_counts().get("engine.admit") == 1
    assert len(engine.generate([[1, 2, 3]], max_new_tokens=4)[0]) == 4


def test_chaos_kv_alloc_degrades_to_503_contract(tiny_lm):
    """A forced allocation failure on an idle engine fails the request
    with PageAllocError, an EngineOverloaded (503 + Retry-After), never a
    crashed loop; the next request serves."""
    eng = _engine(tiny_lm, n_slots=2, name="lm-alloc")
    try:
        chaos.install(chaos.parse_spec("engine.kv_alloc:count=1"))
        req = eng.submit([1, 2, 3], max_new_tokens=4)
        with pytest.raises(PageAllocError, match="chaos"):
            req.result(WAIT_S)
        assert issubclass(PageAllocError, EngineOverloaded)
        assert chaos.injected_counts().get("engine.kv_alloc") == 1
        chaos.reset()
        assert len(eng.generate([[1, 2, 3]], max_new_tokens=4)[0]) == 4
        assert eng._mgr.n_free + len(eng._prefix) == eng.n_pages
    finally:
        eng.close()


def test_chaos_spec_verify_full_rejection(tiny_lm):
    """Full-rejection waves: accepted counter frozen, output identical to
    the uninjected run, no page leaks from either pool; when the budget
    drains the engine speculates again."""
    eng = _engine(tiny_lm, name="lm-sp", kv_pages=8, prefix_cache=False,
                  draft_layers=1, propose_tokens=4)
    try:
        prompt = [[5, 9, 11, 3, 7]]
        ref_out = eng.generate(prompt, max_new_tokens=12)
        acc0 = eng.spec_stats()["accepted"]
        chaos.install(chaos.parse_spec("engine.spec_verify:count=100"))
        assert eng.generate(prompt, max_new_tokens=12) == ref_out
        assert chaos.injected_counts().get("engine.spec_verify", 0) >= 1
        assert eng.spec_stats()["accepted"] == acc0
        chaos.reset()
        assert eng._mgr.n_free == eng.n_pages
        assert eng._draft_mgr.n_free == eng.draft_n_pages
        st0 = eng.spec_stats()
        assert eng.generate(prompt, max_new_tokens=12) == ref_out
        assert eng.spec_stats()["proposed"] > st0["proposed"]
    finally:
        eng.close()


def test_wedge_records_before_stall_and_drain_wins(engine):
    """engine.wedge (tests/test_flightrec.py's wedge case; the port has no
    compile to suppress the verdict, so the heartbeat reads wedged): the
    ring holds the stalled iteration with ``it`` equal to the frozen
    counter and does not advance during the stall; a drain issued
    mid-stall finishes the request, which the recorder retires with the
    stall in its prefill leg."""
    retired_before = len(engine.flight.requests()["requests"])
    threshold = engine.stall_threshold_s
    engine.stall_threshold_s = 0.5
    chaos.install(chaos.parse_spec("engine.wedge:count=1,delay=1.5"))
    try:
        req = engine.submit([(i % 40) + 3 for i in range(40)],
                            max_new_tokens=4)
        seen, deadline = None, time.monotonic() + 10
        while time.monotonic() < deadline:
            hb = engine.heartbeat()
            if hb["busy"] and hb["stalled_s"] > 0.6:
                seen = hb
                break
            time.sleep(0.02)
        assert seen is not None and seen["wedged"] is True
        n1 = len(engine.flight)
        rec1 = engine.flight.snapshot()["records"][-1]
        assert rec1["active"] or rec1["prefilling"]
        assert rec1["it"] == engine.heartbeat()["iterations"]
        time.sleep(0.3)
        assert len(engine.flight) == n1, "ring advanced during the stall"
        assert engine.drain(wait_s=30) is True
        assert len(req.result(WAIT_S)) == 4
        assert chaos.injected_counts().get("engine.wedge") == 1
    finally:
        engine.stall_threshold_s = threshold
        engine._draining = False   # the module's engine serves on
    last = engine.flight.requests()["requests"][-1]
    assert len(engine.flight.requests()["requests"]) > retired_before
    assert [e["ev"] for e in last["events"]][-1] == "retire"
    assert last["timing"]["prefill_s"] > 1.0
    assert engine.heartbeat()["wedged"] is False


# -- the server's point and /metrics ------------------------------------------

def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=WAIT_S) as r:
            return r.status, json.loads(r.read()), r.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


@pytest.fixture()
def served_lm(tiny_lm, tmp_path, monkeypatch):
    cfg, params = tiny_lm
    d = str(tmp_path / "lm")
    lm_server.export_lm(d, cfg, params)
    monkeypatch.setenv("KFX_LM_SPEC", "0")
    p = lm_server.LMPredictor(d, name="lm", device="cpu", warm_buckets=[8])
    p.load()
    srv = port_server.ModelServer(port=0)
    srv.register(p)
    srv.start()
    yield srv, p
    srv.stop()
    p.close()


def test_serving_predict_and_kv_alloc_over_http(served_lm):
    """serving.predict answers one 500 with the reference's message, then
    serves; engine.kv_alloc answers 503 + Retry-After, then serves; the
    injections show on the server's /metrics."""
    srv, _ = served_lm
    url = f"http://127.0.0.1:{srv.port}/v1/models/lm:generate"
    body = {"prompt_tokens": [[5, 9, 11]], "max_new_tokens": 4}
    chaos.install(chaos.parse_spec(
        "serving.predict:count=1;engine.kv_alloc:count=1"))
    code, out, _ = _post(url, body)
    assert (code, out) == (500, {"error": "chaos[serving.predict]: lm"})
    code, out, headers = _post(url, body)
    assert code == 503 and "chaos[engine.kv_alloc]" in out["error"]
    assert headers["Retry-After"] == "1"
    code, out, _ = _post(url, body)
    assert code == 200 and len(out["generated_tokens"][0]) == 4
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics",
                                timeout=WAIT_S) as r:
        text = r.read().decode()
    for point in ("serving.predict", "engine.kv_alloc"):
        assert f'kfx_chaos_injected_total{{point="{point}"}} 1' in text


def test_serving_predict_on_classifier(tmp_path):
    """:predict (the reference's site): one 500, then served."""
    from kubeflow_tpu_torch.models import get_model
    from kubeflow_tpu_torch.serving.export import export_params
    from kubeflow_tpu_torch.training import TrainLoop

    loop = TrainLoop(get_model("mlp", num_classes=10,
                               input_shape=(28, 28, 1)), device="cpu")
    state = loop.init_state((28, 28, 1))
    d = export_params(str(tmp_path / "cls"), "mlp", (28, 28, 1), 10, state)
    pred = port_server.JaxPredictor(d, name="mlp", device="cpu")
    pred.load()
    srv = port_server.ModelServer(port=0)
    srv.register(pred)
    srv.start()
    try:
        url = f"http://127.0.0.1:{srv.port}/v1/models/mlp:predict"
        body = {"instances": np.zeros((1, 28, 28, 1)).tolist()}
        chaos.install(chaos.parse_spec("serving.predict:count=1"))
        code, out, _ = _post(url, body)
        assert (code, out) == (500, {"error": "chaos[serving.predict]: mlp"})
        code, out, _ = _post(url, body)
        assert code == 200 and len(out["predictions"]) == 1
    finally:
        srv.stop()


# -- the checkpointer and the runner ------------------------------------------

def _mlp_state():
    from kubeflow_tpu_torch.models import get_model
    from kubeflow_tpu_torch.training import TrainLoop

    loop = TrainLoop(get_model("mlp", num_classes=10,
                               input_shape=(28, 28, 1)), device="cpu")
    return loop, loop.init_state((28, 28, 1))


def test_chaos_save_corruption_point(tmp_path, capfd):
    """checkpoint.save corrupts the committed save in place (the
    reference's test_chaos_save_corruption_point); restore quarantines
    it and falls back to the older step."""
    from kubeflow_tpu_torch.training import Checkpointer

    loop, state = _mlp_state()
    chaos.install(chaos.parse_spec(
        "checkpoint.save:mode=corrupt,after=1,count=1"))
    ckpt = Checkpointer(str(tmp_path / "ck"), save_every=1, keep=2)
    ckpt.maybe_save(1, state, force=True)   # draw 0: skipped
    ckpt.maybe_save(2, state, force=True)   # draw 1: corrupted
    ckpt.wait()
    assert "chaos_corrupt_checkpoint step=2 files=1" in \
        capfd.readouterr().out
    restored = ckpt.restore_latest(loop.init_state((28, 28, 1)))
    assert restored is not None and restored.step == state.step
    assert (tmp_path / "ck" / "quarantine-2").is_dir()
    assert ckpt.all_steps() == [1]
    ckpt.close()


def test_chaos_restore_point(tmp_path):
    from kubeflow_tpu_torch.training import Checkpointer

    loop, state = _mlp_state()
    ckpt = Checkpointer(str(tmp_path / "ck"), save_every=1,
                        async_save=False)
    ckpt.maybe_save(1, state, force=True)
    chaos.install(chaos.parse_spec("checkpoint.restore:count=1"))
    with pytest.raises(OSError, match=r"chaos\[checkpoint.restore\]"):
        ckpt.restore_latest(loop.init_state((28, 28, 1)))
    assert ckpt.restore_latest(loop.init_state((28, 28, 1))) is not None


def test_runner_crash_resumes_from_older_step(tmp_path):
    """The deterministic crash story of tests/test_chaos.py without the
    control plane: save 20 corrupted, crash at 20 (exit 137); the rerun
    quarantines 20 and resumes from 10, never step 0."""
    spec = (f"seed=7;state={tmp_path}/chaos.json;"
            "runner.crash:after=1,count=1;"
            "checkpoint.save:mode=corrupt,after=1,count=1")
    env = {k: v for k, v in os.environ.items() if k != "KFX_CHAOS"}
    env.update(PYTHONPATH=REPO, KFX_CHAOS=spec,
               KFX_CHECKPOINT_DIR=str(tmp_path / "ck"))
    cmd = [sys.executable, "-m", "kubeflow_tpu_torch.runners.jax_runner",
           "--model=mlp", "--dataset=mnist", "--steps=40",
           "--batch-size=64", "--log-every=10", "--checkpoint-every=10",
           "--keep-checkpoints=2", "--eval-samples=256", "--device=cpu"]
    first = subprocess.run(cmd, env=env, capture_output=True, text=True,
                           timeout=120, cwd=str(tmp_path))
    assert first.returncode == 137, first.stderr[-2000:]
    assert "chaos_corrupt_checkpoint step=20" in first.stdout
    assert "chaos_crash step=20" in first.stdout
    second = subprocess.run(cmd, env=env, capture_output=True, text=True,
                            timeout=120, cwd=str(tmp_path))
    assert second.returncode == 0, second.stderr[-2000:]
    for line in ("checkpoint_quarantined step=20",
                 "resumed_from_checkpoint step=10", "train_done steps=40"):
        assert line in second.stdout, second.stdout
    assert not re.search(r"resumed_from_checkpoint step=0\b", second.stdout)
