"""Speculative decoding and usage metering in the port's DecodeEngine
(kubeflow_tpu_torch/serving/engine.py, serving/metering.py,
models/transformer.py ``truncate_layers``) against the reference's
(kubeflow_tpu/serving/engine.py with ``draft_layers > 0``,
serving/metering.py), on the reference's tiny fixture (vocab 64, d 32,
H 2, D 16, L 2, d_ff 64, max_seq_len 64, f32) with a 1-layer draft and
k = 4 proposals, on the CPU:

  * the draft shares the target's modules, and its logits equal the
    reference's truncated model (1e-4); a [B, k+1] verify window through
    the paged pool equals flax's paged branch (1e-4);
  * greedy tokens with speculation equal those without it, the port's
    LMGenerator and the JAX engine with the same draft, with equal accept
    counts, on wide-gap weights with the target's and the draft's
    top-1/top-2 gaps asserted first;
  * the reference's TestSpeculative contracts (stop mid-window, the
    max_seq_len boundary and its write cap, recycling, preemption,
    draft-pool exhaustion degrading, the verify span and metrics; not its
    chaos case, ROADMAP.md Queue A 5b.4) and TestSpeculativeDistribution
    (spec against plain marginals, by total variation), plus chi-squares
    of the first sampled token and of the next one, which the accept rule
    decides;
  * sampled output deterministic per seed beside batch mates and across
    preemption; no page of either pool leaks;
  * the reference's TestTenantLedger units and billing exactness, and the
    ``kfx_tenant_*`` text of /metrics equal to the reference server's;
  * the served defaults: speculation on with an ``n_layers // 4`` draft
    (``spec=on``), ``KFX_LM_SPEC=0`` off (``spec=off``)."""

import json
import os
import subprocess
import sys
import urllib.request

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from kubeflow_tpu.models import transformer as ref  # noqa: E402
from kubeflow_tpu.obs.metrics import MetricsRegistry as RefRegistry  # noqa: E402,E501
from kubeflow_tpu.serving import engine as ref_engine  # noqa: E402
from kubeflow_tpu.serving import lm_server as ref_lm  # noqa: E402
from kubeflow_tpu.serving import metering as ref_metering  # noqa: E402
from kubeflow_tpu.serving import server as ref_server  # noqa: E402
from kubeflow_tpu_torch.models import transformer as port  # noqa: E402
from kubeflow_tpu_torch.models.convert import params_from_jax  # noqa: E402
from kubeflow_tpu_torch.models.generate import LMGenerator  # noqa: E402
from kubeflow_tpu_torch.obs import trace as port_trace  # noqa: E402
from kubeflow_tpu_torch.obs.metrics import MetricsRegistry  # noqa: E402
from kubeflow_tpu_torch.serving import lm_server  # noqa: E402
from kubeflow_tpu_torch.serving import server as port_server  # noqa: E402
from kubeflow_tpu_torch.serving.engine import DecodeEngine  # noqa: E402
from kubeflow_tpu_torch.serving.metering import TenantLedger  # noqa: E402

from test_torch_generate import (  # noqa: E402
    CHI2_1E4, MIN_GAP, TINY, recompute, wide_gap)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_LOGITS = 1e-4   # f32 logits, port vs flax, max-abs
TV_BOUND = 0.25     # the reference's bound: spec vs plain marginals
K = 4               # proposals a verify window
MIXED = [[5, 9, 11, 3, 7], [2], [1, 2, 3, 4, 5, 6, 7, 8, 9], [13, 14]]


def _raw_params():
    cfg_r = ref.TransformerConfig(**TINY, dtype=jnp.float32)
    params = ref.TransformerLM(cfg_r).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return cfg_r, jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def gapped():
    """(reference config, port config, wide-gap reference param tree)."""
    cfg_r, params = _raw_params()
    return (cfg_r, port.TransformerConfig(**TINY, dtype="float32"),
            wide_gap(params))


def _port_model(cfg_p, params, n_layers=None):
    model = port.TransformerLM(cfg_p, device="cpu")
    model.load_state_dict(params_from_jax(params))
    return model if n_layers is None else port.truncate_layers(model,
                                                               n_layers)


@pytest.fixture(scope="module")
def oracle(gapped):
    """Greedy one-shot tokens of the port's LMGenerator, after asserting
    the target's argmax gaps on the path AND the draft's at every window
    a greedy run can open on it (k greedy draft steps from each prefix of
    the target's chain)."""
    _, cfg_p, params = gapped
    gen = LMGenerator(cfg_p, params, device="cpu")
    draft = _port_model(cfg_p, params, n_layers=1).eval()
    seen = {}

    def want(prompt, n):
        key = (tuple(prompt), n)
        if key not in seen:
            assert recompute(cfg_p, params, prompt, n)[1] > MIN_GAP
            out = gen.generate([prompt], max_new_tokens=n)[0]
            chain = list(prompt) + out
            with torch.no_grad():
                for j in range(len(prompt) + 1, len(chain) + 1):
                    toks = chain[:j]
                    for _ in range(K):
                        last = draft(torch.tensor([toks]))[0, -1]
                        top2 = torch.topk(last, 2).values
                        assert float(top2[0] - top2[1]) > MIN_GAP, (key, j)
                        toks = toks + [int(torch.argmax(last))]
            seen[key] = out
        return seen[key]
    return want


def _engine(gapped, **kw):
    _, cfg_p, params = gapped
    kw.setdefault("n_slots", 4)
    kw.setdefault("chunk_tokens", 4)
    kw.setdefault("kv_page_size", 16)
    kw.setdefault("draft_layers", 1)
    kw.setdefault("propose_tokens", K)
    return DecodeEngine(cfg_p, params, device="cpu", **kw)


@pytest.fixture(scope="module")
def spec_engine(gapped):
    eng = _engine(gapped, name="lm-spec")
    yield eng
    eng.close()


@pytest.fixture(scope="module")
def plain_engine(gapped):
    eng = _engine(gapped, name="lm-plain", draft_layers=0)
    yield eng
    eng.close()


@pytest.fixture(scope="module")
def spec_pool_engine(gapped):
    """8 pages (two dense rows), prefix cache off: recycling, preemption
    and leaks are observable against exact pool totals."""
    eng = _engine(gapped, name="lm-sp", kv_pages=8, prefix_cache=False)
    yield eng
    eng.close()


@pytest.fixture(scope="module")
def jax_spec(gapped):
    cfg_r, _, params = gapped
    eng = ref_engine.DecodeEngine(cfg_r, params, n_slots=4, chunk_tokens=4,
                                  name="ref-spec", kv_page_size=16,
                                  draft_layers=1, propose_tokens=K)
    yield eng
    eng.close()


def _no_leak(eng):
    """Both pools whole once nothing is in flight (cached prefix pages
    count as held by the cache, not leaked)."""
    st = eng.page_stats()
    assert st["free"] + st["cached"] == st["pages"], st
    if eng.spec:
        assert eng._draft_mgr.n_free == eng.draft_n_pages


@pytest.fixture(autouse=True)
def _pools_whole(request):
    """After every test, each shared engine it used has both pools whole."""
    yield
    for name in ("spec_engine", "plain_engine", "spec_pool_engine"):
        if name in request.fixturenames:
            _no_leak(request.getfixturevalue(name))


def _value(metric, **labels):
    """One sample of a counter or gauge (either package's registry)."""
    return sum(v for lab, v in metric.samples()
               if all(lab.get(k) == w for k, w in labels.items()))


def _counter(reg, name, model):
    return _value(reg.counter(name), model=model)


# -- the draft model and the verify window ---------------------------------

def test_truncate_layers_shares_modules_and_matches_reference(gapped):
    cfg_r, cfg_p, params = gapped
    target = _port_model(cfg_p, params)
    draft = port.truncate_layers(target, 1, kv_pages=3)
    assert draft.cfg.n_layers == 1 and draft.cfg.kv_pages == 3
    assert draft.layers[0] is target.layers[0]
    assert draft.embed is target.embed and draft.lm_head is target.lm_head
    assert draft.ln_f is target.ln_f
    assert {id(p) for p in draft.parameters()} <= \
        {id(p) for p in target.parameters()}
    for n in (0, 3):
        with pytest.raises(ValueError, match=r"not in \[1, 2\]"):
            port.truncate_layers(target, n)
        with pytest.raises(ValueError, match=r"not in \[1, 2\]"):
            ref.truncate_layers(params, n)
    toks = np.array([[5, 9, 11, 3, 7, 1, 2, 60]], np.int32)
    cfg_d = ref.TransformerConfig(**dict(TINY, n_layers=1),
                                  dtype=jnp.float32)
    want = ref.TransformerLM(cfg_d).apply(
        {"params": ref.truncate_layers(params, 1)}, jnp.asarray(toks))
    with torch.no_grad():
        got = draft(torch.from_numpy(toks).long()).numpy()
    assert float(np.abs(np.asarray(want) - got).max()) < TOL_LOGITS


def test_paged_verify_window_matches_flax(gapped):
    """Prefill into a paged pool, then ONE [3, k+1] window per row at
    positions pos..pos+k written at loc..loc+k (a pad gap between the
    prompt and the window; one row capped, its tail at position -1): the
    position-causal mask makes the window's self-attention exact, so the
    port's logits and pool equal flax's paged branch."""
    _, _, params = gapped
    paged = dict(TINY, decode=True, kv_page_size=16, kv_pages=8)
    cfg_r = ref.TransformerConfig(**paged, dtype=jnp.float32)
    cfg_p = port.TransformerConfig(**paged, dtype="float32", attn_impl="xla")
    model_r = ref.TransformerLM(cfg_r)
    model_p = port.TransformerLM(cfg_p, device="meta")
    model_p.load_state_dict({k: torch.as_tensor(v) for k, v in
                             params_from_jax(params).items()}, assign=True)
    prompts = [[5, 9, 11, 3, 7], [2, 30, 8], [(3 * i + 2) % 60
                                              for i in range(20)]]
    pad = 32
    tables = np.array([[0, 1, 6, -1], [2, 7, -1, -1], [3, 4, 5, -1]],
                      np.int32)
    toks = np.zeros((3, pad), np.int32)
    pos = np.full((3, pad), -1, np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
        pos[i, :len(p)] = np.arange(len(p))
    apply = jax.jit(lambda v, t, p, w: model_r.apply(
        v, t, positions=p, block_tables=jnp.asarray(tables),
        write_locations=w, mutable=["cache"]))
    _, vs = apply({"params": params}, jnp.asarray(toks), jnp.asarray(pos),
                  jnp.asarray(pos))
    cache = port.PagedKVCache.allocate(cfg_p)
    tt = torch.from_numpy(tables)
    with torch.no_grad():
        model_p(torch.from_numpy(toks).long(), torch.from_numpy(pos),
                cache, tt)
    true_len = np.array([len(p) for p in prompts])
    steps = np.arange(K + 1)
    win = np.random.default_rng(0).integers(0, 64, (3, K + 1)).astype(
        np.int32)
    wpos = (true_len[:, None] + steps).astype(np.int32)
    wloc = (pad + steps[None, :].repeat(3, 0)).astype(np.int32)
    capped = wloc[1] > pad + 2        # row 1's budget ends at loc pad+2
    wpos[1, capped], wloc[1, capped] = -1, -1
    lr, vs = apply({"params": params, **vs}, jnp.asarray(win),
                   jnp.asarray(wpos), jnp.asarray(wloc))
    with torch.no_grad():
        lp = model_p(torch.from_numpy(win).long(), torch.from_numpy(wpos),
                     cache, tt, torch.from_numpy(wloc))
    ok = wpos >= 0
    err = float(np.abs(np.asarray(lr) - lp.numpy())[ok].max())
    assert err < TOL_LOGITS, err
    np.testing.assert_array_equal(
        cache.pos.numpy()[:, :8],
        np.asarray(vs["cache"]["layers"]["attn"]["cached_pos"]))


# -- greedy: the byte-identity contracts -------------------------------------

class TestSpecGreedy:
    def test_greedy_equals_plain_oracle_and_jax_spec_engine(
            self, spec_engine, plain_engine, jax_spec, oracle):
        """Speculation changes nothing a greedy client sees: the spec
        engine's tokens equal the plain engine's, the LMGenerator's and
        the JAX engine's with the same 1-layer draft, and both engines
        accept exactly the same proposals."""
        want = [oracle(p, 12) for p in MIXED]
        st0, jt0 = spec_engine.spec_stats(), jax_spec.spec_stats()
        got = spec_engine.generate(MIXED, max_new_tokens=12)
        assert got == want
        assert plain_engine.generate(MIXED, max_new_tokens=12) == want
        assert jax_spec.generate(MIXED, max_new_tokens=12) == want
        st1, jt1 = spec_engine.spec_stats(), jax_spec.spec_stats()
        delta = {k: st1[k] - st0[k] for k in st1}
        assert delta == {k: jt1[k] - jt0[k] for k in jt1}
        assert 0 < delta["accepted"] < delta["proposed"]

    def test_greedy_parity_and_stop(self, spec_engine, jax_spec, oracle):
        """The stop token may land mid-window: the emitted tokens still
        end exactly before it, as the JAX spec engine's do."""
        ref0 = oracle(MIXED[0], 12)
        cut = next(j for j in range(2, len(ref0)) if ref0[j] not in ref0[:j])
        out = spec_engine.generate([MIXED[0]], max_new_tokens=12,
                                   stop_token=ref0[cut])[0]
        assert out == ref0[:cut]
        assert jax_spec.generate([MIXED[0]], max_new_tokens=12,
                                 stop_token=ref0[cut])[0] == out
        assert spec_engine._active_count() == 0

    def test_parity_at_cache_capacity_boundary(self, spec_engine, jax_spec,
                                               oracle):
        """Budget to max_seq_len exactly: the last windows run past the
        last cache location (the max_loc write cap's regime)."""
        prompt = [5, 9, 11, 3, 7]   # bucket 8 + 56 new = L exactly
        out = spec_engine.generate([prompt], max_new_tokens=56)
        assert out == [oracle(prompt, 56)]
        assert jax_spec.generate([prompt], max_new_tokens=56) == out

    def test_boundary_write_cap_protects_last_page(self, gapped):
        """One iteration driven by hand with a window crossing max_seq_len
        (loc 61, k 4: locations up to 65 > L - 1): every cached entry of
        the request's last page survives in both pools."""
        eng = _engine(gapped, name="lm-cap")
        eng.close()                  # the loop is stopped; drive by hand

        def seed_pos(cache):
            cache.pos.fill_(-1)
            for loc in range(5):     # the prompt, then the decode history
                cache.pos[:, loc // 16, loc % 16] = loc
            for loc in range(8, 61):
                cache.pos[:, loc // 16, loc % 16] = loc - 3

        with torch.inference_mode():
            seed_pos(eng._cache)
            seed_pos(eng._draft_cache)
            eng._tables[0] = eng._draft_tables[0] = np.arange(4)
            eng._pending[0], eng._pos[0], eng._loc[0] = 7, 58, 61
            eng._max_loc[0] = 63
            eng._active[0] = eng._spec_ok[0] = True
            on = eng._active.copy()
            eng._spec_launch(np.zeros_like(on), on)
        for cache in (eng._cache, eng._draft_cache):
            got = cache.pos.numpy()
            # Locations 48, 49 (page 3, slots 0-1) hold positions 45, 46.
            assert (got[:, 3, 0] == 45).all() and (got[:, 3, 1] == 46).all()
            assert (got[:, 0, :5] == np.arange(5)).all()

    def test_parity_under_recycle_and_preemption(self, spec_pool_engine,
                                                 oracle):
        """Every page of both pools recycles across waves without stale
        KV, and target-pool exhaustion preempts (freeing both pools) with
        completions unchanged."""
        eng = spec_pool_engine
        prompts = [[i + 1, i + 2] for i in range(4)]
        assert eng.generate(prompts, max_new_tokens=8) == \
            [oracle(p, 8) for p in prompts]
        prompts = [[i + 1, i + 2, i + 3] for i in range(4)]
        assert eng.generate(prompts, max_new_tokens=40) == \
            [oracle(p, 40) for p in prompts]
        assert eng.page_stats()["preemptions"] >= 1

    def test_chunked_prefill_and_prefix_hit(self, gapped, oracle):
        """The draft prefills the FULL prompt after the last chunk of a
        chunked prefill, and after a prefix-cache hit."""
        eng = _engine(gapped, name="lm-spec-ck", prefill_chunk_tokens=16)
        try:
            long_a = [(7 * i + 3) % 60 for i in range(40)]
            assert eng.generate([long_a, [2, 4]], max_new_tokens=10) == \
                [oracle(long_a, 10), oracle([2, 4], 10)]
            hits = eng.prefix_stats()["hits"]
            assert eng.generate([long_a], max_new_tokens=10) == \
                [oracle(long_a, 10)]
            assert eng.prefix_stats()["hits"] > hits
            assert eng.spec_stats()["degraded"] == 0
            _no_leak(eng)
        finally:
            eng.close()

    def test_draft_pool_exhaustion_degrades_not_fails(self, gapped, oracle):
        """A draft pool too small for the prompt degrades THAT slot (the
        target pool admitted it) with output unchanged; a short prompt
        still speculates."""
        eng = _engine(gapped, n_slots=2, name="lm-dx", draft_kv_pages=1)
        try:
            long_p = [(3 * i + 1) % 60 for i in range(20)]
            assert eng.generate([long_p], max_new_tokens=8) == \
                [oracle(long_p, 8)]
            assert eng.spec_stats()["degraded"] >= 1
            st0 = eng.spec_stats()["proposed"]
            assert eng.generate([[5, 9, 11]], max_new_tokens=8) == \
                [oracle([5, 9, 11], 8)]
            assert eng.spec_stats()["proposed"] > st0
            _no_leak(eng)
        finally:
            eng.close()

    def test_failed_draft_dispatch_fails_inflight(self, gapped, oracle,
                                                  monkeypatch):
        """Only a page shortfall degrades: a failed draft dispatch fails
        the in-flight requests (the reference degrades the slot instead,
        which would hide a device fault), and the engine serves on."""
        eng = _engine(gapped, name="lm-df")
        real = DecodeEngine._prefill

        def broken(self_, tokens, start, table, draft=False, **kw):
            if draft:
                raise RuntimeError("draft dispatch failed")
            return real(self_, tokens, start, table, draft, **kw)

        try:
            monkeypatch.setattr(DecodeEngine, "_prefill", broken)
            req = eng.submit([5, 9, 11], max_new_tokens=8)
            with pytest.raises(RuntimeError, match="draft dispatch"):
                req.result(30)
            assert eng.spec_stats()["degraded"] == 0
            monkeypatch.setattr(DecodeEngine, "_prefill", real)
            assert eng.generate([[5, 9, 11]], max_new_tokens=8) == \
                [oracle([5, 9, 11], 8)]
            _no_leak(eng)
        finally:
            eng.close()

    def test_verify_span_and_metrics(self, spec_engine, monkeypatch):
        """engine.verify joins the submitting request's trace with its
        accepted count; the proposed/accepted counters, the accept-rate
        gauge and the verify-dispatch count are live."""
        recs = []
        monkeypatch.setattr(port_trace, "_emit",
                            lambda sp: recs.append(sp.to_record()))
        reg = spec_engine._reg()
        chunks0 = _counter(reg, "kfx_lm_engine_chunks_total", "lm-spec")
        with port_trace.span("client.generate",
                             trace_id="trace-spec-test") as root:
            spec_engine.generate([[5, 9, 11]], max_new_tokens=6)
        verify = [r for r in recs if r["name"] == "engine.verify"]
        assert verify and verify[0]["trace"] == "trace-spec-test"
        assert verify[0]["parent"] == root.span_id
        assert "accepted" in verify[0]["attrs"]
        assert _counter(reg, "kfx_lm_engine_chunks_total", "lm-spec") \
            - chunks0 == len(verify)
        proposed = _counter(reg, "kfx_lm_spec_proposed_total", "lm-spec")
        accepted = _counter(reg, "kfx_lm_spec_accepted_total", "lm-spec")
        assert proposed > 0 and 0 <= accepted <= proposed
        assert (proposed, accepted) == (
            spec_engine.spec_stats()["proposed"],
            spec_engine.spec_stats()["accepted"])
        rate = _value(reg.gauge("kfx_lm_spec_accept_rate"), model="lm-spec")
        assert 0.0 < rate <= 1.0

    def test_spec_families_only_with_a_draft(self, plain_engine):
        reg = plain_engine._reg()
        plain_engine._touch_gauges()
        for fam in ("kfx_lm_spec_proposed_total",
                    "kfx_lm_spec_accepted_total"):
            assert _counter(reg, fam, "lm-plain") == 0
        assert not [lab for lab, _ in reg.gauge(
            "kfx_lm_spec_accept_rate").samples()
            if lab.get("model") == "lm-plain"]
        assert plain_engine.spec_stats() == {
            "proposed": 0, "accepted": 0, "degraded": 0}


# -- sampling ------------------------------------------------------------------

def test_sampling_deterministic_per_seed_batch_mates_and_preemption(
        spec_engine, gapped):
    """A sampled request's tokens are a function of its seed: the same
    alone, beside other requests, and after preemption-by-recompute (its
    pending token re-opens the window, so the windows realign)."""
    kw = dict(max_new_tokens=12, temperature=1.0)
    alone = spec_engine.generate([[1, 2, 3]], seed=1, **kw)[0]
    assert alone == spec_engine.generate([[1, 2, 3]], seed=1, **kw)[0]
    assert alone != spec_engine.generate([[1, 2, 3]], seed=2, **kw)[0]
    mates = [spec_engine.submit([9, 8], max_new_tokens=20, temperature=0.7,
                                top_k=5, seed=7),
             spec_engine.submit([4], max_new_tokens=6)]
    r = spec_engine.submit([1, 2, 3], seed=1, **kw)
    assert r.result(60) == alone
    for m in mates:
        m.result(60)
    eng = _engine(gapped, kv_pages=5, prefix_cache=False, name="lm-seed")
    try:
        reqs = [eng.submit([i + 5, i + 6], max_new_tokens=40,
                           temperature=1.0, seed=i) for i in range(3)]
        reqs.append(eng.submit([1, 2, 3], seed=1, **kw))
        assert reqs[-1].result(60) == alone
        for r in reqs[:-1]:
            r.result(60)
        assert eng.page_stats()["preemptions"] >= 1
        assert sum(r.preempts for r in reqs) >= 1
        _no_leak(eng)
    finally:
        eng.close()


class TestSpeculativeDistribution:
    """Raw-init weights (sampling is statistical; no gap needed)."""

    @pytest.fixture(scope="class")
    def raw(self):
        _, params = _raw_params()
        return port.TransformerConfig(**TINY, dtype="float32"), params

    def _eng(self, raw, name, draft):
        cfg_p, params = raw
        return DecodeEngine(cfg_p, params, n_slots=32, chunk_tokens=4,
                            kv_page_size=16, name=name, max_queue=64,
                            draft_layers=draft, propose_tokens=K,
                            prefix_cache=False, device="cpu")

    def _draws(self, eng, prompt, n, **kw):
        out = []
        for s in range(0, n, 64):
            out += eng.generate([prompt] * 64, seed=10_000 + s, **kw)
        return np.array(out)

    def test_spec_marginals_match_plain_engine(self, raw):
        """The reference's check: empirical marginals of each emitted
        position over 640 seeds, spec against plain, within its TV bound
        (a broken accept rule measures >= 0.4)."""
        prompt, T = [5, 9, 11], 3
        tv = []
        engines = [self._eng(raw, "d-plain", 0), self._eng(raw, "d-spec", 1)]
        try:
            m = []
            for eng in engines:
                ids = self._draws(eng, prompt, 640, max_new_tokens=T,
                                  temperature=1.0)
                m.append(np.stack([np.bincount(ids[:, t], minlength=64)
                                   / len(ids) for t in range(T)]))
                _no_leak(eng)
            tv = [0.5 * np.abs(m[0][t] - m[1][t]).sum() for t in range(T)]
        finally:
            for eng in engines:
                eng.close()
        assert max(tv) < TV_BOUND, tv

    def test_first_and_verified_tokens_chi_square(self, raw):
        """1024 seeds at T 1, top_k 5: the first token (the pending draw)
        against softmax(prefill logits / T) under the top-k mask, and the
        next one (decided by the accept rule, given the commonest first
        token) against the target's conditional distribution; chi-square
        under its p = 1e-4 quantile, masked tokens never drawn."""
        cfg_p, params = raw
        prompt, T, top_k = [5, 9, 11], 1.0, 5
        eng = self._eng(raw, "d-chi", 1)
        try:
            ids = self._draws(eng, prompt, 1024, max_new_tokens=2,
                              temperature=T, top_k=top_k)
            assert eng.spec_stats()["proposed"] > 0
            _no_leak(eng)
        finally:
            eng.close()
        model = _port_model(cfg_p, params).eval()

        def check(context, drawn):
            with torch.no_grad():
                logits = model(torch.tensor([context]))[0, -1] / T
            kth = torch.sort(logits).values[64 - top_k]
            p = torch.softmax(logits.masked_fill(logits < kth,
                                                 float("-inf")), -1).numpy()
            counts = np.bincount(drawn, minlength=64)
            assert counts[p == 0].sum() == 0
            keep = p > 0
            expect = p[keep] * len(drawn)
            chi2 = float(((counts[keep] - expect) ** 2 / expect).sum())
            assert chi2 < CHI2_1E4[int(keep.sum()) - 1], (counts, expect)

        check(prompt, ids[:, 0])
        mode = int(np.bincount(ids[:, 0]).argmax())
        check(prompt + [mode], ids[ids[:, 0] == mode, 1])


# -- usage metering --------------------------------------------------------------

class TestTenantLedger:
    def test_ledger_units(self):
        """The reference's units on the port's copy, against the
        reference's ledger after the same calls."""
        rows = []
        for Led, Reg in ((TenantLedger, MetricsRegistry),
                         (ref_metering.TenantLedger, RefRegistry)):
            led = Led()
            led.admit("acme", "standard", "base", 4)
            led.retire("acme", "standard", "base", 6)
            led.admit("acme", "batch", "tuned", 2)
            led.retire("acme", "batch", "tuned", 3)
            assert led.totals("acme") == {
                "requests": 2, "promptTokens": 6, "generatedTokens": 9}
            led.seed("newco", "standard", "newco")
            reg = Reg()
            led.collect(reg)
            assert _value(reg.counter("kfx_tenant_requests_total"),
                          tenant="newco", qos="standard",
                          adapter="newco") == 0
            assert _value(reg.counter("kfx_tenant_tokens_total"),
                          tenant="acme", qos="standard", adapter="base",
                          kind="generated") == 6
            rows.append((led.snapshot(), reg.render()))
        assert rows[0] == rows[1]

    @pytest.mark.parametrize("draft", [0, 1], ids=["plain", "spec"])
    def test_engine_exactness_with_preemption_and_skip(self, gapped, draft):
        """Generated-token billing equals what each request RETURNED,
        once: through preemption-by-recompute (never re-billed) and a
        stream_skip recovery re-dispatch (meter_skip deducted)."""
        eng = _engine(gapped, name="lm-meter", kv_pages=8,
                      prefix_cache=False, draft_layers=draft)
        try:
            prompts = [[i + 1, i + 2, i + 3] for i in range(4)]
            reqs = [eng.submit(p, max_new_tokens=40, tenant="acme")
                    for p in prompts]
            outs = [r.result(120) for r in reqs]
            assert eng.page_stats()["preemptions"] >= 1
            tot = eng.usage.totals("acme")
            assert tot["requests"] == 4
            assert tot["promptTokens"] == sum(len(p) for p in prompts)
            assert tot["generatedTokens"] == sum(len(o) for o in outs)
            out = eng.submit([9, 8, 7], max_new_tokens=8, tenant="acme",
                             meter_skip=3).result(60)
            tot2 = eng.usage.totals("acme")
            assert tot2["generatedTokens"] - tot["generatedTokens"] \
                == len(out) - 3
            eng.submit([1, 2], max_new_tokens=4).result(60)
            led = eng.usage
            assert led.totals("base")["requests"] == 1
            eng.usage = None             # turns every hook off
            eng.generate([[3, 4]], max_new_tokens=4)
            assert led.totals("base")["requests"] == 1
            _no_leak(eng)
        finally:
            eng.close()


def _http(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    with urllib.request.urlopen(urllib.request.Request(url, data=data),
                                timeout=60) as r:
        return r.read().decode()


def _tenant_lines(text):
    return [ln for ln in text.splitlines() if "kfx_tenant_" in ln]


def test_tenant_metrics_text_equals_reference(gapped, tmp_path,
                                              monkeypatch):
    """For one request sequence (a plain :generate, one billed to a named
    tenant, an SSE stream with stream_skip), the kfx_tenant_* text of the
    port's /metrics equals the reference server's, and both families are
    there before any traffic."""
    cfg_r, _, params = gapped
    export = str(tmp_path / "lm")
    ref_lm.export_lm(export, cfg_r, params)
    monkeypatch.delenv("KFX_LM_ENGINE", raising=False)
    texts = []
    for lm, srv_mod, dev in ((lm_server, port_server, {"device": "cpu"}),
                             (ref_lm, ref_server, {})):
        p = lm.LMPredictor(export, name="lm", warm_buckets=[8], **dev)
        p.load()
        srv = srv_mod.ModelServer(port=0)
        srv.register(p)
        srv.start()
        try:
            url = f"http://127.0.0.1:{srv.port}"
            pre = _tenant_lines(_http(f"{url}/metrics"))
            assert any("kfx_tenant_requests_total{" in ln for ln in pre)
            assert any("kfx_tenant_tokens_total{" in ln for ln in pre)
            gen = f"{url}/v1/models/lm:generate"
            _http(gen, {"prompt_tokens": [[5, 9, 11]], "max_new_tokens": 6})
            _http(gen, {"prompt_tokens": [[2, 4], [7]], "max_new_tokens": 5,
                        "tenant": "acme"})
            _http(gen, {"prompt_tokens": [[1, 2, 3]], "max_new_tokens": 7,
                        "tenant": "acme", "stream": True, "stream_skip": 2})
            texts.append((pre, _tenant_lines(_http(f"{url}/metrics"))))
        finally:
            srv.stop()
            p.close()
    assert texts[0] == texts[1]
    assert 'kfx_tenant_tokens_total{kind="generated",tenant="acme",' \
           'qos="interactive",adapter="base"} 15' in texts[0][1]


# -- the served defaults -------------------------------------------------------

@pytest.fixture(scope="module")
def export_dir(gapped, tmp_path_factory):
    cfg_r, _, params = gapped
    d = str(tmp_path_factory.mktemp("spec") / "lm")
    ref_lm.export_lm(d, cfg_r, params)
    return d


def test_predictor_speculates_by_default(export_dir, monkeypatch):
    """No KFX_LM_* set: a draft of max(1, n_layers // 4) layers, 4
    proposals, a pool of the target's page count, the spec families and
    the JSON engine block's spec_accept_rate; the knobs are read; and
    KFX_LM_SPEC=0 turns it off."""
    for k in [k for k in os.environ if k.startswith("KFX_LM_")]:
        monkeypatch.delenv(k)
    p = lm_server.LMPredictor(export_dir, name="lm", device="cpu",
                              warm_buckets=[8])
    p.load()
    srv = port_server.ModelServer(port=0)
    srv.register(p)
    srv.start()
    try:
        eng = p.engine
        assert eng.spec and eng.draft_layers == 1
        assert eng.propose_tokens == 4 and eng.draft_n_pages == eng.n_pages
        _http(f"http://127.0.0.1:{srv.port}/v1/models/lm:generate",
              {"prompt_tokens": [[5, 9, 11]], "max_new_tokens": 8})
        blk = json.loads(_http(f"http://127.0.0.1:{srv.port}"
                               "/metrics?format=json"))["engine"]["lm"]
        assert 0.0 < blk["spec_accept_rate"] <= 1.0
    finally:
        srv.stop()
        p.close()
    monkeypatch.setenv("KFX_LM_SPEC_LAYERS", "5")
    monkeypatch.setenv("KFX_LM_SPEC_TOKENS", "2")
    monkeypatch.setenv("KFX_LM_SPEC_PAGES", "9")
    p = lm_server.LMPredictor(export_dir, device="cpu", warm_buckets=[8])
    p.load()
    try:
        assert (p.engine.draft_layers, p.engine.propose_tokens,
                p.engine.draft_n_pages) == (1, 2, 9)   # capped at L - 1
    finally:
        p.close()
    monkeypatch.setenv("KFX_LM_SPEC", "0")
    p = lm_server.LMPredictor(export_dir, device="cpu", warm_buckets=[8])
    p.load()
    try:
        assert not p.engine.spec and p.engine.draft_model is None
    finally:
        p.close()


@pytest.mark.parametrize("spec,word", [(None, "spec=on"), ("0", "spec=off")],
                         ids=["default", "off"])
def test_server_ready_line_names_spec(export_dir, spec, word):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("KFX_LM_") and k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    if spec is not None:
        env["KFX_LM_SPEC"] = spec
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.serving.server",
         "--model-dir", export_dir, "--port", "0", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=REPO)
    try:
        line = proc.stdout.readline()
    finally:
        proc.kill()
        proc.wait(30)
    assert line.startswith("server_ready") and "engine=on" in line, (
        line, proc.stderr.read())
    assert line.split()[-1] == word
