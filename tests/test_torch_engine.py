"""The port's continuous-batching DecodeEngine and paged decode
(kubeflow_tpu_torch/serving/engine.py, models/transformer.py
PagedKVCache) against the reference's (kubeflow_tpu/serving/engine.py,
models/transformer.py's paged ``_decode_attend``), on the reference's
tiny fixture (vocab 64, d 32, H 2, D 16, L 2, d_ff 64, max_seq_len 64,
f32) on the CPU:

  * the paged decode logits against flax's paged branch (1e-4 abs);
  * BlockManager, PrefixCache and FairQueue driven through the same
    operations as the reference's classes, ending in equal states;
  * greedy tokens equal to the port's LMGenerator, to the JAX
    DecodeEngine (draft_layers=0) and to the JAX engine with chunked
    prefill at page-multiple and oversize chunks — on wide-gap weights
    with the top-1/top-2 gap asserted first;
  * the reference's tests/test_engine.py contracts (TestEngineDecode,
    TestPagedKV, TestChunkedPrefill, TestEngineServing, the on_token
    stream order) rerun on the port, without their chaos, int8 and
    speculative cases;
  * sampling: deterministic per seed whatever the batch mates, and
    distributed as softmax(logits / T) under the top-k mask."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from kubeflow_tpu.models import transformer as ref  # noqa: E402
from kubeflow_tpu.serving import adapters as ref_adapters  # noqa: E402
from kubeflow_tpu.serving import engine as ref_engine  # noqa: E402
from kubeflow_tpu_torch.models import transformer as port  # noqa: E402
from kubeflow_tpu_torch.models.convert import params_from_jax  # noqa: E402
from kubeflow_tpu_torch.models.generate import (  # noqa: E402
    LMGenerator, prefill_chunks)
from kubeflow_tpu_torch.obs import trace as port_trace  # noqa: E402
from kubeflow_tpu_torch.serving import engine as eng_mod  # noqa: E402
from kubeflow_tpu_torch.serving import lm_server  # noqa: E402
from kubeflow_tpu_torch.serving import server as port_server  # noqa: E402
from kubeflow_tpu_torch.serving.engine import (  # noqa: E402
    DecodeEngine, EngineOverloaded, PageAllocError)

from test_torch_generate import (  # noqa: E402
    CHI2_1E4, LOGITS, MIN_GAP, TINY, recompute, wide_gap)

TOL_LOGITS = 1e-4   # paged decode logits, port vs flax, f32, max-abs
MIXED = [[5, 9, 11, 3, 7], [2], [1, 2, 3, 4, 5, 6, 7, 8, 9], [13, 14]]
LONG_A = [(7 * i + 3) % 60 for i in range(40)]
LONG_B = [(3 * i + 1) % 60 for i in range(33)]


@pytest.fixture(scope="module")
def gapped():
    """(reference config, port config, wide-gap reference param tree)."""
    cfg_r = ref.TransformerConfig(**TINY, dtype=jnp.float32)
    params = ref.TransformerLM(cfg_r).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    params = wide_gap(jax.tree_util.tree_map(np.asarray, params))
    return cfg_r, port.TransformerConfig(**TINY, dtype="float32"), params


@pytest.fixture(scope="module")
def oracle(gapped):
    """Greedy one-shot tokens of the port's LMGenerator, one prompt at a
    time, after asserting the argmax gaps on the path."""
    _, cfg_p, params = gapped
    gen = LMGenerator(cfg_p, params, device="cpu")
    seen = {}

    def want(prompt, n):
        key = (tuple(prompt), n)
        if key not in seen:
            assert recompute(cfg_p, params, prompt, n)[1] > MIN_GAP
            seen[key] = gen.generate([prompt], max_new_tokens=n)[0]
        return seen[key]
    return want


def _engine(gapped, **kw):
    _, cfg_p, params = gapped
    kw.setdefault("n_slots", 4)
    kw.setdefault("chunk_tokens", 4)
    kw.setdefault("kv_page_size", 16)
    return DecodeEngine(cfg_p, params, device="cpu", **kw)


@pytest.fixture(scope="module")
def engine(gapped):
    # Module-scoped: every test drains its requests, so the shared engine
    # is idle between tests. 16-token pages over L=64 -> 4 blocks a slot.
    eng = _engine(gapped, name="lm")
    yield eng
    eng.close()


@pytest.fixture(scope="module")
def chunked_engine(gapped):
    """One-page (16-token) chunks over 16-token pages: a 40-token prompt
    admits in 3 chunk dispatches interleaved with decode."""
    eng = _engine(gapped, name="lm-ck", prefill_chunk_tokens=16)
    yield eng
    eng.close()


@pytest.fixture(scope="module")
def jax_engines(gapped):
    """The reference DecodeEngine without a draft, built on first use per
    prefill-chunk size (0 = monolithic)."""
    cfg_r, _, params = gapped
    made = {}

    def get(chunk):
        if chunk not in made:
            made[chunk] = ref_engine.DecodeEngine(
                cfg_r, params, n_slots=4, chunk_tokens=4,
                name=f"ref-ck{chunk}", kv_page_size=16, draft_layers=0,
                prefill_chunk_tokens=chunk)
        return made[chunk]
    yield get
    for e in made.values():
        e.close()


def _counter(name, model, reg=None, kind="counter"):
    reg = reg if reg is not None else eng_mod.default_registry()
    return sum(v for lab, v in getattr(reg, kind)(name).samples()
               if lab.get("model") == model)


# -- paged decode against flax ------------------------------------------------

def test_paged_decode_logits_match_flax(gapped):
    """Right-padded mixed prefill into a paged pool through block tables
    with unallocated blocks, then 3 decode steps at dense-equivalent
    locations (one row's decode block unallocated, so its writes are
    dropped / sunk): the port's logits equal flax's paged branch."""
    _, _, params = gapped
    paged = dict(TINY, decode=True, kv_page_size=16, kv_pages=8)
    cfg_r = ref.TransformerConfig(**paged, dtype=jnp.float32)
    cfg_p = port.TransformerConfig(**paged, dtype="float32", attn_impl="xla")
    model_r = ref.TransformerLM(cfg_r)
    model_p = port.TransformerLM(cfg_p, device="meta")
    model_p.load_state_dict({k: torch.as_tensor(v) for k, v in
                             params_from_jax(params).items()}, assign=True)
    prompts = [[5, 9, 11, 3, 7], [2, 30], [(3 * i + 2) % 60
                                           for i in range(20)]]
    pad = 32
    tables = np.array([[0, 1, 6, -1], [2, -1, -1, -1], [3, 4, 5, -1]],
                      np.int32)
    toks = np.zeros((3, pad), np.int32)
    pos = np.full((3, pad), -1, np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
        pos[i, :len(p)] = np.arange(len(p))
    lr, vs = model_r.apply({"params": params}, jnp.asarray(toks),
                           positions=jnp.asarray(pos),
                           block_tables=jnp.asarray(tables),
                           mutable=["cache"])
    cache = port.PagedKVCache.allocate(cfg_p)
    tt = torch.from_numpy(tables)
    with torch.no_grad():
        lp = model_p(torch.from_numpy(toks).long(), torch.from_numpy(pos),
                     cache, tt)
    err = float(np.abs(np.asarray(lr) - lp.numpy()).max())
    assert err < TOL_LOGITS, err
    true_len = np.array([len(p) for p in prompts])
    nxt = lp.numpy()[np.arange(3), true_len - 1].argmax(-1)
    for step in range(3):
        t = nxt[:, None].astype(np.int32)
        qp = (true_len + step)[:, None].astype(np.int32)
        loc = np.full((3, 1), pad + step, np.int32)
        lr, vs = model_r.apply({"params": params, **vs}, jnp.asarray(t),
                               positions=jnp.asarray(qp),
                               block_tables=jnp.asarray(tables),
                               write_locations=jnp.asarray(loc),
                               mutable=["cache"])
        with torch.no_grad():
            lp = model_p(torch.from_numpy(t).long(), torch.from_numpy(qp),
                         cache, tt, torch.from_numpy(loc))
        err = float(np.abs(np.asarray(lr) - lp.numpy()).max())
        assert err < TOL_LOGITS, (step, err)
        nxt = lp.numpy()[:, 0].argmax(-1)
    # The sink page was written (row 1's decode block is unallocated) and
    # the pool pages equal flax's pool.
    ck = np.asarray(vs["cache"]["layers"]["attn"]["cached_key"])
    got = cache.key.numpy()
    np.testing.assert_allclose(got[:, :8], ck, atol=TOL_LOGITS)
    assert (cache.pos[:, 8] >= 0).any()
    np.testing.assert_array_equal(
        cache.pos.numpy()[:, :8],
        np.asarray(vs["cache"]["layers"]["attn"]["cached_pos"]))


def test_paged_forward_refuses_mismatched_cache(gapped):
    _, _, params = gapped
    cfg = port.TransformerConfig(**dict(TINY, decode=True, kv_page_size=16,
                                        kv_pages=4), dtype="float32")
    model = port.TransformerLM(cfg)
    tok = torch.zeros(1, 2, dtype=torch.long)
    with pytest.raises(ValueError, match="PagedKVCache"):
        model(tok, None, port.KVCache.allocate(cfg, 1))
    with pytest.raises(ValueError, match="block_tables"):
        model(tok, None, port.PagedKVCache.allocate(cfg))
    with pytest.raises(ValueError, match="kv_page_size > 0"):
        port.PagedKVCache.allocate(port.TransformerConfig(**TINY))


# -- host classes against the reference ---------------------------------------

def _mgr_state(m):
    return list(m._free), m.ref.tolist(), sorted(m.dirty)


def test_block_manager_matches_reference():
    a, b = eng_mod.BlockManager(6, 16), ref_engine.BlockManager(6, 16)
    for m in (a, b):
        p = m.alloc(3)
        m.incref(p[1])
        m.decref([p[0], p[1]])
        q = m.alloc(2)
        m.decref([p[1], q[0]])
    assert _mgr_state(a) == _mgr_state(b)
    with pytest.raises(PageAllocError) as ea:
        a.alloc(9)
    with pytest.raises(ref_engine.PageAllocError) as eb:
        b.alloc(9)
    assert str(ea.value) == str(eb.value)
    assert _mgr_state(a) == _mgr_state(b)   # a failed alloc took nothing


def _cache_state(pc):
    return ([(k[0], k[1], e.page, e.nchildren, e.tokens)
             for k, e in pc._lru.items()],
            pc.hits, pc.tokens_reused, _mgr_state(pc.mgr))


def test_prefix_cache_matches_reference():
    """Inserts, chain matches (full, diverging, COW-partial), LRU
    evictions children-first: the same pages, keys and refcounts."""
    toks = list(range(11))  # 2 full pages of 4 + partial [8, 9, 10]
    states, matches = [], []
    for mod in (eng_mod, ref_engine):
        mgr = mod.BlockManager(8, 4)
        pc = mod.PrefixCache(mgr)
        pages = mgr.alloc(3)
        h = pc.insert_full(b"", toks[0:4], pages[0])
        h = pc.insert_full(h, toks[4:8], pages[1])
        pc.insert_partial(h, toks[8:11], pages[2])
        pc.insert_full(b"", toks[0:4], pages[0])     # refresh, no dup
        got = [pc.match(toks, 10), pc.match(toks[:4] + [99] * 7, 10),
               pc.match(toks[:9] + [99, 99], 10)]
        assert not pc.evict_one()          # slot-held: not reclaimable
        mgr.decref(pages)                  # the slot retires
        order = []
        while pc.evict_one():
            order.append(_mgr_state(mgr))
        matches.append(got)
        states.append((order, _cache_state(pc)))
    assert matches[0] == matches[1]
    assert matches[0][0][:3] == ([0, 1], (2, 2), 10)
    assert states[0] == states[1]


class _Req:
    def __init__(self, rid, adapter="", qos="interactive"):
        self.rid, self.adapter, self.qos = rid, adapter, qos
        self.t_enqueue = float(rid)


def test_fair_queue_matches_reference():
    """Weighted round-robin over tenants in two QoS bands, the recompute
    front lane, batch shedding (newest first) and drain: the same pop
    order as the reference's FairQueue."""
    out = []
    for FQ in (eng_mod.FairQueue, ref_adapters.FairQueue):
        q = FQ({"a": 2})
        reqs = [_Req(i, adapter=("", "a", "b")[i % 3],
                     qos="batch" if i % 4 == 3 else "interactive")
                for i in range(12)]
        for r in reqs:
            q.push(r)
        q.push_front(_Req(99))
        seq = [q.pop().rid for _ in range(5)]
        seq.append([r.rid for r in q.shed_batch(2)])
        seq.append(len(q))
        seq.append(q.pop().rid)
        seq.append([r.rid for r in q.drain_all()])
        seq.append((len(q), q.pop()))
        out.append(seq)
    assert out[0] == out[1]


# -- greedy against the three references --------------------------------------

class TestEngineDecode:
    def test_greedy_parity_mixed_lengths(self, engine, oracle):
        """Engine output == the port's one-shot LMGenerator token for
        token for a mix of prompt lengths (per prompt: row-independent)."""
        out = engine.generate(MIXED, max_new_tokens=12)
        assert out == [oracle(p, 12) for p in MIXED]

    def test_greedy_equals_jax_engine(self, engine, oracle, jax_engines):
        """The port's engine and the reference DecodeEngine
        (draft_layers=0) give the same greedy tokens."""
        prompts = MIXED + [LONG_B]
        for p in prompts:
            oracle(p, 10)   # asserts the gaps on the path
        want = jax_engines(0).generate(prompts, max_new_tokens=10)
        assert engine.generate(prompts, max_new_tokens=10) == want

    def test_slot_reuse_stays_exact(self, engine, oracle):
        first = engine.generate([[7, 8, 9]] * 4, max_new_tokens=20)
        second = engine.generate([[5, 9, 11]] * 4, max_new_tokens=8)
        assert second == [oracle([5, 9, 11], 8)] * 4
        assert first[0] == oracle([7, 8, 9], 20)

    def test_midflight_admission(self, engine):
        """A short request admitted while a long one decodes retires
        first."""
        long_req = engine.submit([1, 2, 3], max_new_tokens=48)
        deadline = time.monotonic() + 30
        while not engine._active.any() and time.monotonic() < deadline:
            time.sleep(0.002)
        short_req = engine.submit([4, 5], max_new_tokens=4)
        assert short_req.result(60) is not None
        long_req.result(60)
        assert len(long_req.tokens) == 48
        assert len(short_req.tokens) == 4
        assert short_req.t_done < long_req.t_done

    def test_stop_token_early_retirement(self, engine, oracle):
        want = oracle([5, 9, 11, 3, 7], 12)
        cut = next(j for j in range(2, len(want)) if want[j] not in want[:j])
        out = engine.generate([[5, 9, 11, 3, 7]], max_new_tokens=12,
                              stop_token=want[cut])[0]
        assert out == want[:cut]
        assert engine._active_count() == 0

    def test_capacity_guard_and_validation(self, engine):
        with pytest.raises(ValueError, match="cache capacity"):
            engine.submit([1] * 60, max_new_tokens=32)
        with pytest.raises(ValueError, match="non-empty"):
            engine.submit([], max_new_tokens=4)
        with pytest.raises(ValueError, match="max_new_tokens"):
            engine.submit([1], max_new_tokens=0)
        with pytest.raises(ValueError, match="token ids"):
            engine.submit([64], max_new_tokens=1)

    def test_bounded_queueing_overload(self, gapped):
        eng = _engine(gapped, n_slots=1, chunk_tokens=2, max_queue=2,
                      name="lm-q")
        try:
            first = eng.submit([1, 2], max_new_tokens=40)
            deadline = time.monotonic() + 30
            while eng.queue_depth and time.monotonic() < deadline:
                time.sleep(0.005)
            assert eng.queue_depth == 0
            reqs = [first] + [eng.submit([1, 2], max_new_tokens=40)
                              for _ in range(2)]
            with pytest.raises(EngineOverloaded, match="queue full"):
                eng.submit([1, 2], max_new_tokens=40)
            for r in reqs:
                assert len(r.result(60)) == 40
        finally:
            eng.close()

    def test_poisoned_request_fails_alone(self, engine, monkeypatch):
        """A request whose prefill blows up fails with that error ALONE;
        the loop survives and serves the next request."""
        real = DecodeEngine._prefill
        calls = {"n": 0}

        def poisoned(self_, *a, **kw):
            calls["n"] += 1
            if calls["n"] == 1:
                raise ValueError("poisoned prefill")
            return real(self_, *a, **kw)

        monkeypatch.setattr(DecodeEngine, "_prefill", poisoned)
        bad = engine.submit([1, 2, 3], max_new_tokens=4)
        with pytest.raises(ValueError, match="poisoned"):
            bad.result(30)
        assert engine._thread.is_alive()
        assert len(engine.generate([[5, 9, 11]], max_new_tokens=4)[0]) == 4
        st = engine.page_stats()
        assert st["free"] + st["cached"] == st["pages"]

    def test_loop_propagates_shutdown_exceptions(self, gapped, monkeypatch):
        """SystemExit is shutdown, not a request failure: the thread
        exits, and close() resolves what was left."""
        eng = _engine(gapped, n_slots=1, chunk_tokens=2, name="lm-exit")
        monkeypatch.setattr(threading, "excepthook", lambda args: None)
        try:
            def boom():
                raise SystemExit(1)

            monkeypatch.setattr(eng, "_admit_ready", boom)
            req = eng.submit([1], max_new_tokens=2)
            eng._thread.join(10)
            assert not eng._thread.is_alive()
            assert not req.done()
        finally:
            eng.close()
        with pytest.raises(RuntimeError, match="engine closed"):
            req.result(1)


class TestPagedKV:
    def test_occupancy_is_token_weighted(self, gapped):
        eng = _engine(gapped, name="occ")
        eng.close()  # loop stopped: safe to fabricate slot state
        assert eng._occupancy() == 0.0
        eng._slots[0] = object()
        eng._slot_pages[0] = [0]           # 1 of 16 pages
        assert eng._occupancy() == pytest.approx(4 * 1 / 16)
        eng._slots[1] = object()
        eng._slot_pages[1] = [1, 2, 3]
        assert eng._occupancy() == pytest.approx(4 * 4 / 16)
        eng._slots[2] = object()
        eng._slot_pages[2] = [1, 2, 3, 4]   # shares 1-3, owns 4
        assert eng._occupancy() == pytest.approx(4 * 5 / 16)

    def test_shared_prefix_skips_prefill_exactly(self, engine, oracle):
        """Admissions sharing a system prompt reuse its cached pages (full
        pages refcounted, the boundary page copy-on-write) and the
        outputs stay equal to the oracle, which shares nothing."""
        system = [(7 * i + 3) % 60 for i in range(36)]  # 2.25 pages
        prompts = [system + [60 + i] for i in range(3)]
        st0 = engine.prefix_stats()
        out = engine.generate(prompts, max_new_tokens=8)
        assert out == [oracle(p, 8) for p in prompts]
        st = engine.prefix_stats()
        # The first admission fills the cache; the other two each reuse 2
        # full pages + 4 COW'd boundary tokens = 36 of 37 tokens.
        assert st["hits"] - st0["hits"] >= 2
        assert st["tokens_reused"] - st0["tokens_reused"] >= 2 * 36
        assert _counter("kfx_lm_prefix_cache_hits_total", "lm") >= \
            st["hits"]

    def test_reuse_after_retire_and_2x_admission(self, gapped, oracle):
        """A pool of 8 x 16 tokens (the dense layout's memory for TWO
        64-token rows) admits all 8 short requests at once; recycled
        pages carry no stale KV; when decode outgrows the pool the
        youngest slot is preempted and completes by recompute, exact;
        and every page comes back."""
        eng = _engine(gapped, n_slots=8, kv_pages=8, prefix_cache=False,
                      name="lm-pp")
        try:
            dense_equiv = eng.n_pages * eng.page_size // 64
            assert dense_equiv == 2
            prompts = [[i + 1, i + 2] for i in range(8)]
            reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
            peak, deadline = 0, time.monotonic() + 60
            while (not all(r.done() for r in reqs)
                   and time.monotonic() < deadline):
                peak = max(peak, eng._active_count())
                time.sleep(0.001)
            outs = [r.result(60) for r in reqs]
            assert peak >= 2 * dense_equiv, peak
            assert outs == [oracle(p, 8) for p in prompts]
            outs = eng.generate([[51, 52, 53]] * 4, max_new_tokens=8)
            assert outs == [oracle([51, 52, 53], 8)] * 4
            prompts = [[i + 1, i + 2, i + 3] for i in range(4)]
            outs = eng.generate(prompts, max_new_tokens=40)
            assert outs == [oracle(p, 40) for p in prompts]
            st = eng.page_stats()
            assert st["preemptions"] >= 1
            assert _counter("kfx_lm_kv_preemptions_total", "lm-pp") == \
                st["preemptions"]
            assert st["free"] == st["pages"] and st["cached"] == 0
        finally:
            eng.close()

    def test_page_accounting_with_prefix_cache(self, gapped, oracle):
        """After a preempting wave with the prefix cache on, free pages
        plus cache-held pages equal the pool (no page leaks)."""
        eng = _engine(gapped, n_slots=4, kv_pages=6, name="lm-leak")
        try:
            prompts = [LONG_A[:20], LONG_A[:20] + [61], [1, 2, 3], [4]]
            outs = eng.generate(prompts, max_new_tokens=30)
            assert outs == [oracle(p, 30) for p in prompts]
            st = eng.page_stats()
            assert st["preemptions"] >= 1
            assert st["free"] + st["cached"] == st["pages"]
            assert int(eng._mgr.ref.sum()) == st["cached"]
        finally:
            eng.close()


class TestChunkedPrefill:
    def test_parity_page_chunks_and_dispatch_count(self, chunked_engine,
                                                   oracle):
        """Mixed lengths through one-page chunks: equal to the oracle,
        with exactly the chunk dispatches prefill_chunks predicts for the
        long prompts (short tails keep the single dispatch)."""
        eng = chunked_engine
        prompts = [LONG_A, [2], [1, 2, 3, 4, 5], LONG_B]
        before = _counter("kfx_lm_prefill_chunks_total", "lm-ck")
        out = eng.generate(prompts, max_new_tokens=12)
        assert out == [oracle(p, 12) for p in prompts]
        want = sum(len(prefill_chunks(len(p), 16, 64))
                   for p in (LONG_A, LONG_B))
        assert _counter("kfx_lm_prefill_chunks_total", "lm-ck") - before \
            == want

    @pytest.mark.parametrize("chunk", [16, 128],
                             ids=["page_multiple", "oversize"])
    def test_chunked_equals_jax_chunked_engine(self, gapped, oracle,
                                               jax_engines, chunk):
        """The port's and the reference's engines with the same prefill
        chunk give the same greedy tokens."""
        prompts = [LONG_A, [2], LONG_B, [13, 14]]
        for p in prompts:
            oracle(p, 10)
        want = jax_engines(chunk).generate(prompts, max_new_tokens=10)
        eng = _engine(gapped, name=f"ck-j{chunk}",
                      prefill_chunk_tokens=chunk)
        try:
            assert eng.generate(prompts, max_new_tokens=10) == want
        finally:
            eng.close()

    def test_parity_two_page_and_oversize_chunks(self, gapped, oracle):
        """Chunk sizes 2 x page and > prompt: parity holds; an oversize
        chunk degenerates to the monolithic path (no chunk dispatch)."""
        prompts = [LONG_A, [13, 14]]
        want = [oracle(p, 10) for p in prompts]
        for chunk, n_chunks in ((32, 2), (128, 0)):
            eng = _engine(gapped, n_slots=2, name=f"ck{chunk}",
                          prefill_chunk_tokens=chunk)
            try:
                assert eng.generate(prompts, max_new_tokens=10) == want
                assert _counter("kfx_lm_prefill_chunks_total",
                                f"ck{chunk}") == n_chunks
            finally:
                eng.close()

    def test_chunked_admission_with_prefix_hit_tail(self, chunked_engine,
                                                    oracle):
        eng = chunked_engine
        system = [(5 * i + 7) % 60 for i in range(36)]  # 2.25 pages
        prompts = [system + [60 + i] for i in range(3)]
        reused0 = eng.prefix_stats()["tokens_reused"]
        out = eng.generate(prompts, max_new_tokens=8)
        assert out == [oracle(p, 8) for p in prompts]
        assert eng.prefix_stats()["tokens_reused"] - reused0 >= 2 * 32

    def test_decode_interleaves_and_stall_is_observed(self, chunked_engine,
                                                      oracle):
        eng = chunked_engine
        hist = eng_mod.default_registry().histogram(
            "kfx_lm_decode_stall_seconds")
        before = hist.count(model="lm-ck")
        short = eng.submit([4, 5], max_new_tokens=32)
        deadline = time.monotonic() + 30
        while not eng._active.any() and time.monotonic() < deadline:
            time.sleep(0.001)
        long_p = [(11 * i + 5) % 60 for i in range(40)]
        long_req = eng.submit(long_p, max_new_tokens=8)
        assert short.result(60) == oracle([4, 5], 32)
        assert long_req.result(60) == oracle(long_p, 8)
        assert hist.count(model="lm-ck") > before

    def test_preemption_mid_prefill(self, gapped, oracle):
        eng = _engine(gapped, n_slots=8, kv_pages=8, prefix_cache=False,
                      prefill_chunk_tokens=16, name="lm-ckpp")
        try:
            grow = [[i + 1, i + 2, i + 3] for i in range(3)]
            long_p = [(5 * i + 2) % 60 for i in range(40)]
            prompts = grow + [long_p]
            outs = eng.generate(prompts, max_new_tokens=24)
            assert outs == [oracle(p, 24) for p in prompts]
            assert eng.page_stats()["preemptions"] >= 1
            assert eng._mgr.n_free == eng.n_pages
        finally:
            eng.close()

    def test_drain_mid_prefill(self, gapped, oracle, monkeypatch):
        """drain() while a cursor is mid-prompt: the prefilling slot is
        in-flight work and finishes its prefill and decode in the drain
        window, exactly."""
        eng = _engine(gapped, n_slots=2, prefill_chunk_tokens=16,
                      name="lm-ckdr")
        real = DecodeEngine._prefill

        def slow(self_, *a, **kw):
            time.sleep(0.2)   # a wide mid-prefill window
            return real(self_, *a, **kw)

        monkeypatch.setattr(DecodeEngine, "_prefill", slow)
        try:
            long_p = [(5 * i + 2) % 60 for i in range(40)]
            req = eng.submit(long_p, max_new_tokens=8)
            deadline = time.monotonic() + 30
            while not eng._prefilling and time.monotonic() < deadline:
                time.sleep(0.0005)
            assert eng._prefilling, "never observed a mid-prefill slot"
            assert eng.drain(wait_s=30) is True
            assert req.result(1) == oracle(long_p, 8)
            with pytest.raises(eng_mod.EngineDraining):
                eng.submit([1], max_new_tokens=1)
        finally:
            eng.close()


# -- serving ---------------------------------------------------------------

def _post(port, body, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/lm:generate",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.load(r)


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


@pytest.fixture()
def export_dir(gapped, tmp_path):
    cfg_r, _, params = gapped
    from kubeflow_tpu.serving.lm_server import export_lm

    export_lm(str(tmp_path / "lm"), cfg_r, params)
    return str(tmp_path / "lm")


class TestEngineServing:
    @pytest.fixture()
    def lm_server(self, export_dir, monkeypatch):
        monkeypatch.delenv("KFX_LM_ENGINE", raising=False)
        p = lm_server.LMPredictor(export_dir, name="lm", device="cpu")
        p.load()
        srv = port_server.ModelServer(port=0)
        srv.register(p)
        srv.start()
        yield srv, p
        srv.stop()
        p.close()

    def test_generate_and_engine_metrics_scrape(self, lm_server):
        """The served engine path answers :generate, and the engine's
        metric families pass a validating scrape with --require."""
        import scripts.scrape_metrics as scrape

        srv, p = lm_server
        assert p.engine is not None
        _, pre = _get(srv.port, "/metrics")
        assert "kfx_lm_slots{" in pre and "kfx_lm_warm_buckets{" in pre
        body = _post(srv.port, {"prompt_tokens": [[5, 9, 11], [2, 4]],
                                "max_new_tokens": 6})
        assert [len(t) for t in body["generated_tokens"]] == [6, 6]
        deadline = time.monotonic() + 60
        want = len(p.engine.prompt_buckets)
        while time.monotonic() < deadline and _counter(
                "kfx_lm_warm_buckets", "lm", p.metrics, "gauge") < want:
            time.sleep(0.05)
        assert _counter("kfx_lm_warm_buckets", "lm", p.metrics,
                        "gauge") == want
        fams = ["kfx_lm_slot_occupancy", "kfx_lm_queue_wait_seconds",
                "kfx_lm_warm_buckets", "kfx_lm_tokens_per_second",
                "kfx_lm_engine_chunks_total", "kfx_lm_kv_pages",
                "kfx_lm_kv_pages_free", "kfx_lm_kv_bytes_per_token",
                "kfx_lm_quant_mode", "kfx_lm_prefix_cache_hits_total",
                "kfx_lm_prefix_tokens_reused",
                "kfx_lm_prompt_tokens_admitted",
                "kfx_lm_prefill_chunks_total",
                "kfx_lm_decode_stall_seconds",
                "kfx_lm_kv_preemptions_total",
                "kfx_lm_generated_tokens_total"]
        argv = [f"http://127.0.0.1:{srv.port}/metrics"]
        for f in fams:
            argv += ["--require", f]
        assert scrape.main(argv) == 0
        assert p.metrics.histogram("kfx_lm_queue_wait_seconds").count(
            model="lm") >= 2
        blk = json.loads(_get(srv.port, "/metrics?format=json")[1])
        blk = blk["engine"]["lm"]
        assert blk["slots"] == 8
        assert blk["kv_bytes_per_token"] == p.engine.kv_bytes_per_token

    def test_engine_parity_with_oracle_predictor(self, export_dir,
                                                 monkeypatch):
        """KFX_LM_ENGINE=0 serves the one-shot oracle; the engine path's
        greedy responses equal it."""
        monkeypatch.setenv("KFX_LM_ENGINE", "0")
        oracle_p = lm_server.LMPredictor(export_dir, name="lm",
                                         device="cpu")
        oracle_p.load()
        assert oracle_p.engine is None
        monkeypatch.setenv("KFX_LM_ENGINE", "1")
        eng_p = lm_server.LMPredictor(export_dir, name="lm", device="cpu",
                                      warm_buckets=[8])
        eng_p.load()
        try:
            body = {"prompt_tokens": [[5, 9, 11], [2], [1, 2, 3, 4]],
                    "max_new_tokens": 10}
            assert eng_p.generate(dict(body))["generated_tokens"] == \
                oracle_p.generate(dict(body))["generated_tokens"]
            with pytest.raises(ValueError, match="stop_token"):
                oracle_p.generate({"prompt_tokens": [[1]],
                                   "stop_token": 3})
        finally:
            eng_p.close()

    def test_overload_is_503_with_retry_after(self, export_dir,
                                              monkeypatch):
        monkeypatch.delenv("KFX_LM_ENGINE", raising=False)
        p = lm_server.LMPredictor(export_dir, name="lm", device="cpu",
                                  max_batch_size=1, warm_buckets=[8])
        p.load()
        p.engine.max_queue = 1
        srv = port_server.ModelServer(port=0)
        srv.register(p)
        srv.start()
        try:
            results, lock = [], threading.Lock()

            def fire():
                try:
                    _post(srv.port, {"prompt_tokens": [[1, 2]],
                                     "max_new_tokens": 48})
                    with lock:
                        results.append((200, ""))
                except urllib.error.HTTPError as e:
                    with lock:
                        results.append(
                            (e.code, e.headers.get("Retry-After", "")))

            threads = [threading.Thread(target=fire) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
            codes = [c for c, _ in results]
            assert 200 in codes and 503 in codes
            assert set(codes) <= {200, 503}
            assert all(ra for c, ra in results if c == 503)
        finally:
            srv.stop()
            p.close()

    def test_healthz_reports_a_wedged_loop(self, lm_server, monkeypatch):
        """/healthz is a liveness probe: 503 {"status": "wedged"} while the
        decode loop stalls with work in flight, alive again after."""
        srv, p = lm_server
        p.engine.stall_threshold_s = 0.2
        # The decode dispatch of either mode (a chunk, or a speculative
        # iteration: the served engine speculates by default).
        real = DecodeEngine._decode_once
        calls = {"n": 0}

        def stalled(self_):
            calls["n"] += 1
            if calls["n"] == 1:
                time.sleep(1.5)
            return real(self_)

        monkeypatch.setattr(DecodeEngine, "_decode_once", stalled)
        req = p.engine.submit([1, 2, 3], max_new_tokens=4)
        seen, deadline = None, time.monotonic() + 10
        while time.monotonic() < deadline and not req.done():
            code, text = _get(srv.port, "/healthz")
            if code == 503:
                seen = json.loads(text)
                break
            time.sleep(0.05)
        assert seen is not None and seen["status"] == "wedged"
        assert "lm" in seen["models"]
        req.result(30)
        assert _get(srv.port, "/healthz") == (200, '{"status": "alive"}')

    def test_engine_spans_recorded(self, engine, monkeypatch):
        """engine.admit and engine.chunk spans join the submitting
        request's trace, parented to its span."""
        recs = []
        monkeypatch.setattr(port_trace, "_emit",
                            lambda sp: recs.append(sp.to_record()))
        with port_trace.span("client.generate",
                             trace_id="trace-engine-test") as root:
            engine.generate([[5, 9, 11]], max_new_tokens=6)
        by_name = {}
        for r in recs:
            by_name.setdefault(r["name"], []).append(r)
        admit = by_name["engine.admit"][0]
        assert admit["trace"] == "trace-engine-test"
        assert admit["parent"] == root.span_id
        assert by_name["engine.chunk"][0]["trace"] == "trace-engine-test"


# -- streaming and sampling ------------------------------------------------

def test_on_token_stream_order_and_sentinel(engine):
    """The streaming sink sees every token once, in engine order, then
    the terminal None."""
    sinks = [[] for _ in range(3)]
    reqs = [engine.submit([i + 1, i + 2], max_new_tokens=8,
                          on_token=sinks[i].append) for i in range(3)]
    outs = [r.result(60) for r in reqs]
    for out, sink in zip(outs, sinks):
        assert sink[-1] is None
        assert sink[:-1] == out


def test_sampling_deterministic_per_seed_and_batch_mates(engine, gapped):
    """A sampled request's tokens depend on its seed only: the same
    alone, beside other requests (other slots, other knobs), and after a
    preemption-by-recompute in a small pool."""
    kw = dict(max_new_tokens=12, temperature=1.0)
    alone = engine.generate([[1, 2, 3]], seed=1, **kw)[0]
    assert alone == engine.generate([[1, 2, 3]], seed=1, **kw)[0]
    assert alone != engine.generate([[1, 2, 3]], seed=2, **kw)[0]
    mates = [engine.submit([9, 8], max_new_tokens=20, temperature=0.7,
                           top_k=5, seed=7),
             engine.submit([4], max_new_tokens=6)]
    r = engine.submit([1, 2, 3], seed=1, **kw)
    assert r.result(60) == alone
    for m in mates:
        m.result(60)
    eng = _engine(gapped, n_slots=4, kv_pages=5, prefix_cache=False,
                  name="lm-seed")
    try:
        reqs = [eng.submit([i + 5, i + 6], max_new_tokens=40,
                           temperature=1.0, seed=i) for i in range(3)]
        reqs.append(eng.submit([1, 2, 3], seed=1, **kw))
        assert reqs[-1].result(60) == alone
        for r in reqs[:-1]:
            r.result(60)
        assert eng.page_stats()["preemptions"] >= 1
    finally:
        eng.close()


@pytest.mark.parametrize("temperature,top_k,support", [
    (1.0, 0, 8), (0.7, 3, 4),   # k-th value tied: both 1.0s survive
    (1.3, 2, 2), (0.5, 100, 8),  # top_k beyond V filters nothing
    (1.0, 1, 2),                 # tie at the max: both survive
], ids=["t1", "t0.7_k3_tie", "t1.3_k2", "k_past_v", "k1_tie_at_max"])
def test_sample_slots_matches_target_distribution(temperature, top_k,
                                                  support):
    """20k draws, each row its own (seed, token index): chi-square over
    the surviving tokens below its p = 1e-4 quantile, masked tokens never
    drawn."""
    logits = torch.tensor(LOGITS)
    if top_k == 1:
        logits = torch.tensor([3.0, 3.0] + LOGITS[2:])
    n = 20_000
    seeds = torch.full((n,), eng_mod.seed32(11), dtype=torch.int64)
    draws = eng_mod.sample_slots(
        logits.expand(n, -1), torch.full((n,), temperature),
        torch.full((n,), top_k, dtype=torch.int64), seeds,
        torch.arange(n, dtype=torch.int64), True, top_k > 0)
    counts = np.bincount(draws.numpy(), minlength=8)
    scaled = logits / temperature
    if 0 < top_k:
        kth = torch.sort(scaled).values[max(8 - top_k, 0)]
        scaled = scaled.masked_fill(scaled < kth, float("-inf"))
    p = torch.softmax(scaled, -1).numpy()
    assert int((p > 0).sum()) == support
    assert counts[p == 0].sum() == 0
    expect = p[p > 0] * n
    chi2 = float(((counts[p > 0] - expect) ** 2 / expect).sum())
    assert chi2 < CHI2_1E4[support - 1], (counts, expect)


def test_sample_slots_mixes_greedy_and_sampled_rows():
    """Rows with T <= 0 take the first argmax even beside sampled rows;
    the uniforms lie in (0, 1) and depend only on (seed, index)."""
    logits = torch.tensor([[0.5, 3.0, 3.0, -1.0], [1.0, 0.0, 1.0, 1.0]])
    for sampled in (False, True):
        got = eng_mod.sample_slots(
            logits, torch.tensor([0.0, 0.0]), torch.tensor([0, 2]),
            torch.tensor([1, 2]), torch.tensor([0, 0]), sampled, sampled)
        assert got.tolist() == [1, 0]
    u = eng_mod.slot_uniforms(torch.tensor([5, 5, 6]), torch.tensor([3, 3, 3]),
                              1000)
    assert bool(((u > 0) & (u < 1)).all())
    assert torch.equal(u[0], u[1]) and not torch.equal(u[0], u[2])
    assert abs(float(u.mean()) - 0.5) < 0.05
