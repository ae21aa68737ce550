"""Multi-tenant LoRA in the port (kubeflow_tpu_torch/training/lora.py,
serving/adapters.py, serving/export.py's adapter artifact, the
DecodeEngine's AdapterPool and the server's ``adapter`` field) against the
reference's (kubeflow_tpu/training/lora.py, serving/adapters.py), on the
reference's tiny fixture of tests/test_adapters.py (vocab 64, d 32, H 2,
D 16, L 2, d_ff 64, max_seq_len 64, f32; rank 4, alpha 8, three tenants)
on the CPU:

  * the fine-tune: three steps of both tuners from the JAX tuner's own
    initial factors, losses within 1e-5 relative and factors within 1e-5,
    the base bit-unchanged, step 0's logits those of the lora_rank=0
    model;
  * the artifact: byte-equal files from both packages for the same flat
    tree, each package loading the other's; merge and gather within 1e-6
    of the reference's, id -1 rows exactly zero;
  * the engine (tests/test_adapters.py's classes rerun on the port):
    greedy tokens equal to the merged-weights oracle and to the JAX
    engine's, mixed batches, LRU paging with the JAX engine's loads and
    evictions, speculation, chunked prefill and recycling, the
    engine.adapter_load chaos point under both fallbacks, per-tenant
    fairness, the HBM ratio, the prefix cache chained per adapter, the
    metric families (text equal to the reference's) and the HTTP
    surface."""

import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from kubeflow_tpu.models import transformer as ref  # noqa: E402
from kubeflow_tpu.obs.metrics import MetricsRegistry as RefRegistry  # noqa: E402,E501
from kubeflow_tpu.serving import adapters as ref_ad  # noqa: E402
from kubeflow_tpu.serving import engine as ref_engine  # noqa: E402
from kubeflow_tpu.serving import export as ref_export  # noqa: E402
from kubeflow_tpu.training import lora as ref_lora  # noqa: E402
from kubeflow_tpu_torch import chaos  # noqa: E402
from kubeflow_tpu_torch.models import transformer as port  # noqa: E402
from kubeflow_tpu_torch.models.convert import (  # noqa: E402
    params_from_jax, params_to_jax)
from kubeflow_tpu_torch.models.generate import LMGenerator  # noqa: E402
from kubeflow_tpu_torch.obs.metrics import MetricsRegistry  # noqa: E402
from kubeflow_tpu_torch.serving import adapters as ad  # noqa: E402
from kubeflow_tpu_torch.serving import export as port_export  # noqa: E402
from kubeflow_tpu_torch.serving import lm_server  # noqa: E402
from kubeflow_tpu_torch.serving import server as port_server  # noqa: E402
from kubeflow_tpu_torch.serving.engine import (  # noqa: E402
    AdapterLoadError, DecodeEngine, EngineOverloaded)
from kubeflow_tpu_torch.training.lora import LoRAFineTuner  # noqa: E402

from test_torch_generate import MIN_GAP, TINY, recompute, wide_gap  # noqa: E402,E501

RANK, ALPHA = 4, 8.0
TENANTS = ("alice", "bob", "carol")
PROMPT = [5, 9, 11, 3, 7]
TOL_TRAIN = 1e-5    # fine-tune losses (relative) and factors (abs), f32
TOL_MERGE = 1e-6    # merged kernels and gathered deltas, f32, max-abs
ENGINE_KW = dict(n_slots=4, chunk_tokens=4, kv_page_size=16, max_queue=64)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    """(reference config, port config, wide-gap base params): wide gaps
    so two implementations' argmax agree wherever the oracle's does."""
    cfg_r = ref.TransformerConfig(**TINY, dtype=jnp.float32)
    params = ref.TransformerLM(cfg_r).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return cfg_r, port.TransformerConfig(**TINY, dtype="float32"), \
        wide_gap(_np_tree(params))


@pytest.fixture(scope="module")
def artifacts(tiny, tmp_path_factory):
    """Three exported rank-4 adapters (both factors random, so they change
    the model), written by the PORT's exporter, and their merged-weights
    params."""
    cfg_r, cfg_p, params = tiny
    root = tmp_path_factory.mktemp("adapters")
    sources, flats, merged = {}, {}, {}
    for i, name in enumerate(TENANTS):
        fl = ad.random_lora_flat(cfg_p, RANK, seed=11 * (i + 1))
        flats[name] = fl
        sources[name] = port_export.export_adapter(
            str(root / name), name, cfg_p, fl, RANK, ALPHA)
        merged[name] = ad.merge_lora_params(params, fl, RANK, ALPHA)
    return sources, flats, merged


@pytest.fixture(scope="module")
def oracle(tiny, artifacts):
    """Greedy tokens of the port's LMGenerator on each merged tree ("" =
    the base), after asserting the argmax gaps on the path."""
    _, cfg_p, params = tiny
    _, _, merged = artifacts
    trees = dict(merged, **{"": params})
    gens = {k: LMGenerator(cfg_p, p, device="cpu") for k, p in trees.items()}
    seen = {}

    def want(name, prompt, n):
        key = (name, tuple(prompt), n)
        if key not in seen:
            assert recompute(cfg_p, trees[name], prompt, n)[1] > MIN_GAP
            seen[key] = gens[name].generate([prompt], max_new_tokens=n)[0]
        return seen[key]

    return want


@pytest.fixture(scope="module")
def engine(tiny, artifacts):
    """The shared adapter engine: 3 adapters over 2 slots (LRU paging),
    prefix cache on."""
    _, cfg_p, params = tiny
    sources, _, _ = artifacts
    eng = DecodeEngine(cfg_p, params, name="lm", adapters=sources,
                       adapter_slots=2, device="cpu", **ENGINE_KW)
    yield eng
    eng.close()


@pytest.fixture(scope="module")
def ref_tokens(tiny, artifacts):
    """Greedy tokens of the JAX DecodeEngine over the same artifacts (the
    port's files: the reference reads them), one request at a time."""
    cfg_r, _, params = tiny
    sources, _, _ = artifacts
    eng = ref_engine.DecodeEngine(cfg_r, params, name="ref",
                                  adapters=sources, adapter_slots=2,
                                  **ENGINE_KW)
    seen = {}

    def want(name, prompt, n):
        key = (name, tuple(prompt), n)
        if key not in seen:
            seen[key] = eng.generate([prompt], max_new_tokens=n,
                                     adapter=name)[0]
        return seen[key]

    yield want
    eng.close()


class TestLoRATraining:
    def test_finetune_matches_reference(self, tiny):
        """Three steps of both tuners (the default learning rate) from
        the JAX tuner's initial factors: losses within 1e-5 relative,
        factors within 1e-5, the port's base bit-unchanged, and step 0's
        logits exactly the lora_rank=0 model's (B starts at zero)."""
        cfg_r, cfg_p, params = tiny
        rt = ref_lora.LoRAFineTuner(cfg_r, params, rank=RANK, alpha=ALPHA)
        pt = LoRAFineTuner(cfg_p, params, rank=RANK, alpha=ALPHA,
                           device="cpu", lora_init=_np_tree(rt.lora))
        before = {k: v.clone() for k, v in pt.base.items()}
        tokens = np.random.default_rng(3).integers(
            0, cfg_p.vocab_size, (4, 17))
        plain = port.TransformerLM(cfg_p, device="cpu")
        plain.load_state_dict(params_from_jax(params))
        with torch.no_grad():
            x = torch.from_numpy(tokens[:, :-1])
            assert torch.equal(pt.model(x), plain(x))
        for _ in range(3):
            want = rt.train_step(jnp.asarray(tokens, jnp.int32))
            got = pt.train_step(tokens)
            assert abs(got - want) <= TOL_TRAIN * abs(want), (got, want)
        assert all(torch.equal(before[k], v) for k, v in pt.base.items())
        assert all(not v.requires_grad for v in pt.base.values())
        want, got = rt.lora_flat(), pt.lora_flat()
        assert set(got) == set(want) == set(ad.LORA_TARGETS)
        for t in want:
            for leaf in "ab":
                np.testing.assert_allclose(got[t][leaf],
                                           np.asarray(want[t][leaf]),
                                           rtol=0, atol=TOL_TRAIN)
        assert any(np.abs(v["b"]).max() > 0 for v in got.values())
        # The merged oracle and the full tree agree with the reference's.
        for a, b in zip(jax.tree_util.tree_leaves(rt.merged_params()),
                        jax.tree_util.tree_leaves(pt.merged_params())):
            np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=1e-5)
        assert jax.tree_util.tree_structure(_np_tree(rt.params())) == \
            jax.tree_util.tree_structure(pt.params())

    def test_lora_forward_matches_reference(self, tiny):
        """The lora_rank model's logits against flax's on the same tree,
        with non-zero factors (1e-5 abs, f32)."""
        cfg_r, cfg_p, params = tiny
        rng = np.random.default_rng(4)
        lora = {"layers": {mod: {f"{n}_lora_{ab}": rng.normal(
            0, 0.05, (2, d_in, RANK) if ab == "a" else (2, RANK, d_out))
            .astype(np.float32) for t, (d_in, d_out) in
            ad.lora_target_dims(cfg_p).items() if t.startswith(mod)
            for n in [t.split(".")[1]] for ab in "ab"}
            for mod in ("attn", "mlp")}}
        tree = ad.graft_lora(params, lora)
        rc = ref.TransformerConfig(**TINY, dtype=jnp.float32,
                                   lora_rank=RANK, lora_alpha=ALPHA)
        pc = port.TransformerConfig(**TINY, dtype="float32",
                                    lora_rank=RANK, lora_alpha=ALPHA)
        x = rng.integers(0, 64, (2, 12))
        want = np.asarray(ref.TransformerLM(rc).apply(
            {"params": tree}, jnp.asarray(x, jnp.int32)))
        model = port.TransformerLM(pc, device="cpu")
        model.load_state_dict(params_from_jax(tree))
        with torch.no_grad():
            got = model(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        back = params_to_jax(model.state_dict())
        for (pa, a), (pb, b) in zip(
                sorted(jax.tree_util.tree_leaves_with_path(tree),
                       key=lambda t: jax.tree_util.keystr(t[0])),
                sorted(jax.tree_util.tree_leaves_with_path(back),
                       key=lambda t: jax.tree_util.keystr(t[0]))):
            assert jax.tree_util.keystr(pa) == jax.tree_util.keystr(pb)
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()

    def test_refusals_match_reference(self, tiny):
        cfg_r, cfg_p, params = tiny
        for pkg, cfg in ((ref_lora.LoRAFineTuner, cfg_r),
                         (LoRAFineTuner, cfg_p)):
            kw = {} if pkg is ref_lora.LoRAFineTuner else {"device": "cpu"}
            with pytest.raises(ValueError, match="rank must be"):
                pkg(cfg, params, rank=0, **kw)
        moe = port.TransformerConfig(**TINY, n_experts=2)
        with pytest.raises(ValueError, match="MoE"):
            LoRAFineTuner(moe, params, device="cpu")

    def test_artifact_bytes_and_cross_loading(self, tiny, tmp_path):
        """The same flat tree (random_lora_flat: byte-equal in both
        packages) gives byte-equal files from both exporters, and each
        package's loader reads the other's artifact."""
        cfg_r, cfg_p, _ = tiny
        fl_r = ref_ad.random_lora_flat(cfg_r, RANK, seed=1)
        fl_p = ad.random_lora_flat(cfg_p, RANK, seed=1)
        for t in fl_r:
            for leaf in "ab":
                assert fl_p[t][leaf].tobytes() == \
                    np.asarray(fl_r[t][leaf]).tobytes()
        dr = ref_export.export_adapter(str(tmp_path / "r"), "a", cfg_r,
                                       fl_r, RANK, ALPHA)
        dp = port_export.export_adapter(str(tmp_path / "p"), "a", cfg_p,
                                        fl_p, RANK, ALPHA)
        for f in (port_export.ADAPTER_CONFIG_FILE, "params.msgpack"):
            with open(os.path.join(dr, f), "rb") as a, \
                    open(os.path.join(dp, f), "rb") as b:
                assert a.read() == b.read(), f
        assert port_export.ADAPTER_FORMAT_VERSION == \
            ref_export.ADAPTER_FORMAT_VERSION
        for load, d in ((port_export.load_adapter, dr),
                        (ref_export.load_adapter, dp)):
            meta, got = load("file://" + d)
            assert meta["kind"] == "lora_adapter" and meta["rank"] == RANK
            assert meta["alpha"] == ALPHA
            for t in fl_p:
                for leaf in "ab":
                    assert np.asarray(got[t][leaf]).tobytes() == \
                        fl_p[t][leaf].tobytes()
        assert port_export.peek_adapter_rank(dr) == RANK
        with pytest.raises((ValueError, OSError)):
            port_export.load_adapter(str(tmp_path))

    def test_merge_matches_reference(self, tiny, artifacts):
        cfg_r, _, params = tiny
        _, flats, merged = artifacts
        want = ref_ad.merge_lora_params(params, flats["alice"], RANK, ALPHA)
        for a, b in zip(jax.tree_util.tree_leaves(want),
                        jax.tree_util.tree_leaves(merged["alice"])):
            np.testing.assert_allclose(b, np.asarray(a), rtol=0,
                                       atol=TOL_MERGE)

    def test_gather_delta_matches_reference(self):
        """Each row its own slot, -1 rows exactly zero."""
        rng = np.random.default_rng(7)
        entry = {"a": rng.normal(0, 0.3, (3, 32, RANK)).astype(np.float32),
                 "b": rng.normal(0, 0.3, (3, RANK, 48)).astype(np.float32)}
        x = rng.normal(size=(5, 6, 32)).astype(np.float32)
        ids = np.array([2, -1, 0, 1, -1])
        want = np.asarray(ref.lora_gather_delta(
            jnp.asarray(x), {k: jnp.asarray(v) for k, v in entry.items()},
            jnp.asarray(ids, jnp.int32), jnp.float32))
        got = port.lora_gather_delta(
            torch.from_numpy(x),
            {k: torch.from_numpy(v) for k, v in entry.items()},
            torch.from_numpy(ids), torch.float32).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL_MERGE)
        assert not got[ids < 0].any()

    def test_split_and_graft_match_reference(self, tiny):
        cfg_r, _, params = tiny
        tuner = ref_lora.LoRAFineTuner(cfg_r, params, rank=RANK)
        full = _np_tree(tuner.params())
        base_r, lora_r = ref_ad.split_lora_tree(full)
        base_p, lora_p = ad.split_lora_tree(full)
        for a, b in ((base_r, base_p), (lora_r, lora_p)):
            assert jax.tree_util.tree_structure(a) == \
                jax.tree_util.tree_structure(b)
        regraft = ad.graft_lora(base_p, lora_p)
        assert jax.tree_util.tree_structure(regraft) == \
            jax.tree_util.tree_structure(full)
        assert set(ad.extract_lora(full)) == set(ref_ad.extract_lora(full))


class TestAdapterEngine:
    def test_single_adapter_equals_merged_oracle(self, engine, oracle,
                                                 ref_tokens):
        """Greedy tokens wearing one adapter equal the merged-weights
        oracle's and the JAX engine's; a base request through the same
        engine equals the base oracle's."""
        out = engine.generate([PROMPT], max_new_tokens=12, adapter="alice")
        assert out == [oracle("alice", PROMPT, 12)]
        assert out[0] == ref_tokens("alice", PROMPT, 12)
        out = engine.generate([PROMPT], max_new_tokens=12)
        assert out == [oracle("", PROMPT, 12)]

    def test_base_rows_equal_adapterless_engine(self, tiny, engine):
        _, cfg_p, params = tiny
        plain = DecodeEngine(cfg_p, params, name="plain", device="cpu",
                             **ENGINE_KW)
        try:
            prompts = [PROMPT, [2, 30], [40, 41, 42, 43]]
            assert engine.generate(prompts, max_new_tokens=10,
                                   adapter="") == \
                plain.generate(prompts, max_new_tokens=10)
        finally:
            plain.close()

    def test_mixed_batch_every_slot_its_own_adapter(self, engine, oracle,
                                                    ref_tokens):
        reqs = [engine.submit(PROMPT, max_new_tokens=12, adapter=nm)
                for nm in ("alice", "bob", "")]
        for nm, r in zip(("alice", "bob", ""), reqs):
            toks = r.result(60)
            assert toks == oracle(nm, PROMPT, 12), nm
            assert toks == ref_tokens(nm, PROMPT, 12), nm

    def test_lru_paging_matches_reference(self, tiny, artifacts):
        """The same request sequence over 2 slots: loads and evictions
        after every request equal the JAX engine's."""
        cfg_r, cfg_p, params = tiny
        sources, _, _ = artifacts
        kw = dict(ENGINE_KW, n_slots=2)
        pe = DecodeEngine(cfg_p, params, name="lru", adapters=sources,
                          adapter_slots=2, device="cpu", **kw)
        re_ = ref_engine.DecodeEngine(cfg_r, params, name="lru",
                                      adapters=sources, adapter_slots=2,
                                      **kw)
        try:
            for nm in ("alice", "bob", "carol", "alice", "alice", "bob",
                       "carol"):
                got = pe.generate([PROMPT], max_new_tokens=4, adapter=nm)
                want = re_.generate([PROMPT], max_new_tokens=4,
                                    adapter=nm)
                assert got == want, nm
                assert pe.adapter_stats() == re_.adapter_stats(), nm
            assert pe.adapter_stats()["evictions"] >= 3
            assert pe._apool.loaded() == re_._apool.loaded()
        finally:
            pe.close()
            re_.close()

    def test_unknown_adapter_and_bad_config(self, tiny, engine, artifacts):
        _, cfg_p, params = tiny
        sources, _, _ = artifacts
        with pytest.raises(ValueError, match="unknown adapter"):
            engine.generate([PROMPT], max_new_tokens=4, adapter="nope")
        for kw, msg in ((dict(adapter_default="zed", adapters=sources),
                         "adapter_default"),
                        (dict(adapter_default="alice"), "adapter_default"),
                        (dict(adapters=sources, adapter_fallback="x"),
                         "adapter_fallback"),
                        (dict(adapters=sources, adapter_slots=0),
                         "adapter_slots")):
            with pytest.raises(ValueError, match=msg):
                DecodeEngine(cfg_p, params, device="cpu", **kw).close()

    def test_metric_families_seed_pre_traffic(self, tiny, artifacts):
        """The adapter families show before any traffic, with the
        reference's text, and a base-only engine has none of them."""
        cfg_r, cfg_p, params = tiny
        sources, _, _ = artifacts

        def adapter_lines(text):
            return [ln for ln in text.splitlines() if "kfx_lm_adapter" in ln]

        reg, rreg = MetricsRegistry(), RefRegistry()
        eng = DecodeEngine(cfg_p, params, n_slots=2, chunk_tokens=4,
                           name="pre", kv_page_size=16, adapters=sources,
                           adapter_slots=2, registry=reg, device="cpu")
        reng = ref_engine.DecodeEngine(
            cfg_r, params, n_slots=2, chunk_tokens=4, name="pre",
            kv_page_size=16, adapters=sources, adapter_slots=2,
            registry=rreg)
        try:
            got = adapter_lines(reg.render())
            assert got == adapter_lines(rreg.render())
            assert len(got) == 18   # six families: HELP, TYPE, sample
        finally:
            eng.close()
            reng.close()
        reg2 = MetricsRegistry()
        DecodeEngine(cfg_p, params, n_slots=2, name="plain",
                     kv_page_size=16, registry=reg2, device="cpu").close()
        assert not adapter_lines(reg2.render())

    def test_prefix_cache_chains_per_adapter(self, tiny, artifacts):
        """The same multi-page prompt under two adapters shares no page;
        under one adapter it hits (and the tokens stay the oracle's)."""
        _, cfg_p, params = tiny
        sources, _, _ = artifacts
        eng = DecodeEngine(cfg_p, params, name="px", adapters=sources,
                           adapter_slots=2, device="cpu", **ENGINE_KW)
        long_p = [(7 * i + 3) % 60 for i in range(40)]
        try:
            a1 = eng.generate([long_p], max_new_tokens=6, adapter="alice")
            assert eng.prefix_stats()["hits"] == 0
            eng.generate([long_p], max_new_tokens=6, adapter="bob")
            assert eng.prefix_stats()["hits"] == 0
            eng.generate([long_p], max_new_tokens=6)
            assert eng.prefix_stats()["hits"] == 0
            a2 = eng.generate([long_p], max_new_tokens=6, adapter="alice")
            st = eng.prefix_stats()
            assert st["hits"] == 1 and st["tokens_reused"] >= 32
            assert a1 == a2
        finally:
            eng.close()


@pytest.fixture(scope="module")
def spec_chunk_engine(tiny, artifacts):
    """Speculation (a 1-layer draft wearing the truncated stacks), chunked
    prefill (16-token chunks) and a small pool that recycles pages."""
    _, cfg_p, params = tiny
    sources, _, _ = artifacts
    eng = DecodeEngine(cfg_p, params, n_slots=3, chunk_tokens=4,
                       name="spec", kv_page_size=16, kv_pages=12,
                       draft_layers=1, propose_tokens=3,
                       prefill_chunk_tokens=16, adapters=sources,
                       adapter_slots=2, device="cpu")
    yield eng
    eng.close()


class TestAdapterMachineryComposition:
    def test_speculative_adapter_parity(self, spec_chunk_engine, oracle,
                                        ref_tokens):
        eng = spec_chunk_engine
        st0 = eng.spec_stats()
        out = eng.generate([PROMPT], max_new_tokens=12, adapter="alice")
        assert out == [oracle("alice", PROMPT, 12)]
        assert out[0] == ref_tokens("alice", PROMPT, 12)
        assert eng.spec_stats()["proposed"] > st0["proposed"]

    def test_chunked_prefill_long_prompt_parity(self, spec_chunk_engine,
                                                oracle, ref_tokens):
        long_p = [int(t) for t in
                  np.random.default_rng(5).integers(0, 64, 40)]
        out = spec_chunk_engine.generate([long_p], max_new_tokens=10,
                                         adapter="bob")
        assert out == [oracle("bob", long_p, 10)]
        assert out[0] == ref_tokens("bob", long_p, 10)

    def test_recycle_waves_stay_exact(self, spec_chunk_engine, oracle):
        want = oracle("alice", PROMPT, 8)
        for _ in range(2):
            got = spec_chunk_engine.generate(
                [PROMPT, PROMPT], max_new_tokens=8, adapter="alice")
            assert got == [want, want]
        st = spec_chunk_engine.adapter_stats()
        assert st["free"] == st["slots"]   # every pin released


class TestAdapterChaos:
    def test_adapter_load_fallback_base_then_heals(self, tiny, artifacts,
                                                   oracle):
        """fallback=base: the request serves the BASE (counted), its pages
        chain with base traffic, and once the budget is spent the adapter
        pages in and the tokens are the adapter's."""
        _, cfg_p, params = tiny
        sources, _, _ = artifacts
        long_p = [int(t) for t in
                  np.random.default_rng(21).integers(0, 64, 40)]
        reg = MetricsRegistry()
        chaos.install(chaos.ChaosPlan(
            [chaos.Rule("engine.adapter_load", p=1.0, count=1)], seed=1))
        eng = DecodeEngine(cfg_p, params, n_slots=2, chunk_tokens=4,
                           name="fb", kv_page_size=16, adapters=sources,
                           adapter_slots=1, adapter_fallback="base",
                           registry=reg, device="cpu")
        try:
            out = eng.generate([long_p], max_new_tokens=8, adapter="alice")
            assert out == [oracle("", long_p, 8)]
            assert reg.counter("kfx_lm_adapter_fallbacks_total"
                               ).samples() == [({"model": "fb"}, 1)]
            out = eng.generate([long_p], max_new_tokens=8, adapter="alice")
            assert out == [oracle("alice", long_p, 8)]
        finally:
            eng.close()
            chaos.install(None)

    def test_adapter_load_fallback_error_sheds_503(self, tiny, artifacts):
        _, cfg_p, params = tiny
        sources, _, _ = artifacts
        chaos.install(chaos.ChaosPlan(
            [chaos.Rule("engine.adapter_load", p=1.0, count=1)], seed=1))
        eng = DecodeEngine(cfg_p, params, n_slots=2, chunk_tokens=4,
                           name="er", kv_page_size=16, adapters=sources,
                           adapter_slots=1, adapter_fallback="error",
                           device="cpu")
        try:
            with pytest.raises(AdapterLoadError) as exc:
                eng.generate([PROMPT], max_new_tokens=8, adapter="alice")
            assert isinstance(exc.value, EngineOverloaded)
            assert len(eng.generate([PROMPT], max_new_tokens=4)[0]) == 4
            assert eng.adapter_stats()["free"] == 1
        finally:
            eng.close()
            chaos.install(None)


class TestFairness:
    def test_fair_queue_is_the_engines(self):
        """adapters.FairQueue is the engine's queue (one copy), and it
        pops in the reference's order."""
        from kubeflow_tpu_torch.serving import engine as eng_mod

        assert ad.FairQueue is eng_mod.FairQueue

        class R:
            def __init__(self, a):
                self.adapter = a

        for make in (ad.FairQueue, ref_ad.FairQueue):
            q = make(weights={"A": 3})
            for a in "AAAAAABB":
                q.push(R(a))
            q.push_front(R("F"))
            got = [q.pop().adapter for _ in range(9)]
            assert got == ["F", "A", "A", "A", "B", "A", "A", "A", "B"]

    def test_minority_tenant_p99_bounded_under_burst(self, engine):
        """A 10:1 burst on one adapter while another trickles: the
        minority tenant's p99 (enqueue to done) stays within 3x its
        uncontended value (the reference's bar)."""
        rng = np.random.default_rng(9)
        b_prompt = [int(t) for t in rng.integers(0, 64, 6)]

        def b_round(n):
            lat = []
            for i in range(n):
                t0 = time.monotonic()
                engine.submit(b_prompt, max_new_tokens=12, adapter="bob",
                              seed=100 + i).result(60)
                lat.append(time.monotonic() - t0)
            return sorted(lat)

        base_p99 = b_round(6)[-1]
        burst = [engine.submit([int(t) for t in rng.integers(0, 64, 6)],
                               max_new_tokens=12, adapter="alice", seed=i)
                 for i in range(30)]
        contended = b_round(6)
        for r in burst:
            r.result(120)
        # The reference's sanity checks: the burst was really served, and
        # the adapters really paged (3 over 2 slots).
        assert burst[-1].t_done >= 0.0
        assert contended[-1] <= 3.0 * max(base_p99, 0.01), (
            f"minority p99 {contended[-1]:.3f}s vs uncontended "
            f"{base_p99:.3f}s")
        assert engine.adapter_stats()["loads"] >= 2


class TestAcceptanceHBM:
    def test_8_concurrent_adapters_one_engine(self, tiny, tmp_path):
        """Eight adapters in one wave, every slot its own, and the engine's
        device bytes within 1.5x a base-only engine's."""
        _, cfg_p, params = tiny
        sources = {f"t{i}": port_export.export_adapter(
            str(tmp_path / f"t{i}"), f"t{i}", cfg_p,
            ad.random_lora_flat(cfg_p, 2, seed=50 + i), 2, 4.0)
            for i in range(8)}
        base = DecodeEngine(cfg_p, params, n_slots=8, chunk_tokens=4,
                            name="b8", kv_page_size=16, device="cpu")
        eng = DecodeEngine(cfg_p, params, n_slots=8, chunk_tokens=4,
                           name="a8", kv_page_size=16, adapters=sources,
                           adapter_slots=8, adapter_rank=2, device="cpu")
        try:
            reqs = [eng.submit(PROMPT, max_new_tokens=8, adapter=f"t{i}")
                    for i in range(8)]
            assert all(len(r.result(120)) == 8 for r in reqs)
            assert eng.adapter_stats()["loads"] == 8
            hb = eng.hbm_bytes()
            assert hb["adapters"] == eng._apool.nbytes() > 0
            ratio = hb["total"] / base.hbm_bytes()["total"]
            assert ratio <= 1.5, ratio
        finally:
            eng.close()
            base.close()


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def lm_export(tiny, tmp_path_factory):
    _, cfg_p, params = tiny
    d = str(tmp_path_factory.mktemp("lm"))
    lm_server.export_lm(d, cfg_p, params)
    return d


def test_server_adapter_field(lm_export, artifacts, oracle, monkeypatch):
    """KFX_LM_ADAPTERS behind the V1 server: the body field selects the
    adapter (absent = the default, "" = the base), an unknown name or a
    non-string is a 400, /metrics carries the adapter families with the
    tenant's requests counted, and the JSON engine block the slots."""
    sources, _, _ = artifacts
    monkeypatch.setenv("KFX_LM_ADAPTERS", json.dumps(
        {k: "file://" + v for k, v in sources.items()}))
    monkeypatch.setenv("KFX_LM_ADAPTER_DEFAULT", "alice")
    monkeypatch.setenv("KFX_LM_ADAPTER_SLOTS", "2")
    monkeypatch.setenv("KFX_LM_SPEC", "0")
    p = lm_server.LMPredictor(lm_export, name="lm", device="cpu",
                              warm_buckets=[8])
    p.load()
    srv = port_server.ModelServer(port=0)
    srv.register(p)
    srv.start()
    url = f"http://127.0.0.1:{srv.port}"
    gen = f"{url}/v1/models/lm:generate"
    try:
        one = {"prompt_tokens": [PROMPT], "max_new_tokens": 8}
        for body, name in ((one, "alice"), (dict(one, adapter="bob"), "bob"),
                           (dict(one, adapter=""), "")):
            code, out = _post(gen, body)
            assert code == 200, out
            assert out["generated_tokens"] == [oracle(name, PROMPT, 8)]
        for body, msg in ((dict(one, adapter="nope"), "unknown adapter"),
                          (dict(one, adapter=3), "adapter must be")):
            code, out = _post(gen, body)
            assert code == 400 and msg in out["error"], out
        with urllib.request.urlopen(f"{url}/metrics") as r:
            text = r.read().decode()
        for fam in ("kfx_lm_adapter_slots", "kfx_lm_adapter_loads_total",
                    "kfx_lm_adapter_fallbacks_total"):
            assert fam in text, fam
        counted = [ln for ln in text.splitlines()
                   if ln.startswith("kfx_lm_adapter_requests_total{")]
        assert 'kfx_lm_adapter_requests_total{model="lm",adapter="bob"} 1' \
            in counted, counted
        assert 'kfx_tenant_requests_total{tenant="alice",qos="interactive",' \
            'adapter="alice"}' in text
        with urllib.request.urlopen(f"{url}/metrics?format=json") as r:
            blk = json.loads(r.read())["engine"]["lm"]
        assert blk["adapter_slots"] == 2 and blk["adapter_slots_free"] == 2
    finally:
        srv.stop()
        p.close()
