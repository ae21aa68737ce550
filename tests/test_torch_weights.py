"""The port's multi-model weight pool (kubeflow_tpu_torch/serving/
weights.py, the DecodeEngine's per-request model selection with grouped
dispatch, the LM server's KFX_LM_MODELS and the V1 server's pooled
readiness and ``:evict``) against the reference's
(kubeflow_tpu/serving/weights.py and engine.py), on tests/test_weights.py's
tiny fixture (vocab 64, d 32, H 2, D 16, L 2, d_ff 64, max_seq_len 64,
f32) on the CPU.

Every export is written by the JAX package's ``export_lm`` and fed to
both pools: m0/m1/m2 f32 (distinct seeds), q8 an int8 export and v1 an
f32 export rewritten to the v1 on-disk format. Their weights are wide-gap
(tests/test_torch_generate.py ``wide_gap``), and every cross-framework
greedy comparison asserts the top-1/top-2 gap on its path first.

  * pool units (tests/test_weights.py TestWeightPoolUnit): the JAX pool and
    the port's driven through the same acquire/release/evict sequences
    with identical slot ids, refcounts, LRU victims, loads, evictions,
    generations and error classes; the port's slot weights byte-equal to
    the JAX pool's tree after evict-then-reload, and v1, v2 and int8
    exports normalized into an f32 pool equal to the JAX pool's trees
    (tolerance 0); the ``weights.load`` chaos point; the metric families
    seeded before any swap;
  * ``PrefixCache.drop_root`` on both packages;
  * the engine: per-model greedy tokens equal across the packages and
    byte-equal to dedicated port engines and the port's LMGenerator, a
    concurrent mixed batch of 3 models over 2 weight slots, evict then
    reload, model-selection errors, the constructor's exclusions, the idle
    sweep on a parked engine, the migrate and import refusals, and the
    grouped-dispatch invariant (a foreign group's run leaves a masked
    row's pending logits and KV untouched);
  * the server: LMPredictor with KFX_LM_MODELS behind the port's
    ModelServer, each answer's status and keys equal to the reference
    server's answer to the same call."""

import json
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
from kubeflow_tpu.obs.metrics import MetricsRegistry as RefRegistry  # noqa: E402,E501
from kubeflow_tpu.serving import engine as ref_engine  # noqa: E402
from kubeflow_tpu.serving import weights as ref_w  # noqa: E402
from kubeflow_tpu.serving.lm_server import CONFIG_FILE, export_lm  # noqa: E402,E501
from kubeflow_tpu_torch import chaos  # noqa: E402
from kubeflow_tpu_torch.models import transformer as port  # noqa: E402
from kubeflow_tpu_torch.models.convert import params_to_jax  # noqa: E402
from kubeflow_tpu_torch.models.generate import (  # noqa: E402
    LMGenerator, decode_config, load_decode_model)
from kubeflow_tpu_torch.obs.metrics import MetricsRegistry  # noqa: E402
from kubeflow_tpu_torch.serving import kvtransfer  # noqa: E402
from kubeflow_tpu_torch.serving import weights as port_w  # noqa: E402
from kubeflow_tpu_torch.serving.engine import (  # noqa: E402
    BlockManager, DecodeEngine, PageAllocError, PrefixCache,
    WeightLoadError, WeightSlotError)

from test_torch_generate import MIN_GAP, TINY, recompute, wide_gap  # noqa: E402,E501

PROMPT = [5, 9, 11, 3, 7]
MODELS = ("m0", "m1", "m2")
ENGINE_KW = dict(n_slots=4, chunk_tokens=4, kv_page_size=16, max_queue=64)


@pytest.fixture(scope="module")
def tiny():
    """(reference config, port config)."""
    cfg_r = ref.TransformerConfig(**TINY, dtype=jnp.float32)
    return cfg_r, port.TransformerConfig(**TINY, dtype="float32")


def _init(cfg_r, seed):
    p = ref.TransformerLM(cfg_r).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    return wide_gap(jax.tree_util.tree_map(np.asarray, p))


@pytest.fixture(scope="module")
def exports(tiny, tmp_path_factory):
    """Five exports of one architecture, written by the JAX export_lm from
    wide-gap trees: m0/m1/m2 f32 (seeds 100-102), q8 int8 (103) and v1
    (104) rewritten to the v1 format (no format_version, no quant).
    Returns (sources, trees)."""
    cfg_r, _ = tiny
    root = tmp_path_factory.mktemp("models")
    sources, trees = {}, {}
    for i, name in enumerate(MODELS + ("q8", "v1")):
        trees[name] = _init(cfg_r, 100 + i)
        sources[name] = export_lm(str(root / name), cfg_r, trees[name],
                                  quantize="int8" if name == "q8" else "")
    meta_path = root / "v1" / CONFIG_FILE
    meta = json.loads(meta_path.read_text())
    meta.pop("format_version", None)
    meta.pop("quant", None)
    meta["config"].pop("quant", None)
    meta_path.write_text(json.dumps(meta))
    return sources, trees


@pytest.fixture(scope="module")
def oracle(tiny, exports):
    """Greedy tokens of the port's LMGenerator on each model's tree, after
    asserting the argmax gaps on the path."""
    _, cfg_p = tiny
    _, trees = exports
    gens, seen = {}, {}

    def want(name, prompt=PROMPT, n=8):
        key = (name, tuple(prompt), n)
        if key not in seen:
            assert recompute(cfg_p, trees[name], prompt, n)[1] > MIN_GAP
            if name not in gens:
                gens[name] = LMGenerator(cfg_p, trees[name], device="cpu")
            seen[key] = gens[name].generate([prompt], max_new_tokens=n)[0]
        return seen[key]

    return want


# -- pool units ---------------------------------------------------------------

class Twin:
    """The JAX pool and the port's pool driven by the same calls: each
    call's outcome (value, or error class and message) and the host
    bookkeeping after it must be identical."""

    def __init__(self, tiny, exports, names, n_slots, **kw):
        cfg_r, cfg_p = tiny
        sources, trees = exports
        src = {n: sources[n] for n in names}
        rreg, reg = kw.pop("ref_registry", None), kw.pop("registry", None)
        self.ref = ref_w.WeightPool(cfg_r, trees["m0"], n_slots, src,
                                    registry=rreg, **kw)
        self.port = port_w.WeightPool(decode_config(cfg_p), trees["m0"],
                                      n_slots, src, device="cpu",
                                      registry=reg, **kw)
        self.cfg_p = cfg_p

    @staticmethod
    def state(pool):
        return {"loads": pool.loads, "evictions": pool.evictions,
                "ref": pool.ref.tolist(), "pinned": pool.pinned.tolist(),
                "loaded": pool.loaded(), "n_free": pool.n_free,
                "free": list(pool._free), "lru": list(pool._lru.items()),
                "roots": {n: pool.root(s)
                          for n, s in pool._by_name.items()}}

    def __call__(self, op, *args):
        outs = []
        for pool in (self.ref, self.port):
            try:
                v = getattr(pool, op)(*args)
                outs.append(("ok", v.item() if hasattr(v, "item") else v))
            except Exception as e:  # noqa: BLE001 — compared below
                outs.append((type(e).__name__, str(e)))
        assert outs[0] == outs[1], (op, args, outs)
        assert self.state(self.ref) == self.state(self.port), (op, args)
        return outs[1][1] if outs[1][0] == "ok" else outs[1]

    def adopt(self, name, tree, pin=False):
        a = self.ref.adopt(name, tree, pin=pin)
        b = self.port.adopt(name, load_decode_model(
            decode_config(self.cfg_p), tree, torch.device("cpu")), pin=pin)
        assert a == b and self.state(self.ref) == self.state(self.port)
        return b

    def port_tree(self, slot):
        return params_to_jax(self.port.module(slot).state_dict())


def _leaves(tree):
    return ref_w._tree_leaves_with_path(tree)


def _assert_trees_equal(got, want):
    g, w = _leaves(got), _leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (p, a), (_, b) in zip(g, w):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, p
        assert a.tobytes() == b.tobytes(), p


class TestWeightPoolUnit:
    def test_acquire_hit_miss_refcounts(self, tiny, exports):
        t = Twin(tiny, exports, MODELS, 2)
        s1 = t("acquire", "m1")
        assert t.port.loads == 1 and t.port.ref[s1] == 1
        assert t("acquire", "m1") == s1      # warm hit: no second read
        assert t.port.loads == 1 and t.port.ref[s1] == 2
        t("release", s1)
        t("release", s1)
        assert t.port.n_free == 2

    def test_lru_evicts_the_coldest_idle_model(self, tiny, exports):
        t = Twin(tiny, exports, MODELS, 2)
        for name in ("m1", "m2", "m0"):
            t("release", t("acquire", name))
        assert t.port.loaded() == ["m0", "m2"] and t.port.evictions == 1

    def test_file_uri_sources_resolve(self, tiny, exports):
        sources, _ = exports
        t = Twin(tiny, ({"m1": "file://" + sources["m1"]}, exports[1]),
                 ("m1",), 2)
        t("release", t("acquire", "m1"))
        assert t.port.loaded() == ["m1"] and t.port.loads == 1

    def test_inflight_and_pinned_slots_are_never_victims(self, tiny,
                                                         exports):
        t = Twin(tiny, exports, MODELS, 2)
        t.adopt("base", exports[1]["m0"], pin=True)
        s1 = t("acquire", "m1")
        err = t("acquire", "m2")
        assert err[0] == "WeightSlotError"
        assert t("acquire", "m1") == s1 and t.port.ref[s1] == 2
        t("release_all")
        assert t.port.ref[s1] == 0 and bool(t.port.pinned[0])
        t("release", t("acquire", "m2"))
        assert "base" in t.port.loaded()
        assert t("evict_model", "base") is False
        # Pool pressure is page pressure: the engine requeues on it.
        t("acquire", "m1")
        with pytest.raises(WeightSlotError):
            t.port.acquire("m0")
        assert issubclass(WeightSlotError, PageAllocError)

    def test_evict_model_refuses_while_worn(self, tiny, exports):
        t = Twin(tiny, exports, MODELS, 2)
        s1 = t("acquire", "m1")
        assert t("evict_model", "m1") is False
        t("release", s1)
        assert t("evict_model", "m1") is True
        assert t("evict_model", "m1") is False
        assert t.port.loaded() == []

    def test_idle_sweep_is_scale_to_zero(self, tiny, exports):
        t = Twin(tiny, exports, MODELS, 3)
        t("release", t("acquire", "m1"))
        t("release", t("acquire", "m2"))
        s0 = t("acquire", "m0")
        for pool in (t.ref, t.port):
            for name in ("m1", "m2"):
                pool._last_used[pool._by_name[name]] -= 60.0
        assert t("evict_idle", 30.0, "m2") == ["m1"]
        assert t.port.loaded() == ["m0", "m2"]
        t("release", s0)
        assert t("evict_idle", 0.0) == []

    def test_unknown_model_is_a_load_error(self, tiny, exports):
        t = Twin(tiny, exports, MODELS, 2)
        assert t("acquire", "nope") == ("WeightLoadError",
                                        "unknown model 'nope'")
        with pytest.raises(WeightLoadError, match="unknown model"):
            t.port.acquire("nope")

    def test_evict_then_reload_is_byte_identical_fresh_generation(
            self, tiny, exports):
        _, trees = exports
        dropped = {"ref": [], "port": []}
        t = Twin(tiny, exports, MODELS, 2)
        t.ref.on_evict = lambda n, r: dropped["ref"].append((n, r))
        t.port.on_evict = lambda n, r: dropped["port"].append((n, r))
        s1 = t("acquire", "m1")
        root1 = t.port.root(s1)
        _assert_trees_equal(t.port_tree(s1), t.ref.tree(s1))
        t("release", s1)
        assert t("evict_model", "m1")
        assert t.port.module(s1) is None
        assert dropped["port"] == dropped["ref"] == [("m1", root1)]
        s1b = t("acquire", "m1")
        # The reload equals the JAX pool's tree and the export bit for
        # bit, under a FRESH generation.
        _assert_trees_equal(t.port_tree(s1b), t.ref.tree(s1b))
        _assert_trees_equal(t.port_tree(s1b), trees["m1"])
        assert t.port.root(s1b) != root1
        assert t.port.root(s1b).startswith(b"m1@")

    def test_v1_v2_and_int8_exports_coexist(self, tiny, exports):
        """One f32 pool admits v1, v2 f32 and int8 exports: each slot's
        normalized tree equals the JAX pool's, tolerance 0 (the int8
        export dequantized at load by both)."""
        _, trees = exports
        t = Twin(tiny, exports, ("v1", "m1", "q8"), 3)
        slots = {n: t("acquire", n) for n in ("v1", "m1", "q8")}
        assert t.port.loaded() == ["m1", "q8", "v1"]
        for name, s in slots.items():
            _assert_trees_equal(t.port_tree(s), t.ref.tree(s))
        for name in ("v1", "m1"):
            _assert_trees_equal(t.port_tree(slots[name]), trees[name])
        got = dict(_leaves(t.port_tree(slots["q8"])))
        for p, w in _leaves(trees["q8"]):
            assert got[p].dtype == np.float32
            np.testing.assert_allclose(got[p], w, atol=0.05)

    def test_signature_mismatch_is_a_load_error(self, tiny, exports,
                                                tmp_path):
        """A pooled export of another architecture fails its swap with the
        reference's message (the slot returns to the free list)."""
        cfg_r, _ = tiny
        sources, _ = exports
        wide = ref.TransformerConfig(**dict(TINY, d_ff=128),
                                     dtype=jnp.float32)
        p = ref.TransformerLM(wide).init(
            jax.random.PRNGKey(9), jnp.zeros((1, 8), jnp.int32))["params"]
        src = dict(sources, wide=export_lm(str(tmp_path / "w"), wide, p))
        t = Twin(tiny, (src, exports[1]), ("m0", "wide"), 2)
        kind, msg = t("acquire", "wide")
        assert kind == "WeightLoadError" and "does not match pool" in msg
        assert t.port.n_free == 2 and t.port.loads == 0

    def test_state_dict_template_validates_like_a_tree(self, tiny,
                                                       exports):
        """The engine takes its params as a reference tree or a port
        state_dict: a pool templated on either holds the same signature
        and pages the same exports in."""
        from kubeflow_tpu_torch.models.convert import params_from_jax

        _, cfg_p = tiny
        sources, trees = exports
        src = {n: sources[n] for n in MODELS}
        pools = [port_w.WeightPool(decode_config(cfg_p), t, 2, src,
                                   device="cpu")
                 for t in (trees["m0"], params_from_jax(trees["m0"]))]
        assert pools[0]._sig == pools[1]._sig
        assert pools[0]._sig == [(p, np.shape(x), np.asarray(x).dtype.name)
                                 for p, x in _leaves(trees["m0"])]
        pools[1].release(pools[1].acquire("m1"))
        assert pools[1].loaded() == ["m1"]

    def test_chaos_weights_load(self, tiny, exports):
        t = Twin(tiny, exports, MODELS, 2, name="lmx")
        ref_chaos.install(ref_chaos.ChaosPlan(
            [ref_chaos.Rule("weights.load", p=1.0, count=1)], seed=7))
        chaos.install(chaos.ChaosPlan(
            [chaos.Rule("weights.load", p=1.0, count=1)], seed=7))
        try:
            assert t("acquire", "m1") == ("WeightLoadError",
                                          "chaos[weights.load]: m1")
            assert t.port.loaded() == [] and t.port.n_free == 2
            t("release", t("acquire", "m1"))   # the budget is spent
            assert t.port.loads == 1
        finally:
            ref_chaos.install(None)
            chaos.install(None)
        chaos.install(chaos.ChaosPlan(
            [chaos.Rule("weights.load", p=1.0, count=1, delay=0.2,
                        mode="delay")], seed=7))
        try:
            t0 = time.perf_counter()
            t.port.release(t.port.acquire("m2"))
            assert time.perf_counter() - t0 >= 0.2
            assert t.port.loads == 2
        finally:
            chaos.install(None)

    def test_metric_families_seed_before_any_swap(self, tiny, exports):
        reg, rreg = MetricsRegistry(), RefRegistry()
        t = Twin(tiny, exports, MODELS, 2, name="lm", registry=reg,
                 ref_registry=rreg)

        def values(r):
            def one(metric, **labels):
                return dict((tuple(sorted(lab.items())), v)
                            for lab, v in metric.samples())[
                    tuple(sorted(dict(model="lm", **labels).items()))]

            out = {"slots": one(r.gauge("kfx_lm_weight_slots")),
                   "free": one(r.gauge("kfx_lm_weight_slots_free")),
                   "loads": one(r.counter("kfx_lm_weight_loads_total"))}
            for m in MODELS:
                out[m] = one(r.gauge("kfx_lm_weight_model_loaded"),
                             pooled=m)
            for reason in ("lru", "idle", "explicit"):
                out[reason] = one(r.counter("kfx_lm_weight_evictions_total"),
                                  reason=reason)
            return out

        t("touch")
        assert values(reg) == values(rreg)
        assert values(reg)["slots"] == 2 and values(reg)["m1"] == 0
        text = reg.render()
        for fam in ("kfx_lm_weight_swap_seconds",
                    "kfx_autoscaler_cold_start_seconds"):
            assert fam in text, fam
        t("release", t("acquire", "m1"))
        t("touch")
        assert values(reg) == values(rreg)
        assert values(reg)["loads"] == 1 and values(reg)["m1"] == 1
        assert reg.histogram("kfx_autoscaler_cold_start_seconds").count(
            mode="swap", model="lm") == 1
        split = t.port.last_swap
        assert split["model"] == "m1" and split["bytes"] == \
            t.port.nbytes()
        assert split["seconds"] >= split["load_s"] + split["device_s"]


class TestPrefixRootDrop:
    def test_drop_root_invalidates_only_that_models_chains(self):
        """Both packages: identical tokens under two roots never share a
        page, and dropping one root leaves the other's chain."""
        out = []
        for bm, pc in ((ref_engine.BlockManager, ref_engine.PrefixCache),
                       (BlockManager, PrefixCache)):
            mgr = bm(n_pages=8, page_size=4)
            cache = pc(mgr)
            toks = [1, 2, 3, 4]
            pa, pb = mgr.alloc(2)
            cache.insert_full(b"m1@1", toks, pa, root=b"m1@1")
            cache.insert_full(b"m2@2", toks, pb, root=b"m2@2")
            mgr.decref([pa, pb])
            first = cache.match(toks, 4, root=b"m1@1")
            freed = cache.drop_root(b"m1@1")
            out.append((first[0], first[2], freed,
                        cache.match(toks, 4, root=b"m1@1")[:3:2],
                        cache.match(toks, 4, root=b"m2@2")[0],
                        mgr.n_free))
        assert out[0] == out[1]
        assert out[1] == ([0], 4, [0], ([], 0), [1], 7)


# -- the engine ------------------------------------------------------------------

def _pool_engine(tiny, exports, name, **kw):
    _, cfg_p = tiny
    sources, trees = exports
    return DecodeEngine(cfg_p, trees["m0"], name=name, device="cpu",
                        models={n: sources[n] for n in MODELS},
                        model_default="m0", weight_slots=2,
                        **dict(ENGINE_KW, **kw))


@pytest.fixture(scope="module")
def engine(tiny, exports):
    """Three pooled models over TWO weight slots (the pinned default and
    one swappable), so cross-model traffic pages and requeues."""
    eng = _pool_engine(tiny, exports, "lm")
    yield eng
    eng.close()


@pytest.fixture(scope="module")
def ref_engine_pool(tiny, exports):
    cfg_r, _ = tiny
    sources, trees = exports
    eng = ref_engine.DecodeEngine(cfg_r, trees["m0"], name="lm",
                                  models={n: sources[n] for n in MODELS},
                                  model_default="m0", weight_slots=2,
                                  **ENGINE_KW)
    yield eng
    eng.close()


class TestMultiModelEngine:
    def test_per_model_greedy_matches_reference_and_dedicated(
            self, tiny, exports, engine, ref_engine_pool, oracle):
        """Serial per-model requests: the port's pooled engine, the JAX
        pooled engine, a dedicated port engine on the model's weights and
        the port's LMGenerator all give the same greedy tokens; both
        pools count the same loads and evictions."""
        _, cfg_p = tiny
        _, trees = exports
        for name in MODELS + ("m0",):
            want = oracle(name)
            assert engine.generate([PROMPT], max_new_tokens=8,
                                   model=name)[0] == want, name
            assert ref_engine_pool.generate([PROMPT], max_new_tokens=8,
                                            model=name)[0] == want, name
        assert engine.generate([PROMPT], max_new_tokens=8)[0] == \
            oracle("m0")
        ref_engine_pool.generate([PROMPT], max_new_tokens=8)
        got, want = engine.weight_stats(), ref_engine_pool.weight_stats()
        assert got == want and got["loads"] >= 2
        assert engine.hbm_bytes()["weights"] == \
            ref_engine_pool.hbm_bytes()["weights"] > 0
        for name in MODELS:
            ded = DecodeEngine(cfg_p, trees[name], name=f"ded-{name}",
                               device="cpu", **ENGINE_KW)
            try:
                assert ded.generate([PROMPT], max_new_tokens=8)[0] == \
                    oracle(name)
            finally:
                ded.close()

    def test_concurrent_mixed_batch_under_slot_pressure(
            self, engine, ref_engine_pool, oracle):
        """Six in-flight requests over three models and ONE swappable
        slot: slot pressure requeues, grouped dispatch serves two groups
        a chunk, and every output equals its model's oracle, in both
        packages."""
        plan = [MODELS[i % 3] for i in range(6)]
        for eng in (engine, ref_engine_pool):
            before = eng.weight_stats()
            reqs = [eng.submit(PROMPT, max_new_tokens=6, model=m)
                    for m in plan]
            outs = [r.result(60.0) for r in reqs]
            for m, out in zip(plan, outs):
                assert out == oracle(m, PROMPT, 6), (eng.name, m)
            after = eng.weight_stats()
            assert after["loads"] - before["loads"] >= 2
            assert after["evictions"] - before["evictions"] >= 1
        pages = engine.page_stats()
        assert pages["free"] + pages["cached"] == pages["pages"]
        assert engine._wpool.ref.tolist() == [0, 0]

    def test_evict_drops_prefix_chains_then_reload_is_identical(
            self, engine, oracle):
        want = oracle("m1", PROMPT, 6)
        hits = engine.prefix_stats()["hits"]
        for _ in range(2):
            assert engine.generate([PROMPT], max_new_tokens=6,
                                   model="m1")[0] == want
        assert engine.prefix_stats()["hits"] > hits
        root = engine._wpool.root(engine._wpool._by_name["m1"])
        assert any(e.root == root for e in engine._prefix._lru.values())
        before = engine.weight_stats()["evictions"]
        assert engine.evict_model("m1") is True
        assert engine.weight_stats()["evictions"] == before + 1
        assert engine.pooled_models()["m1"] is False
        assert not any(e.root == root
                       for e in engine._prefix._lru.values())
        hits = engine.prefix_stats()["hits"]
        assert engine.generate([PROMPT], max_new_tokens=6,
                               model="m1")[0] == want
        assert engine.prefix_stats()["hits"] == hits   # a fresh chain

    def test_model_selection_errors(self, tiny, engine, ref_engine_pool):
        msgs = []
        for eng in (ref_engine_pool, engine):
            with pytest.raises(ValueError, match="unknown model") as e:
                eng.submit(PROMPT, max_new_tokens=4, model="nope")
            msgs.append(str(e.value))
            assert eng.evict_model("nope") is False
            assert eng.evict_model("m0") is False   # the pinned default
        assert msgs[0] == msgs[1]
        _, cfg_p = tiny
        plain = DecodeEngine(cfg_p, _init(ref.TransformerConfig(
            **TINY, dtype=jnp.float32), 1), name="plain", device="cpu",
            **ENGINE_KW)
        try:
            with pytest.raises(ValueError, match="requires a weight pool"):
                plain.submit(PROMPT, max_new_tokens=4, model="m1")
            assert plain.pooled_models() == {}
            assert plain.evict_model("m1") is False
            assert plain.weight_stats() == {"loads": 0, "evictions": 0,
                                            "slots": 0, "free": 0,
                                            "loaded": []}
            assert plain.hbm_bytes()["weights"] == 0
        finally:
            plain.close()

    def test_pooled_models_accessor(self, engine, ref_engine_pool):
        got, want = engine.pooled_models(), ref_engine_pool.pooled_models()
        assert set(got) == set(want) == set(MODELS)
        assert got["m0"] is want["m0"] is True   # the resident default
        assert sum(got.values()) == sum(want.values()) == 2

    def test_ctor_exclusions(self, tiny, exports):
        """The pool's envelope fails fast with the reference's messages:
        anything deriving from ONE checkpoint (the draft, LoRA factors,
        KV peers) is out."""
        cfg_r, cfg_p = tiny
        sources, trees = exports
        models = {n: sources[n] for n in MODELS}
        cases = [dict(weight_slots=2), dict(models=models),
                 dict(models=models, model_default="zz"),
                 dict(models=models, model_default="m0", draft_layers=1),
                 dict(models=models, model_default="m0",
                      adapters={"a": "/nope"}, adapter_rank=4),
                 dict(models=models, model_default="m0", role="prefill")]
        for kw in cases:
            msgs = []
            for build in (
                    lambda: ref_engine.DecodeEngine(
                        cfg_r, trees["m0"], n_slots=2, name="bad", **kw),
                    lambda: DecodeEngine(cfg_p, trees["m0"], n_slots=2,
                                         name="bad", device="cpu", **kw)):
                with pytest.raises(ValueError) as e:
                    build()
                msgs.append(str(e.value))
            assert msgs[0] == msgs[1], kw

    def test_idle_sweep_fires_on_a_parked_engine(self, tiny, exports):
        """The replica-side scale-to-zero: a non-default model idle past
        model_idle_s loses its slot without new traffic (the parked loop
        waits with a timeout), and the pinned default never does."""
        eng = _pool_engine(tiny, exports, "lmz", model_idle_s=0.3)
        try:
            eng.generate([PROMPT], max_new_tokens=4, model="m1")
            assert eng.pooled_models()["m1"] is True
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline \
                    and eng.weight_stats()["evictions"] < 1:
                time.sleep(0.1)
            assert eng.weight_stats()["evictions"] == 1
            assert eng.pooled_models() == {"m0": True, "m1": False,
                                           "m2": False}
        finally:
            eng.close()

    def test_migrate_and_import_are_refused(self, engine, ref_engine_pool):
        """A pooled engine refuses KV transfer both ways, with the
        reference's reasons."""
        from kubeflow_tpu.serving import kvtransfer as ref_kv

        got, want = [], []
        for eng, out, tx in ((ref_engine_pool, want, ref_kv),
                             (engine, got, kvtransfer)):
            with pytest.raises(ValueError) as e:
                eng.migrate_out(send=lambda payload: "peer")
            out.append(str(e.value))
            with pytest.raises(tx.TransferError) as e:
                eng.kv_import(b"not a payload")
            out.append(str(e.value))
        assert got == want and "weight pool" in got[0]

    def test_foreign_group_leaves_masked_rows_untouched(self, tiny,
                                                        exports, oracle):
        """Grouped dispatch: while group m0 runs its k steps, the m1 row is
        masked, and its pending logits and its pages' K/V/positions are
        bit-unchanged; both rows then decode their own oracle's tokens."""
        eng = _pool_engine(tiny, exports, "lmg")
        eng.close()   # drive the chunk by hand on the stopped engine
        calls = []
        orig = eng._chunk_steps
        c = eng._cache

        def kv(slot):
            idx = torch.tensor(eng._slot_pages[slot])
            return [t[:, idx].clone() for t in (c.key, c.value, c.pos)]

        def spy(model, pos, loc, active, produced, logits, **kw):
            row = int(torch.nonzero(~active)[0]) if (~active).any() else -1
            before = (logits[row].clone(), kv(row)) if row >= 0 else None
            out = orig(model, pos, loc, active, produced, logits, **kw)
            if before is not None:
                after = (out[-1][row], kv(row))
                calls.append((row, torch.equal(before[0], after[0]),
                              all(torch.equal(a, b) for a, b in
                                  zip(before[1], after[1]))))
            return out

        eng._chunk_steps = spy
        with torch.inference_mode():
            for slot, name in enumerate(("m0", "m1")):
                eng._admit(eng._make_request(PROMPT, 8, 0.0, 0, 0, None,
                                             model=name), slot)
            toks = [[], []]
            for _ in range(2):
                eng._ensure_chunk_pages()
                t, e = eng._decode_chunk()
                for s in (0, 1):
                    toks[s] += [int(x) for x in t[e[:, s], s]]
        # Every chunk ran one call per group; each call masked the other
        # model's row (and the two idle slots) and left it untouched.
        assert len(calls) == 4
        assert {r for r, _, _ in calls} == {0, 1}
        assert all(lg and kvok for _, lg, kvok in calls), calls
        assert toks == [oracle("m0"), oracle("m1")]


# -- the server ------------------------------------------------------------------

def _call(url, body=None):
    """(status, JSON body, headers) of a GET (body None) or POST."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            raw = r.read()
            return r.status, (json.loads(raw) if r.headers[
                "Content-Type"] == "application/json" else
                raw.decode()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


@pytest.fixture(scope="module")
def servers(exports):
    """The port's and the reference's LMPredictor with KFX_LM_MODELS over
    the three exports (2 weight slots), each behind its ModelServer."""
    from kubeflow_tpu.serving import lm_server as ref_lm
    from kubeflow_tpu.serving import server as ref_server
    from kubeflow_tpu_torch.serving import lm_server
    from kubeflow_tpu_torch.serving import server as port_server

    sources, _ = exports
    mp = pytest.MonkeyPatch()
    mp.setenv("KFX_LM_ENGINE", "1")
    mp.setenv("KFX_LM_MODELS", json.dumps({n: sources[n] for n in MODELS}))
    mp.setenv("KFX_LM_MODEL_DEFAULT", "m0")
    mp.setenv("KFX_LM_WEIGHT_SLOTS", "2")
    out, stops = {}, []
    try:
        for tag, pred, srv in (
                ("ref", ref_lm.LMPredictor(sources["m0"], name="lm",
                                           warm_buckets=[8]),
                 ref_server.ModelServer(port=0)),
                ("port", lm_server.LMPredictor(sources["m0"], name="lm",
                                               device="cpu",
                                               warm_buckets=[8]),
                 port_server.ModelServer(port=0))):
            pred.load()
            srv.register(pred)
            srv.start()
            stops.append((pred, srv))
            out[tag] = f"http://127.0.0.1:{srv.port}"
        yield out
    finally:
        for pred, srv in stops:
            if pred._warm_thread is not None:
                pred._warm_thread.join(timeout=120)
            srv.stop()
            pred.close()
        mp.undo()


def test_server_pool_matches_reference(servers, oracle):
    """Pooled readiness, per-request model selection, :evict, a chaos'd
    swap and the metric families over HTTP: every answer's status and keys
    equal the reference server's, and the tokens equal the oracle's."""
    def both(path, body=None):
        got = _call(servers["port"] + path, body)
        want = _call(servers["ref"] + path, body)
        assert got[0] == want[0], (path, got, want)
        if isinstance(got[1], dict):
            assert set(got[1]) == set(want[1]), (path, got[1], want[1])
        return got, want

    gen = "/v1/models/lm:generate"
    one = {"prompt_tokens": [PROMPT], "max_new_tokens": 6, "model": "m1"}
    (code, body, _), (_, rbody, _) = both("/v1/models/m1")
    assert code == 200 and body == rbody == {
        "name": "m1", "ready": True, "pooled": True, "loaded": False,
        "host": "lm"}
    (_, body, _), (_, rbody, _) = both("/v1/models/lm")
    assert body == rbody and body["pooledModels"] == {
        "m0": True, "m1": False, "m2": False}
    (code, body, _), (_, rbody, _) = both(gen, one)
    assert code == 200
    assert body["generated_tokens"] == rbody["generated_tokens"] == [
        oracle("m1", PROMPT, 6)]
    assert both("/v1/models/m1")[0][1]["loaded"] is True
    (code, body, _), _ = both(gen, dict(one, model="nope"))
    assert code == 400 and "unknown model" in body["error"]
    (code, body, _), _ = both(gen, dict(one, model=3))
    assert code == 400
    (code, body, _), (_, rbody, _) = both("/v1/models/lm:evict",
                                          {"model": "m1"})
    assert code == 200 and body == rbody == {"model": "m1",
                                             "evicted": True}
    (code, _, _), _ = both("/v1/models/lm:evict", {})
    assert code == 400
    (code, _, _), _ = both("/v1/models/ghost:evict", {"model": "m1"})
    assert code == 404
    assert both("/v1/models/m1")[0][1]["loaded"] is False
    ref_chaos.install(ref_chaos.ChaosPlan(
        [ref_chaos.Rule("weights.load", p=1.0, count=1)], seed=3))
    chaos.install(chaos.ChaosPlan(
        [chaos.Rule("weights.load", p=1.0, count=1)], seed=3))
    try:
        (code, body, hdr), (_, _, rhdr) = both(gen, one)
    finally:
        ref_chaos.install(None)
        chaos.install(None)
    assert code == 503 and "chaos[weights.load]" in body["error"]
    assert hdr.get("Retry-After") and rhdr.get("Retry-After")
    (code, body, _), (_, rbody, _) = both(gen, one)
    assert code == 200 and body["generated_tokens"] == \
        rbody["generated_tokens"]
    (_, text, _), (_, rtext, _) = both("/metrics")
    for fam in ("kfx_lm_weight_slots", "kfx_lm_weight_slots_free",
                "kfx_lm_weight_models_loaded", "kfx_lm_weight_loads_total",
                "kfx_lm_weight_swap_seconds", "kfx_lm_weight_evictions_total",
                "kfx_lm_weight_model_loaded",
                "kfx_autoscaler_cold_start_seconds"):
        assert fam in text and fam in rtext, fam
    (_, body, _), (_, rbody, _) = both("/metrics?format=json")
    eng, reng = body["engine"]["lm"], rbody["engine"]["lm"]
    for key in ("weight_slots", "weight_slots_free", "weight_models_loaded",
                "pooled"):
        assert eng[key] == reng[key], key
    assert eng["pooled"] == {"m0": True, "m1": True, "m2": False}
