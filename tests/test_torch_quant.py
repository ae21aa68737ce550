"""The port's int8 serving (kubeflow_tpu_torch/models/transformer.py
quantizer, QuantDense and the int8 paged pool; serving/engine.py's
kv_quant / draft_quant; serving/lm_server.py's int8 exports and knobs)
against the reference's, on the reference's tiny fixture (vocab 64, d 32,
H 2, D 16, L 2, d_ff 64, max_seq_len 64, f32) on the CPU.

Tolerances:
  * int8 weight codes and scales, and int8 KV codes and scales written
    from the same K/V, are byte-equal to the reference's (one f32 divide
    and half-to-even rounding on both sides);
  * the w8 model's logits match the JAX w8 model's within 1e-5 of the
    largest |logit| (f32), as the f32 model's do;
  * the reference's own bars where a case is ported from its tests
    (tests/test_generate.py TestQuantization, tests/test_engine.py
    TestInt8KV): w8 logits within 5% of the f32 logit range and NLL
    within 2%; the dequantized tree through the full-precision path
    within 1e-4 of the w8 path; greedy drift: first token equal and mean
    agreement >= 0.5; admission at the same pool bytes >= 1.8x."""

import dataclasses
import json
import os
import time
import urllib.request

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from kubeflow_tpu import chaos as ref_chaos  # noqa: E402
from kubeflow_tpu.models import transformer as ref  # noqa: E402
from kubeflow_tpu.serving import lm_server as ref_lm  # noqa: E402
from kubeflow_tpu_torch import chaos  # noqa: E402
from kubeflow_tpu_torch.models import transformer as port  # noqa: E402
from kubeflow_tpu_torch.models.convert import (  # noqa: E402
    params_from_jax, params_to_jax)
from kubeflow_tpu_torch.models.generate import LMGenerator  # noqa: E402
from kubeflow_tpu_torch.serving import lm_server  # noqa: E402
from kubeflow_tpu_torch.serving import server as port_server  # noqa: E402
from kubeflow_tpu_torch.serving.engine import DecodeEngine  # noqa: E402

from test_torch_generate import TINY  # noqa: E402

TOL_W8 = 1e-5       # port w8 logits vs JAX w8 logits, rel. to max |logit|
TOL_DEQUANT = 1e-4  # dequantized tree, full-precision path vs w8 path
PROMPTS = [[5, 9, 11, 3, 7], [2], [1, 2, 3, 4, 5, 6, 7, 8, 9], [13, 14]]


@pytest.fixture(autouse=True)
def _clean_chaos():
    chaos.reset()
    ref_chaos.reset()
    yield
    chaos.reset()


@pytest.fixture(scope="module")
def tiny_lm():
    """(reference config, port config, the reference's f32 param tree as
    numpy): the reference's own fixture weights."""
    cfg_r = ref.TransformerConfig(**TINY, dtype=jnp.float32)
    params = ref.TransformerLM(cfg_r).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    return cfg_r, port.TransformerConfig(**TINY, dtype="float32"), params


def _leaves(tree):
    return sorted((jax.tree_util.keystr(p), np.asarray(x)) for p, x in
                  jax.tree_util.tree_leaves_with_path(tree))


def _assert_trees_bitwise(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, p
        assert x.tobytes() == y.tobytes(), p


def _port_model(cfg_p, params):
    model = port.TransformerLM(cfg_p, device="meta")
    model.load_state_dict({k: torch.as_tensor(v) for k, v in
                           params_from_jax(params).items()}, assign=True)
    return model.eval()


def _tokens(cfg, shape=(2, 16), seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


# -- the quantizer -------------------------------------------------------------

def test_quantize_params_byte_equal_to_reference(tiny_lm):
    """The same seeded f32 tree through both quantizers: every int8 code
    and f32 scale byte-equal, the stacked kernels per layer and channel;
    the dequantized trees byte-equal too."""
    _, _, params = tiny_lm
    want = jax.tree_util.tree_map(np.asarray, ref.quantize_params_int8(
        params))
    got = port.quantize_params_int8(params)
    _assert_trees_bitwise(got, want)
    assert got["layers"]["attn"]["query"]["scale"].shape == (2, 2, 16)
    assert got["lm_head"]["scale"].shape == (64,)
    assert port.params_quantized(got) and not port.params_quantized(params)
    _assert_trees_bitwise(
        port.dequantize_params_int8(got),
        jax.tree_util.tree_map(np.asarray,
                               ref.dequantize_params_int8(want)))
    # Already-int8 kernels pass through; the input is not mutated.
    _assert_trees_bitwise(port.quantize_params_int8(got), got)
    assert params["lm_head"]["kernel"].dtype == np.float32


def test_quantize_leaf_rounds_half_to_even_and_clips():
    w = np.array([[0.5, -1.5], [2.5, 127.0], [0.0, -127.0]], np.float32)
    q, scale = port.quantize_leaf_int8(w, 1)
    rq, rs = ref.quantize_leaf_int8(w, 1)
    assert q.tobytes() == np.asarray(rq).tobytes()
    assert scale.tobytes() == np.asarray(rs).tobytes()
    zero = port.quantize_leaf_int8(np.zeros((3, 2), np.float32), 1)
    assert (zero[0] == 0).all() and (zero[1] == 1.0).all()


def test_w8_logits_match_jax_w8_model(tiny_lm):
    """The same int8 tree through the port's QuantDense model and the
    reference's QuantDenseGeneral model: logits within 1e-5 relative."""
    cfg_r, cfg_p, params = tiny_lm
    qp = ref.quantize_params_int8(params)
    toks = _tokens(cfg_p)
    lr = np.asarray(ref.TransformerLM(dataclasses.replace(
        cfg_r, quant="int8")).apply({"params": qp}, jnp.asarray(toks)))
    model = _port_model(dataclasses.replace(cfg_p, quant="int8"),
                        jax.tree_util.tree_map(np.asarray, qp))
    assert model.lm_head.kernel.dtype == torch.int8
    assert model.lm_head.scale.dtype == torch.float32
    assert not model.lm_head.kernel.requires_grad
    with torch.no_grad():
        lp = model(torch.from_numpy(toks)).numpy()
    assert np.abs(lp - lr).max() / np.abs(lr).max() < TOL_W8


def test_quant_dense_keeps_dtypes_through_casts(tiny_lm):
    """The trap: module.to(dtype) converts floating tensors only, so the
    kernel stays int8 whatever path builds the model; the engine's and
    the draft's loads keep the scale f32 under a bf16 config."""
    _, cfg_p, params = tiny_lm
    cfg = dataclasses.replace(cfg_p, quant="int8", dtype="bfloat16")
    gen = LMGenerator(cfg, port.quantize_params_int8(params), device="cpu")
    draft = port.truncate_layers(gen.model, 1)
    for m in (gen.model, draft):
        for name, t in m.state_dict().items():
            if name.endswith("kernel") and "embed" not in name:
                assert t.dtype == torch.int8, name
            if name.endswith(("query.scale", "wo.scale", "lm_head.scale")):
                assert t.dtype == torch.float32, name
    out = gen.generate([[5, 9, 11]], max_new_tokens=4)[0]
    assert len(out) == 4


# -- the reference's TestQuantization on the port -------------------------------

class TestQuantization:
    def test_quantized_logits_within_tolerance(self, tiny_lm):
        _, cfg_p, params = tiny_lm
        toks = torch.from_numpy(_tokens(cfg_p))
        with torch.no_grad():
            lf = _port_model(cfg_p, params)(toks)
            lq = _port_model(dataclasses.replace(cfg_p, quant="int8"),
                             port.quantize_params_int8(params))(toks)
        rel = float((lf - lq).abs().max()) / float(lf.abs().max())
        assert rel < 0.05, f"quantized logit error {rel:.3f} >= 5%"

        def nll(logits):
            lp = torch.log_softmax(logits[:, :-1].float(), -1)
            return -float(lp.gather(-1, toks[:, 1:, None]).mean())

        delta = abs(nll(lq) - nll(lf))
        assert delta < 0.02 * nll(lf), (delta, nll(lf))

    def test_dequantize_roundtrip_matches_quant_path(self, tiny_lm):
        _, cfg_p, params = tiny_lm
        toks = torch.tensor([[5, 9, 11, 3, 7, 2, 1, 4]])
        qp = port.quantize_params_int8(params)
        with torch.no_grad():
            lq = _port_model(dataclasses.replace(cfg_p, quant="int8"),
                             qp)(toks)
            ld = _port_model(cfg_p, port.dequantize_params_int8(qp))(toks)
        assert float((lq - ld).abs().max()) < TOL_DEQUANT

    def test_quantized_generator_greedy_tracks_oracle(self, tiny_lm):
        _, cfg_p, params = tiny_lm
        want = LMGenerator(cfg_p, params, device="cpu").generate(
            [[5, 9, 11, 3, 7]], max_new_tokens=8)[0]
        got = LMGenerator(dataclasses.replace(cfg_p, quant="int8"),
                          port.quantize_params_int8(params),
                          device="cpu").generate([[5, 9, 11, 3, 7]],
                                                 max_new_tokens=8)[0]
        assert len(got) == len(want)
        agree = sum(a == b for a, b in zip(got, want)) / len(want)
        assert got[0] == want[0] and agree >= 0.5, (got, want)


# -- int8 paged KV ----------------------------------------------------------------

def test_int8_kv_codes_and_scales_equal_jax_pool(tiny_lm):
    """flax's paged branch with kv_quant="int8" writes a right-padded
    prefill through block tables with an unallocated block; the port's
    ``_paged_attend`` writes the same layer-0 K/V (read back from flax's
    f32 pool on the same inputs) through the same tables: the int8 codes
    and scale planes are byte-equal, the sink page absorbed the dropped
    writes, and the port's full int8-KV model agrees with flax's on the
    logits (1e-4)."""
    _, _, params = tiny_lm
    paged = dict(TINY, decode=True, kv_page_size=16, kv_pages=8)
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
    # Row 1's prompt runs into block 1, unallocated: its writes drop.
    pos[1, 16:20] = np.arange(16, 20)

    def flax_pool(kv_quant):
        cfg = ref.TransformerConfig(**paged, dtype=jnp.float32,
                                    kv_quant=kv_quant)
        logits, vs = ref.TransformerLM(cfg).apply(
            {"params": params}, jnp.asarray(toks),
            positions=jnp.asarray(pos), block_tables=jnp.asarray(tables),
            mutable=["cache"])
        return np.asarray(logits), jax.tree_util.tree_map(
            np.asarray, vs["cache"]["layers"]["attn"])

    _, f32 = flax_pool("")
    lr, i8 = flax_pool("int8")
    # Each written token's f32 K/V of layer 0, read back from the pool.
    P = 16
    blk = np.where(pos >= 0, pos // P, 0)
    page = np.take_along_axis(tables, blk, 1)
    ok = (pos >= 0) & (page >= 0)
    page, slot = np.where(ok, page, 0), np.where(ok, pos % P, 0)
    k = torch.from_numpy(f32["cached_key"][0][page, slot])
    v = torch.from_numpy(f32["cached_value"][0][page, slot])
    cfg_p = port.TransformerConfig(**paged, dtype="float32",
                                   attn_impl="xla", kv_quant="int8")
    cache = port.PagedKVCache.allocate(cfg_p)
    assert cache.key.dtype == torch.int8
    assert cache.key_scale.shape == (2, 9, 16)
    attn = port.Attention(cfg_p)
    # Rows whose block is unallocated carry garbage K/V read from page 0:
    # they must land on the sink, never on a real page.
    with torch.no_grad():
        attn._paged_attend(torch.zeros_like(k), k, v,
                           torch.from_numpy(pos), cache.layers[0],
                           torch.from_numpy(tables), None)
    for name, plane in (("cached_key", cache.key),
                        ("cached_value", cache.value),
                        ("key_scale", cache.key_scale),
                        ("value_scale", cache.value_scale)):
        want = i8[name][0]
        assert plane[0, :8].numpy().tobytes() == want.tobytes(), name
    assert (cache.key_scale[0, 8] > 0).any()   # the sink took row 1's tail
    model = _port_model(cfg_p, params)
    cache = port.PagedKVCache.allocate(cfg_p)
    with torch.no_grad():
        lp = model(torch.from_numpy(toks).long(), torch.from_numpy(pos),
                   cache, torch.from_numpy(tables)).numpy()
    real = pos >= 0
    assert np.abs(lp - lr)[real].max() < 1e-4
    assert cache.nbytes == sum(t.numel() * t.element_size() for t in (
        cache.key, cache.value, cache.pos, cache.key_scale,
        cache.value_scale))


@pytest.fixture(scope="module")
def kv8_engine(tiny_lm):
    _, cfg_p, params = tiny_lm
    eng = DecodeEngine(cfg_p, params, n_slots=4, chunk_tokens=4, name="kv8",
                       kv_page_size=16, kv_quant="int8", device="cpu")
    yield eng
    eng.close()


def _engine(tiny_lm, **kw):
    _, cfg_p, params = tiny_lm
    kw.setdefault("n_slots", 4)
    kw.setdefault("chunk_tokens", 4)
    kw.setdefault("kv_page_size", 16)
    return DecodeEngine(cfg_p, params, device="cpu", **kw)


class TestInt8KV:
    """The reference's TestInt8KV on the port: drift against the
    full-precision oracle is bounded, not exact, but everything the page
    machinery does is invisible under int8."""

    def test_greedy_drift_bounded_vs_oracle(self, tiny_lm, kv8_engine):
        _, cfg_p, params = tiny_lm
        gen = LMGenerator(cfg_p, params, device="cpu")
        out = kv8_engine.generate(PROMPTS, max_new_tokens=12)
        want = [gen.generate([p], max_new_tokens=12)[0] for p in PROMPTS]
        assert [len(o) for o in out] == [12] * 4
        agrees = [sum(a == b for a, b in zip(o, r)) / 12
                  for o, r in zip(out, want)]
        assert all(o[0] == r[0] for o, r in zip(out, want))
        assert sum(agrees) / len(agrees) >= 0.5, agrees
        assert kv8_engine.generate(PROMPTS, max_new_tokens=12) == out
        c = kv8_engine.cfg
        assert kv8_engine._cache.key.dtype == torch.int8
        assert len(kv8_engine._cache.scales) == 2
        # As the pool stores it: 1-byte entries, two f32 scale words and
        # the position-id word a layer.
        assert kv8_engine.kv_bytes_per_token == \
            2 * c.n_layers * c.n_heads * c.head_dim + 2 * c.n_layers * 4 \
            + 4 * c.n_layers
        assert kv8_engine.pool_bytes == \
            (kv8_engine.n_pages + 1) * c.kv_page_size \
            * kv8_engine.kv_bytes_per_token
        assert kv8_engine.quant_mode == "kv8"

    def test_admits_1_8x_on_same_pool_bytes(self, tiny_lm):
        def peak_admission(kv_quant, n_pages):
            eng = _engine(tiny_lm, n_slots=8, name="adm", kv_pages=n_pages,
                          prefix_cache=False, kv_quant=kv_quant)
            try:
                # 20-token prompts (bucket 32) + 8 new tokens: 3 pages a
                # request, so the pool, not n_slots, is the limit.
                prompts = [[(7 * i + j) % 60 for j in range(20)]
                           for i in range(8)]
                reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
                peak, deadline = 0, time.monotonic() + 60
                while (not all(r.done() for r in reqs)
                       and time.monotonic() < deadline):
                    peak = max(peak, eng._active_count())
                    time.sleep(0.001)
                for r in reqs:
                    assert len(r.result(60)) == 8
                return peak, eng.kv_bytes_per_token
            finally:
                eng.close()

        f32_pages = 8
        peak_f32, bpt_f32 = peak_admission("", f32_pages)
        budget = f32_pages * 16 * bpt_f32
        probe = _engine(tiny_lm, n_slots=1, kv_pages=4, name="probe",
                        kv_quant="int8")
        try:
            int8_pages = budget // (16 * probe.kv_bytes_per_token)
        finally:
            probe.close()
        peak_i8, _ = peak_admission("int8", int(int8_pages))
        assert peak_i8 >= 1.8 * peak_f32, (peak_i8, peak_f32, budget)

    def test_page_machinery_invisible_under_int8(self, tiny_lm):
        """Prefix sharing (with COW boundary pages), recycling and
        preemption write the same quantized values a machinery-free
        engine writes: byte-identical outputs against a big-pool,
        cache-off int8 engine, and no page leaks."""
        system = [(7 * i + 3) % 60 for i in range(36)]
        shared = [system + [60 + i] for i in range(3)]
        grow = [[i + 1, i + 2, i + 3] for i in range(4)]
        plain = _engine(tiny_lm, name="plain8", prefix_cache=False,
                        kv_quant="int8")
        try:
            ref_shared = plain.generate(shared, max_new_tokens=8)
            ref_grow = plain.generate(grow, max_new_tokens=40)
        finally:
            plain.close()
        cache_on = _engine(tiny_lm, name="cow8", kv_quant="int8")
        try:
            assert cache_on.generate(shared, max_new_tokens=8) == ref_shared
            hits = cache_on._prefix.hits
            assert cache_on.generate(shared, max_new_tokens=8) == ref_shared
            assert cache_on._prefix.hits > hits
        finally:
            cache_on.close()
        small = _engine(tiny_lm, n_slots=8, name="small8", kv_pages=8,
                        prefix_cache=False, kv_quant="int8")
        try:
            assert small.generate(shared, max_new_tokens=8) == ref_shared
            assert small.generate(grow, max_new_tokens=40) == ref_grow
            assert small.page_stats()["preemptions"] >= 1
            assert small._mgr.n_free == small.n_pages
        finally:
            small.close()

    def test_spec_verify_parity_under_int8(self, tiny_lm):
        prompts = [[5, 9, 11, 3, 7], [2], [13, 14]]
        base = _engine(tiny_lm, name="b8", kv_quant="int8")
        try:
            want = base.generate(prompts, max_new_tokens=12)
        finally:
            base.close()
        spec = _engine(tiny_lm, name="s8", kv_quant="int8", draft_layers=1,
                       draft_quant="int8")
        try:
            assert spec.quant_mode == "d8+kv8"
            assert spec.draft_cfg.quant == "int8"
            assert spec.draft_cfg.kv_quant == "int8"
            assert spec.draft_model.layers[0].attn.query.kernel.dtype == \
                torch.int8
            assert spec.model.layers[0].attn.query.kernel.dtype == \
                torch.float32
            assert spec.generate(prompts, max_new_tokens=12) == want
            assert spec.spec_stats()["proposed"] > 0
            assert spec._mgr.n_free == spec.n_pages - 1  # prefix pin
            assert spec._draft_mgr.n_free == spec.draft_n_pages
        finally:
            spec.close()

    def test_chaos_kv_quant_degrades_never_crashes(self, tiny_lm):
        eng = _engine(tiny_lm, name="c8", kv_quant="int8")
        prompts = [[5, 9, 11, 3, 7], [1, 2, 3, 4]]
        try:
            clean = eng.generate(prompts, max_new_tokens=12)
            assert len(eng._prefix) > 0
            chaos.install(chaos.parse_spec("engine.kv_quant:count=2"))
            hit = eng.generate(prompts, max_new_tokens=12)
            assert chaos.injected_counts().get("engine.kv_quant") == 2
            chaos.reset()
            assert [len(o) for o in hit] == [12, 12]
            assert hit != clean
            assert len(eng._prefix) == 0
            assert eng._mgr.n_free == eng.n_pages
            assert eng.generate(prompts, max_new_tokens=12) == clean
        finally:
            eng.close()


def test_w8_engine_equals_w8_generator(tiny_lm):
    """A quant="int8" target in the engine (bf16-free f32 path): the
    paged engine's greedy tokens equal the w8 LMGenerator's, and its
    mode reads w8 (w8+kv8 with int8 KV)."""
    _, cfg_p, params = tiny_lm
    cfg8 = dataclasses.replace(cfg_p, quant="int8")
    qp = port.quantize_params_int8(params)
    want = LMGenerator(cfg8, qp, device="cpu").generate(
        [[5, 9, 11]], max_new_tokens=8)
    eng = DecodeEngine(cfg8, qp, n_slots=2, chunk_tokens=4, kv_page_size=16,
                       name="w8", device="cpu")
    try:
        assert eng.quant_mode == "w8"
        assert eng.generate([[5, 9, 11]], max_new_tokens=8) == want
    finally:
        eng.close()


# -- exports and the predictor ----------------------------------------------------

def test_int8_exports_cross_both_ways(tiny_lm, tmp_path):
    """The reference's int8 export loads in the port with byte-equal codes
    and scales, and the port's loads in the reference; the two files and
    configs are identical."""
    cfg_r, _, params = tiny_lm
    ref_lm.export_lm(str(tmp_path / "ref"), cfg_r, params, quantize="int8")
    cfg_p, got = lm_server.load_lm(str(tmp_path / "ref"))
    assert cfg_p.quant == "int8"
    _assert_trees_bitwise(got, jax.tree_util.tree_map(
        np.asarray, ref.quantize_params_int8(params)))
    lm_server.export_lm(str(tmp_path / "port"), cfg_p.__class__(
        **{**dataclasses.asdict(cfg_p), "quant": ""}), params,
        quantize="int8")
    cfg_back, back = ref_lm.load_lm(str(tmp_path / "port"))
    assert cfg_back.quant == "int8"
    _assert_trees_bitwise(jax.tree_util.tree_map(np.asarray, back), got)
    files = [open(str(tmp_path / w / name), "rb").read()
             for name in ("params.msgpack", "lm_config.json")
             for w in ("port", "ref")]
    assert files[0] == files[1]
    assert json.loads(files[2]) == json.loads(files[3])
    # The state_dict round trip keeps the int8 leaves.
    _assert_trees_bitwise(params_to_jax(params_from_jax(got)), got)


def _generate(port_, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port_}/v1/models/lm:generate",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_quantized_predictor_env_to_engine_block(tiny_lm, tmp_path,
                                                 monkeypatch):
    """KFX_LM_QUANT=int8 + KFX_LM_KV_QUANT=int8 on an f32 export: the
    predictor quantizes at load, the engine runs w8+kv8, :generate serves,
    and the mode shows in the server's JSON engine block."""
    _, cfg_p, params = tiny_lm
    lm_server.export_lm(str(tmp_path / "lm"), cfg_p, params)
    monkeypatch.setenv("KFX_LM_ENGINE", "1")
    monkeypatch.setenv("KFX_LM_QUANT", "int8")
    monkeypatch.setenv("KFX_LM_KV_QUANT", "int8")
    p = lm_server.LMPredictor(str(tmp_path / "lm"), name="lm",
                              device="cpu", warm_buckets=[8])
    p.load()
    srv = port_server.ModelServer(port=0)
    srv.register(p)
    srv.start()
    try:
        assert p.engine.cfg.quant == "int8"
        assert p.engine.quant_mode == "w8+kv8"
        body = _generate(srv.port, {"prompt_tokens": [[5, 9, 11]],
                                    "max_new_tokens": 6})
        assert len(body["generated_tokens"][0]) == 6
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/metrics?format=json",
                timeout=60) as r:
            blk = json.loads(r.read())["engine"]["lm"]
        assert blk["quant"] == "w8+kv8"
        assert blk["kv_bytes_per_token"] == p.engine.kv_bytes_per_token
    finally:
        srv.stop()
        p.close()


@pytest.mark.parametrize("engine", ["1", "0"])
def test_quant_0_escape_hatch_serves_full_precision(tiny_lm, tmp_path,
                                                    monkeypatch, engine):
    """KFX_LM_QUANT=0 on an int8 export dequantizes at load: the served
    model is full precision and answers as the dequantized tree does."""
    _, cfg_p, params = tiny_lm
    d = str(tmp_path / "q8")
    lm_server.export_lm(d, cfg_p, params, quantize="int8")
    monkeypatch.setenv("KFX_LM_ENGINE", engine)
    monkeypatch.setenv("KFX_LM_SPEC", "0")
    monkeypatch.setenv("KFX_LM_QUANT", "0")
    p = lm_server.LMPredictor(d, name="lm", device="cpu", warm_buckets=[8])
    p.load()
    try:
        model = p.engine.model if engine == "1" else p._gen.model
        assert model.lm_head.kernel.dtype == torch.float32
        if engine == "1":
            assert p.engine.quant_mode == "f32"
        want = LMGenerator(cfg_p, port.dequantize_params_int8(
            lm_server.load_lm(d)[1]), device="cpu").generate(
                [[5, 9, 11]], max_new_tokens=6)
        got = p.generate({"prompt_tokens": [[5, 9, 11]],
                          "max_new_tokens": 6})["generated_tokens"]
        assert got == want
    finally:
        p.close()
