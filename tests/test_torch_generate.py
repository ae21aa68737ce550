"""The port's dense KV-cache decode and one-shot LMGenerator
(kubeflow_tpu_torch/models/{transformer,generate}.py) against the
reference's (kubeflow_tpu/models/{transformer,generate}.py), on the
reference's own tiny fixture (vocab 64, d 32, H 2, D 16, L 2, d_ff 64,
max_seq_len 64, f32), plus the reference's TestLMGenerator contracts
rerun on the port and the sampling rule held to its distribution.

Greedy tokens are compared across frameworks only on wide-gap weights
(lm_head tied to the embedding, each layer's attn.out and mlp.wo scaled
by 0.35, as bench.py's ``_spec_benchable_params`` builds them), and the
smallest top-1/top-2 logit gap on the path is asserted first, so a
near-tie fails loudly instead of flakily."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from kubeflow_tpu.models import generate as ref_gen  # noqa: E402
from kubeflow_tpu.models import transformer as ref  # noqa: E402
from kubeflow_tpu_torch.models import generate as gen  # noqa: E402
from kubeflow_tpu_torch.models import transformer as port  # noqa: E402
from kubeflow_tpu_torch.models.convert import params_from_jax  # noqa: E402

TINY = dict(vocab_size=64, d_model=32, n_heads=2, head_dim=16, n_layers=2,
            d_ff=64, max_seq_len=64)
TOL_LOGITS = 1e-4   # decode-mode logits, port vs flax, f32, max-abs
MIN_GAP = 1e-3      # top-1/top-2 logit gap required before comparing argmax


def wide_gap(params, alpha=0.35):
    """bench.py's ``_spec_benchable_params`` in numpy: lm_head tied to
    the embedding transposed, the layers' residual projections (attn.out,
    mlp.wo) scaled by ``alpha``."""
    out = jax.tree_util.tree_map(np.array, params)
    out["layers"]["attn"]["out"]["kernel"] *= alpha
    out["layers"]["mlp"]["wo"]["kernel"] *= alpha
    out["lm_head"] = {"kernel": np.ascontiguousarray(
        out["embed"]["embedding"].T)}
    return out


@pytest.fixture(scope="module")
def tiny():
    cfg_r = ref.TransformerConfig(**TINY, dtype=jnp.float32)
    params = ref.TransformerLM(cfg_r).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    cfg_p = port.TransformerConfig(**TINY, dtype="float32")
    return cfg_r, cfg_p, params


@pytest.fixture(scope="module")
def gapped(tiny):
    cfg_r, cfg_p, params = tiny
    return cfg_r, cfg_p, wide_gap(params)


def recompute(cfg_p, params, prompt, n):
    """Greedy decode by a full no-cache forward over the growing
    sequence: (new tokens, smallest top-1/top-2 gap on the path)."""
    model = port.TransformerLM(cfg_p, device="cpu")
    model.load_state_dict(params_from_jax(params))
    toks, gap = list(prompt), float("inf")
    with torch.no_grad():
        for _ in range(n):
            last = model(torch.tensor([toks]))[0, -1]
            top2 = torch.topk(last, 2).values
            gap = min(gap, float(top2[0] - top2[1]))
            toks.append(int(torch.argmax(last)))
    return toks[len(prompt):], gap


def _padded(prompts, pad):
    tokens = np.zeros((len(prompts), pad), np.int32)
    pos = np.full((len(prompts), pad), -1, np.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
        pos[i, :len(p)] = np.arange(len(p))
    return tokens, pos


def test_decode_logits_match_reference(tiny):
    """Prefill of a right-padded mixed-length batch (pad position -1),
    then 3 one-token decode steps, through the reference's flax cache
    and the port's KVCache: every logit (pad rows included) within
    1e-4."""
    cfg_r, cfg_p, params = tiny
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(0, 64, n)) for n in (5, 11, 3)]
    tokens, pos = _padded(prompts, 16)
    steps = rng.integers(0, 64, (3, 3)).astype(np.int32)
    true_len = np.array([len(p) for p in prompts], np.int32)

    model_r = ref.TransformerLM(ref_gen.decode_config(cfg_r))
    want, v = model_r.apply({"params": params}, jnp.asarray(tokens),
                            positions=jnp.asarray(pos), mutable=["cache"])
    want = [np.asarray(want)]
    for s in range(3):
        out, v = model_r.apply(
            {"params": params, "cache": v["cache"]},
            jnp.asarray(steps[s][:, None]),
            positions=jnp.asarray((true_len + s)[:, None]),
            mutable=["cache"])
        want.append(np.asarray(out))

    cfg_d = gen.decode_config(cfg_p)
    model_p = port.TransformerLM(cfg_d, device="cpu")
    model_p.load_state_dict(params_from_jax(params))
    cache = port.KVCache.allocate(cfg_d, 3)
    with torch.no_grad():
        got = [model_p(torch.from_numpy(tokens).long(),
                       torch.from_numpy(pos), cache).numpy()]
        for s in range(3):
            got.append(model_p(
                torch.from_numpy(steps[s][:, None]).long(),
                torch.from_numpy((true_len + s)[:, None]), cache).numpy())
    assert cache.length == 19 and cache.cursor.tolist() == [19] * 3
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=TOL_LOGITS, rtol=0)


def test_decode_cache_is_explicit_and_guarded(tiny):
    """decode=True takes a KVCache and only then; a write past
    max_seq_len is refused before it reaches the cache (PyTorch has no
    dropping scatter)."""
    _, cfg_p, params = tiny
    cfg_d = gen.decode_config(cfg_p)
    model = port.TransformerLM(cfg_d, device="cpu")
    model.load_state_dict(params_from_jax(params))
    with pytest.raises(ValueError, match="KVCache"):
        model(torch.zeros(1, 4, dtype=torch.long))
    cache = port.KVCache.allocate(cfg_d, 1)
    assert cache.layers[0].key.shape == (1, 64, 2, 16)
    assert bool((cache.layers[0].pos == -1).all())
    with torch.no_grad():
        model(torch.zeros(1, 60, dtype=torch.long), None, cache)
        with pytest.raises(ValueError, match="overflow"):
            model(torch.zeros(1, 5, dtype=torch.long),
                  torch.full((1, 5), 60, dtype=torch.int32), cache)
    assert cache.length == 60
    with pytest.raises(ValueError, match="KVCache"):
        port.TransformerLM(cfg_p, device="cpu")(
            torch.zeros(1, 4, dtype=torch.long), None, cache)


@pytest.mark.parametrize("prompts,max_new", [
    ([[5, 9, 11, 3, 7], [2], [40, 41, 42, 43, 44, 45, 46, 47, 48, 49]], 8),
    ([[5, 9, 11]], 6),      # pads to bucket 8, sliced to 6
    ([[1] * 60], 4),        # exact fit: 60 + bucket 8 > 64, 60 + 4 == 64
], ids=["mixed_batch", "max_new_6", "exact_fit"])
def test_greedy_matches_reference_generator(gapped, prompts, max_new):
    cfg_r, cfg_p, params = gapped
    for p in prompts:
        _, gap = recompute(cfg_p, params, p, max_new)
        assert gap > MIN_GAP, f"argmax gap {gap:.2e} too small to compare"
    want = ref_gen.LMGenerator(cfg_r, params).generate(prompts, max_new)
    got = gen.LMGenerator(cfg_p, params, device="cpu").generate(
        prompts, max_new)
    assert got == want
    assert all(len(t) == max_new for t in got)


def test_greedy_matches_full_recompute(gapped):
    _, cfg_p, params = gapped
    prompt = [5, 9, 11, 3, 7]
    ref_toks, gap = recompute(cfg_p, params, prompt, 8)
    assert gap > MIN_GAP
    out = gen.LMGenerator(cfg_p, params, device="cpu").generate(
        [prompt], max_new_tokens=8, temperature=0.0)
    assert out[0] == ref_toks


def test_mixed_length_batch_invariance(gapped):
    """Padding the batch must not change the first prompt's decode."""
    _, cfg_p, params = gapped
    g = gen.LMGenerator(cfg_p, params, device="cpu")
    single = g.generate([[5, 9, 11]], max_new_tokens=6)
    batched = g.generate([[5, 9, 11], [2]], max_new_tokens=6)
    assert batched[0] == single[0]


def test_sampling_seed_determinism_and_top_k_1(tiny):
    _, cfg_p, params = tiny
    g = gen.LMGenerator(cfg_p, params, device="cpu")
    kw = dict(max_new_tokens=12, temperature=1.0)
    a = g.generate([[1, 2, 3]], seed=1, **kw)
    b = g.generate([[1, 2, 3]], seed=1, **kw)
    c = g.generate([[1, 2, 3]], seed=2, **kw)
    assert a == b          # deterministic in the seed
    assert a != c          # and stochastic across seeds
    topk = g.generate([[1, 2, 3]], top_k=1, seed=3, **kw)
    greedy = g.generate([[1, 2, 3]], max_new_tokens=12, temperature=0.0)
    assert topk == greedy  # top_k=1 collapses to greedy


def test_capacity_guard_and_arguments(tiny):
    _, cfg_p, params = tiny
    g = gen.LMGenerator(cfg_p, params, device="cpu")
    with pytest.raises(ValueError, match="cache capacity"):
        g.generate([[1] * 60], max_new_tokens=32)
    with pytest.raises(ValueError, match="max_new_tokens must be >= 1"):
        g.generate([[1]], max_new_tokens=0)
    with pytest.raises(ValueError, match="token ids"):
        g.generate([[64]], max_new_tokens=1)


def test_generator_takes_state_dict_and_refuses_cuda_without_gpu(tiny):
    _, cfg_p, params = tiny
    a = gen.LMGenerator(cfg_p, params, device="cpu")
    b = gen.LMGenerator(cfg_p, params_from_jax(params), device="cpu")
    assert a.generate([[3, 4]], 5) == b.generate([[3, 4]], 5)
    assert a.cfg.decode and a.cfg.attn_impl == "xla"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            gen.LMGenerator(cfg_p, params)


def test_decode_config_matches_reference(tiny):
    cfg_r, cfg_p, _ = tiny
    for max_len in (None, 32):
        r = ref_gen.decode_config(
            dataclasses.replace(cfg_r, remat=True, loss_chunk=16), max_len)
        p = gen.decode_config(
            dataclasses.replace(cfg_p, remat=True, loss_chunk=16), max_len)
        for f in dataclasses.fields(r):
            if f.name not in ("dtype", "param_dtype"):
                assert getattr(p, f.name) == getattr(r, f.name), f.name


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 31, 100, 512, 513, 3000])
@pytest.mark.parametrize("cap", [8, 64, 2048])
def test_pow2_bucket_matches_reference(n, cap):
    assert gen.pow2_bucket(n, cap) == ref_gen.pow2_bucket(n, cap)


@pytest.mark.parametrize("tail_len", [0, 1, 31, 256, 257, 1000])
@pytest.mark.parametrize("chunk", [16, 256])
def test_prefill_chunks_match_reference(tail_len, chunk):
    for cap in (64, 2048):
        assert gen.prefill_chunks(tail_len, chunk, cap) == \
            ref_gen.prefill_chunks(tail_len, chunk, cap)


# _sample against softmax(logits / T) over its support. 20k draws of one
# row; chi-square over the surviving tokens against the threshold for
# p = 1e-4 at their degrees of freedom (support - 1); masked tokens must
# never be drawn.
CHI2_1E4 = {1: 15.14, 2: 18.42, 3: 21.11, 4: 23.51, 5: 25.74, 6: 27.86,
            7: 29.88}
LOGITS = [2.0, 1.5, 1.0, 1.0, 0.5, 0.0, -1.0, -2.0]


@pytest.mark.parametrize("temperature,top_k,support", [
    (1.0, 0, 8), (0.7, 3, 4),   # k-th value tied: both 1.0s survive
    (1.3, 2, 2), (0.5, 100, 8),  # top_k beyond V filters nothing
    (1.0, 1, 2),                 # tie at the max: both survive
], ids=["t1", "t0.7_k3_tie", "t1.3_k2", "k_past_v", "k1_tie_at_max"])
def test_sample_matches_target_distribution(temperature, top_k, support):
    logits = torch.tensor(LOGITS)
    if top_k == 1:
        logits = torch.tensor([3.0, 3.0] + LOGITS[2:])
    n = 20_000
    g = torch.Generator().manual_seed(0)
    draws = gen._sample(logits.expand(n, -1), g, temperature, top_k)
    assert draws.shape == (n,)
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


def test_sample_greedy_is_first_argmax_and_knobs_match_reference():
    logits = np.array([[0.5, 3.0, 3.0, -1.0], [1.0, 0.0, 1.0, 1.0]],
                      np.float32)
    g = torch.Generator().manual_seed(0)
    got = gen._sample(torch.from_numpy(logits), g, 0.0, 5)
    want = ref_gen._sample(jnp.asarray(logits), jax.random.PRNGKey(0),
                           jnp.float32(0.0), jnp.int32(5))
    assert got.tolist() == np.asarray(want).tolist() == [1, 0]
    # top_k=1 with the max tied: the reference keeps both (not one, as
    # torch.topk would), so it draws either, never anything else.
    row = torch.tensor([[2.0, 2.0, 1.0, 0.0]]).expand(4000, -1)
    seen = set(gen._sample(row, g, 1.0, 1).tolist())
    assert seen == {0, 1}
