"""MoE in the port (kubeflow_tpu_torch/models/transformer.py ``MoEFFN``,
the aux loss in parallel/lm_train.py, the MoE leaves in models/convert.py,
``--experts`` in runners/lm_runner.py, an MoE export served through
LMGenerator and the DecodeEngine) against the reference's
(models/transformer.py ``MoEFFN``, tests/test_parallel.py ``TestMoE``),
on the same seeded inputs and params, on the CPU.

Tolerances (f32): MoE layer and model outputs, port vs reference, within
the reference's 1e-3 (TestMoE's capacity-vs-dense bound; measured far
below it: the einsum chain reassociates); aux losses within 1e-6; the
first training step's loss (CE plus aux) within 1e-4 relative; remat
against no remat within 1e-6 (the same ops re-run); greedy tokens equal
on wide-gap weights with the top-1/top-2 gap asserted first."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import torch  # noqa: E402

from kubeflow_tpu.models import generate as ref_generate  # noqa: E402
from kubeflow_tpu.models import transformer as ref  # noqa: E402
from kubeflow_tpu.parallel.lm_train import (  # noqa: E402
    LMHyperParams as RefHP, LMTrainLoop as RefLoop)
from kubeflow_tpu.parallel.mesh import make_mesh  # noqa: E402
from kubeflow_tpu_torch.data.lm import LMDataset  # noqa: E402
from kubeflow_tpu_torch.models import transformer as port  # noqa: E402
from kubeflow_tpu_torch.models.convert import (  # noqa: E402
    params_from_jax, params_to_jax)
from kubeflow_tpu_torch.models.generate import LMGenerator  # noqa: E402
from kubeflow_tpu_torch.parallel import lm_train  # noqa: E402
from kubeflow_tpu_torch.serving.engine import DecodeEngine  # noqa: E402

TOL_MOE = 1e-3
TOL_AUX = 1e-6
TOL_LOSS = 1e-4
MIN_GAP = 1e-3
LAYER = dict(vocab_size=64, d_model=16, n_heads=2, head_dim=8, n_layers=1,
             d_ff=32, max_seq_len=32)
MODEL = dict(vocab_size=128, d_model=32, n_heads=2, head_dim=16, n_layers=2,
             d_ff=64, max_seq_len=64, n_experts=4)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def _moe_pair(dispatch, cf, E=4, K=2):
    kw = dict(LAYER, n_experts=E, expert_top_k=K, capacity_factor=cf,
              moe_dispatch=dispatch)
    return (ref.MoEFFN(ref.TransformerConfig(**kw, dtype=jnp.float32)),
            port.MoEFFN(port.TransformerConfig(**kw, dtype="float32")))


def _load_moe(mod, p):
    with torch.no_grad():
        mod.gate.kernel.copy_(
            torch.from_numpy(np.array(p["gate"]["kernel"])))
        mod.wi.copy_(torch.from_numpy(np.array(p["wi"])))
        mod.wo.copy_(torch.from_numpy(np.array(p["wo"])))
    return mod


def _x(seed, B=2, S=16, D=16):
    return np.random.default_rng(seed).normal(size=(B, S, D)).astype(
        np.float32)


@pytest.mark.parametrize("dispatch,cf", [("capacity", 1.25),
                                         ("capacity", 2.0),
                                         ("capacity", 0.25),
                                         ("dense", 1.25)])
def test_moe_layer_matches_reference(dispatch, cf):
    """The port's MoEFFN on the reference's params and inputs: output and
    Switch aux loss (capacity dispatch at the default, exact and
    dropping capacities; the dense oracle)."""
    r, p = _moe_pair(dispatch, cf)
    x = _x(3)
    params = r.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want, aux = r.apply(params, jnp.asarray(x), mutable=["aux_loss"])
    want_aux = float(jax.tree_util.tree_leaves(aux)[0])
    _load_moe(p, params["params"])
    with torch.no_grad():
        got, got_aux = p(torch.from_numpy(x))
    assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) < TOL_MOE
    assert abs(float(got_aux) - want_aux) < TOL_AUX


def test_capacity_matches_dense_at_full_capacity():
    """TestMoE: with C == S no token is dropped, so capacity dispatch is
    the dense oracle."""
    E, K = 4, 2
    x = torch.from_numpy(_x(3))
    _, dense = _moe_pair("dense", 1.25, E, K)
    _, full = _moe_pair("capacity", E / K, E, K)
    dense.reset_parameters(torch.Generator().manual_seed(0))
    dense.gate.reset_parameters(torch.Generator().manual_seed(1))
    full.load_state_dict(dense.state_dict())
    with torch.no_grad():
        y1, a1 = dense(x)
        y2, a2 = full(x)
    assert float((y1 - y2).abs().max()) < 1e-2
    assert float(a1) == pytest.approx(float(a2))


def test_capacity_drops_overflow_tokens():
    """TestMoE: under-capacity buffers drop late tokens, whose FFN output
    is exactly zero (residual passthrough), never garbage."""
    _, tight = _moe_pair("capacity", 0.25)  # C = ceil(.25*2*16/4) = 2
    tight.reset_parameters(torch.Generator().manual_seed(0))
    tight.gate.reset_parameters(torch.Generator().manual_seed(1))
    with torch.no_grad():
        y, _ = tight(torch.from_numpy(_x(4, B=1)))
    assert torch.isfinite(y).all()
    row_norms = y.abs().sum(-1)[0]
    assert int((row_norms == 0).sum()) >= 16 - 8


def test_unknown_dispatch_raises_reference_text():
    r, p = _moe_pair("bogus", 1.25)
    x = _x(0)
    with pytest.raises(ValueError) as want:
        r.init(jax.random.PRNGKey(0), jnp.asarray(x))
    with pytest.raises(ValueError) as got:
        p(torch.from_numpy(x))
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def moe_params():
    cfg = ref.TransformerConfig(**MODEL, dtype=jnp.float32)
    params = ref.TransformerLM(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def test_convert_round_trip_with_moe_leaves(moe_params):
    sd = params_from_jax(moe_params)
    assert sd["layers.1.moe.wi"].shape == (4, 32, 128)
    assert sd["layers.0.moe.gate.kernel"].shape == (32, 4)
    assert not any(".mlp." in k for k in sd)
    model = port.TransformerLM(port.TransformerConfig(**MODEL,
                                                      dtype="float32"))
    assert set(model.state_dict()) == set(sd)
    back = dict(jax.tree_util.tree_leaves_with_path(params_to_jax(sd)))
    for path, leaf in jax.tree_util.tree_leaves_with_path(moe_params):
        np.testing.assert_array_equal(back[path], leaf)


def test_init_matches_flax_distributions():
    """Distributions, not bits: the expert kernels' std within 10% of
    flax's lecun_normal over [E, in, out] (fan-in E * in)."""
    cfg = ref.TransformerConfig(**{**MODEL, "d_model": 64, "d_ff": 256},
                                dtype=jnp.float32)
    want = ref.TransformerLM(cfg).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))["params"]
    model = port.TransformerLM(
        port.TransformerConfig(**{**MODEL, "d_model": 64, "d_ff": 256},
                               dtype="float32"),
        generator=torch.Generator().manual_seed(1))
    ours = dict(jax.tree_util.tree_leaves_with_path(
        params_to_jax(model.state_dict())))
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        if "moe" in jax.tree_util.keystr(path):
            assert np.std(ours[path]) == pytest.approx(np.std(leaf),
                                                       rel=0.1), path


@pytest.mark.parametrize("dispatch,cf", [("capacity", 1.25),
                                         ("dense", 1.25)])
def test_model_logits_and_aux_match_reference(moe_params, dispatch, cf):
    kw = dict(MODEL, moe_dispatch=dispatch, capacity_factor=cf)
    tokens = np.random.default_rng(5).integers(0, 128, (2, 64)).astype(
        np.int32)
    want, aux = ref.TransformerLM(ref.TransformerConfig(
        **kw, dtype=jnp.float32)).apply(
            {"params": moe_params}, tokens, mutable=["aux_loss"])
    want_aux = np.asarray(jax.tree_util.tree_leaves(aux)[0])
    model = port.TransformerLM(port.TransformerConfig(**kw, dtype="float32"))
    model.load_state_dict(params_from_jax(moe_params))
    got_aux = []
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long(), aux_out=got_aux)
    assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) < TOL_MOE
    np.testing.assert_allclose([float(a) for a in got_aux], want_aux,
                               atol=TOL_AUX, rtol=0)


def _port_loop(params, **kw):
    loop = lm_train.LMTrainLoop(
        port.TransformerConfig(**{**MODEL, **kw}, dtype="float32"),
        lm_train.LMHyperParams(learning_rate=1e-3, total_steps=10,
                               warmup_steps=2, seed=0), device="cpu")
    loop.init_state(params_from_jax(params))
    return loop


def test_first_step_loss_with_aux_matches_reference(moe_params):
    """LMTrainLoop's loss is CE + moe_aux_weight * mean aux: the port's
    first two steps against the reference's loop from the same init on
    the same batches."""
    ds = LMDataset(vocab_size=MODEL["vocab_size"],
                   seq_len=MODEL["max_seq_len"])
    batches = list(ds.batches(4, steps=2))
    loop = _port_loop(moe_params)
    got = [loop.train_step(b)[0] for b in batches]
    mesh, plan = make_mesh(1)
    ref_loop = RefLoop(ref.TransformerConfig(**MODEL, dtype=jnp.float32),
                       mesh, plan, RefHP(learning_rate=1e-3, total_steps=10,
                                         warmup_steps=2, seed=0))
    state = ref_loop.init_state().replace(
        params=jax.tree_util.tree_map(jnp.asarray, moe_params))
    want = []
    for b in batches:
        state, loss, _ = ref_loop.train_step(state, b)
        want.append(loss)
    np.testing.assert_allclose(got, want, rtol=TOL_LOSS, atol=0)
    # The aux term is in the loss: without it the loss moves.
    plain = _port_loop(moe_params)
    plain.hp.moe_aux_weight = 0.0
    assert abs(plain.train_step(batches[0])[0] - got[0]) > 1e-5


def test_remat_policy_is_numerically_free_with_experts(moe_params):
    """tests/test_parallel.py's MoE leg: full remat and save_dense (which
    keeps the moe_wi/moe_wo products) track no remat."""
    ds = LMDataset(vocab_size=MODEL["vocab_size"],
                   seq_len=MODEL["max_seq_len"])
    batches = list(ds.batches(4, steps=3))
    losses = {}
    for policy in (None, "nothing", "save_dense"):
        kw = {} if policy is None else dict(remat=True, remat_policy=policy)
        loop = _port_loop(moe_params, **kw)
        losses[policy] = [loop.train_step(b)[0] for b in batches]
    for policy in ("nothing", "save_dense"):
        np.testing.assert_allclose(losses[policy], losses[None], rtol=1e-6,
                                   atol=0)


def test_moe_trains():
    """TestMoE's E=8 leg on one device: the loss falls."""
    loop = lm_train.LMTrainLoop(
        port.TransformerConfig(**{**MODEL, "n_experts": 8}, dtype="float32"),
        lm_train.LMHyperParams(learning_rate=1e-3, total_steps=12,
                               warmup_steps=2), device="cpu")
    loop.init_state()
    it = LMDataset(vocab_size=MODEL["vocab_size"],
                   seq_len=MODEL["max_seq_len"]).batches(8)
    losses = [loop.train_step(next(it))[0] for _ in range(8)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses


# -- serving an MoE export ----------------------------------------------------


@pytest.fixture(scope="module")
def gapped_moe(moe_params):
    """Wide-gap weights (bench.py's _spec_benchable_params: lm_head tied
    to the embedding, the residual projections scaled by 0.35) at
    capacity_factor = E / K, where C = S and no token drops, so prefill
    chunking and the verify window cannot change routing."""
    p = jax.tree_util.tree_map(np.array, moe_params)
    p["layers"]["attn"]["out"]["kernel"] *= 0.35
    p["layers"]["moe"]["wo"] *= 0.35
    p["lm_head"] = {"kernel": np.ascontiguousarray(
        p["embed"]["embedding"].T)}
    kw = dict(MODEL, capacity_factor=MODEL["n_experts"] / 2)
    return (ref.TransformerConfig(**kw, dtype=jnp.float32),
            port.TransformerConfig(**kw, dtype="float32"), p)


PROMPTS = [[5, 9, 11, 3, 7], [2], [(7 * i + 3) % 100 for i in range(40)]]
NEW = 10


def _assert_gaps(cfg_p, params):
    model = port.TransformerLM(cfg_p)
    model.load_state_dict(params_from_jax(params))
    for prompt in PROMPTS:
        toks = list(prompt)
        with torch.no_grad():
            for _ in range(NEW):
                last = model(torch.tensor([toks]))[0, -1]
                top2 = torch.topk(last, 2).values
                assert float(top2[0] - top2[1]) > MIN_GAP
                toks.append(int(torch.argmax(last)))


def test_generator_greedy_matches_reference(gapped_moe):
    cfg_r, cfg_p, params = gapped_moe
    _assert_gaps(cfg_p, params)
    want = ref_generate.LMGenerator(cfg_r, params).generate(
        PROMPTS, max_new_tokens=NEW)
    got = LMGenerator(cfg_p, params, device="cpu").generate(
        PROMPTS, max_new_tokens=NEW)
    assert [list(map(int, w)) for w in want] == got


@pytest.mark.parametrize("draft,chunk", [(0, 0), (0, 16), (1, 16)],
                         ids=["plain", "chunked", "spec"])
def test_engine_greedy_matches_generator(gapped_moe, draft, chunk):
    """The engine serves an MoE export with the oracle's greedy tokens:
    monolithic and chunked prefill, with and without a draft."""
    _, cfg_p, params = gapped_moe
    want = [LMGenerator(cfg_p, params, device="cpu").generate(
        [p], max_new_tokens=NEW)[0] for p in PROMPTS]
    eng = DecodeEngine(cfg_p, params, n_slots=2, chunk_tokens=4,
                       kv_page_size=16, prefill_chunk_tokens=chunk,
                       draft_layers=draft, device="cpu", name="moe")
    try:
        assert eng.generate(PROMPTS, max_new_tokens=NEW) == want
    finally:
        eng.close()


def test_reference_engine_chunking_under_capacity_dropping(gapped_moe):
    """The reference's own engine at the default capacity 1.25 (C < S,
    tokens can drop), chunked prefill: its greedy tokens equal its
    LMGenerator's on this fixture, so the port's serving contract (held
    at capacity E/K above) has no reference finding to log."""
    from kubeflow_tpu.serving import engine as ref_engine

    _, _, params = gapped_moe
    cfg_r = ref.TransformerConfig(**MODEL, dtype=jnp.float32)
    want = [list(map(int, ref_generate.LMGenerator(cfg_r, params).generate(
        [p], max_new_tokens=NEW)[0])) for p in PROMPTS]
    eng = ref_engine.DecodeEngine(cfg_r, params, n_slots=2, chunk_tokens=4,
                                  kv_page_size=16, prefill_chunk_tokens=16,
                                  draft_layers=0)
    try:
        assert eng.generate(PROMPTS, max_new_tokens=NEW) == want
    finally:
        eng.close()
