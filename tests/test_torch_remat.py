"""Remat with the flash fwd/apply split and chunked cross-entropy in the
port (kubeflow_tpu_torch/models/transformer.py ``REMAT_POLICIES``,
ops/flash_attention.py ``flash_attention_fwd``/``_apply``,
parallel/lm_train.py ``_chunked_ce``) against the reference
(tests/test_ops.py::test_save_flash_remat_grads_match,
tests/test_parallel.py remat and loss_chunk cases), on the CPU at
attn_impl="flash", head_dim 64, S 128, so that the port runs the flash
op's plain version and the reference its Pallas kernels in interpret
mode.

Tolerances (f32): port vs reference logits, loss and grads within 1e-4
relative to each tensor's max (summation order only); port under a
policy vs the port without remat, grads within 1e-6 (the recompute
repeats the same ops); chunked vs whole-logits loss and lm_head grad
within 1e-5 relative (the chunks reassociate the sums)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from kubeflow_tpu.models import transformer as ref  # noqa: E402
from kubeflow_tpu.parallel.lm_train import (  # noqa: E402
    LMHyperParams as RefHP, LMTrainLoop as RefLoop)
from kubeflow_tpu.parallel.mesh import make_mesh  # noqa: E402
from kubeflow_tpu_torch.data.lm import LMDataset  # noqa: E402
from kubeflow_tpu_torch.models import transformer as port  # noqa: E402
from kubeflow_tpu_torch.models.convert import (  # noqa: E402
    params_from_jax, params_to_jax)
from kubeflow_tpu_torch.ops import flash_attention as fa  # noqa: E402
from kubeflow_tpu_torch.parallel import lm_train  # noqa: E402

CFG = dict(vocab_size=256, d_model=64, n_heads=2, head_dim=64, n_layers=2,
           d_ff=128, max_seq_len=128, attn_impl="flash", flash_min_seq=128)
POLICIES = ["nothing", "dots", "dots_no_batch", "save_dense", "save_flash",
            "save_flash_min", "save_flash_full",
            "save_names:attn_k,attn_v,flash_o,flash_lse"]
# Policies whose save set keeps the flash forward's (o, lse): their
# backward launches no forward.
KEEPS_FLASH = {"save_flash", "save_flash_min", "save_flash_full",
               "save_names:attn_k,attn_v,flash_o,flash_lse"}
TOL_REF = 1e-4
TOL_SELF = 1e-6
TOL_CHUNK = 1e-5


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


@pytest.fixture(scope="module")
def setup():
    """(reference param tree as numpy, tokens [2, S + 1])."""
    cfg = ref.TransformerConfig(**CFG, dtype=jnp.float32)
    tokens = np.random.default_rng(11).integers(
        0, CFG["vocab_size"], (2, CFG["max_seq_len"] + 1)).astype(np.int32)
    params = ref.TransformerLM(cfg).init(
        jax.random.PRNGKey(0), jnp.asarray(tokens[:, :-1]))["params"]
    return jax.tree_util.tree_map(np.asarray, params), tokens


def _kw(policy):
    return {} if policy is None else dict(remat=True, remat_policy=policy)


@pytest.fixture(scope="module")
def jax_runs(setup):
    """The reference's (logits, loss, grads) under a policy (None = no
    remat), computed once each."""
    params, tokens = setup
    made = {}

    def get(policy):
        if policy not in made:
            model = ref.TransformerLM(ref.TransformerConfig(
                **CFG, dtype=jnp.float32, **_kw(policy)))
            inputs, targets = tokens[:, :-1], tokens[:, 1:]

            def loss_fn(p):
                logits = model.apply({"params": p}, inputs)
                ce = optax.softmax_cross_entropy_with_integer_labels(
                    logits, targets).mean()
                return ce, logits

            (loss, logits), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params)
            made[policy] = (np.asarray(logits), float(loss),
                            jax.tree_util.tree_map(np.asarray, grads))
        return made[policy]
    return get


def _port_run(setup, policy):
    """The port's (logits, loss, grads as a reference tree, plain-forward
    calls in the forward, in the backward)."""
    params, tokens = setup
    model = port.TransformerLM(port.TransformerConfig(
        **CFG, dtype="float32", **_kw(policy)))
    model.load_state_dict(params_from_jax(params))
    tok = torch.from_numpy(tokens).long()
    calls = []
    real = fa._fwd_reference

    def counted(*a):
        calls.append(1)
        return real(*a)

    fa._fwd_reference = counted
    try:
        logits = model(tok[:, :-1])
        n_fwd = len(calls)
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               tok[:, 1:].reshape(-1))
        loss.backward()
    finally:
        fa._fwd_reference = real
    grads = params_to_jax({k: p.grad for k, p in model.named_parameters()})
    return (logits.detach().numpy(), float(loss.detach()), grads, n_fwd,
            len(calls) - n_fwd)


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


@pytest.mark.parametrize("policy", [None] + POLICIES)
def test_port_matches_reference_under_policy(setup, jax_runs, policy):
    """Same params, same tokens: logits, loss and every grad of the port
    under a policy against the reference under the same policy."""
    logits, loss, grads, _, _ = _port_run(setup, policy)
    want_logits, want_loss, want_grads = jax_runs(policy)
    assert _rel(logits, want_logits) <= TOL_REF
    assert abs(loss - want_loss) <= TOL_REF * abs(want_loss)
    ours = _leaves(grads)
    for path, want in _leaves(want_grads).items():
        assert _rel(ours[path], want) <= TOL_REF, path


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_grads_equal_no_remat(setup, policy):
    """Remat is a scheduling choice: the port's grads under each policy
    equal its grads without remat."""
    _, loss0, grads0, _, _ = _port_run(setup, None)
    _, loss, grads, _, _ = _port_run(setup, policy)
    assert abs(loss - loss0) <= TOL_SELF * abs(loss0)
    ours = _leaves(grads)
    for path, want in _leaves(grads0).items():
        assert _rel(ours[path], want) <= TOL_SELF, path


@pytest.mark.parametrize("policy", [None] + POLICIES)
def test_backward_runs_the_forward_only_without_saved_flash(setup, policy):
    """The fwd/apply split: a policy that keeps (o, lse) runs the flash
    forward L times a step (the forward pass), full remat and the
    policies that do not keep them 2L (the recompute re-runs it)."""
    L = CFG["n_layers"]
    _, _, _, n_fwd, n_bwd = _port_run(setup, policy)
    assert n_fwd == L
    want = 0 if policy is None or policy in KEEPS_FLASH else L
    assert n_bwd == want


def test_save_flash_full_saves_the_reference_set():
    """save_flash_full keeps q/k/v, attn_out, mlp_wo and the flash
    residuals: its recompute runs one product a layer (mlp_wi), full
    remat five (wo's output is not needed by the backward), save_dense
    none."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.mm = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.mm += func is torch.ops.aten.mm.default
            return func(*args, **(kwargs or {}))

    tok = torch.randint(0, CFG["vocab_size"], (2, CFG["max_seq_len"]),
                        generator=torch.Generator().manual_seed(0))
    counts = {}
    for policy in (None, "nothing", "save_dense", "save_flash_full"):
        model = port.TransformerLM(
            port.TransformerConfig(**CFG, dtype="float32", **_kw(policy)),
            generator=torch.Generator().manual_seed(1))
        out = model(tok)
        with Count() as c:
            out.pow(2).mean().backward()
        counts[policy] = c.mm
    L = CFG["n_layers"]
    assert counts["save_dense"] == counts[None]
    assert counts["save_flash_full"] == counts[None] + L
    assert counts["nothing"] == counts[None] + 5 * L


def test_unknown_policy_rejected_with_reference_text():
    with pytest.raises(ValueError) as want:
        ref.TransformerLM(ref.TransformerConfig(
            **CFG, remat=True, remat_policy="bogus")).init(
                jax.random.PRNGKey(0), np.zeros((1, 8), np.int32))
    with pytest.raises(ValueError) as got:
        port.TransformerLM(port.TransformerConfig(
            **CFG, remat=True, remat_policy="bogus"))
    assert str(got.value) == str(want.value)
    assert "remat_policy" in str(got.value)


def test_return_hidden_matches_reference(setup):
    params, tokens = setup
    cfg = ref.TransformerConfig(**CFG, dtype=jnp.float32)
    want = ref.TransformerLM(cfg).apply({"params": params},
                                        tokens[:, :-1], return_hidden=True)
    model = port.TransformerLM(port.TransformerConfig(**CFG,
                                                      dtype="float32"))
    model.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens[:, :-1]).long(),
                    return_hidden=True)
    assert got.shape == (2, CFG["max_seq_len"], CFG["d_model"])
    assert _rel(got.numpy(), np.asarray(want)) <= TOL_REF


def _loop(params, policy=None, **cfg_kw):
    cfg = port.TransformerConfig(**{**CFG, **cfg_kw}, dtype="float32",
                                  **_kw(policy))
    loop = lm_train.LMTrainLoop(
        cfg, lm_train.LMHyperParams(total_steps=10, warmup_steps=2,
                                    seed=0), device="cpu")
    loop.init_state(params_from_jax(params))
    return loop


def test_remat_policy_is_numerically_free(setup):
    """tests/test_parallel.py's dense leg: 4 steps under full remat and
    save_dense track each other and the reference's loop under
    save_dense, from the same init on the same batches."""
    params, _ = setup
    ds = LMDataset(vocab_size=CFG["vocab_size"], seq_len=CFG["max_seq_len"])
    batches = list(ds.batches(4, steps=4))
    losses = {}
    for policy in ("nothing", "save_dense"):
        loop = _loop(params, policy)
        losses[policy] = [loop.train_step(b)[0] for b in batches]
    np.testing.assert_allclose(losses["nothing"], losses["save_dense"],
                               rtol=TOL_SELF, atol=0)
    mesh, plan = make_mesh(1)
    ref_loop = RefLoop(ref.TransformerConfig(
        **CFG, dtype=jnp.float32, remat=True, remat_policy="save_dense"),
        mesh, plan, RefHP(total_steps=10, warmup_steps=2, seed=0))
    state = ref_loop.init_state().replace(
        params=jax.tree_util.tree_map(jnp.asarray, params))
    want = []
    for b in batches:
        state, loss, _ = ref_loop.train_step(state, b)
        want.append(loss)
    np.testing.assert_allclose(losses["save_dense"], want, rtol=TOL_REF,
                               atol=0)


def _loss_and_head_grad(loop, tokens):
    loss, acc = loop._loss_fn(loop._tokens(tokens))
    loss.backward()
    grad = loop.model.lm_head.kernel.grad.clone()
    loop.model.zero_grad(set_to_none=True)
    return float(loss.detach()), float(acc), grad


@pytest.mark.parametrize("chunk", [16, 64])
def test_chunked_ce_matches_whole_logits(setup, chunk):
    """loss_chunk is a scheduling choice: loss, accuracy and the lm_head
    grad equal the whole-logits path's; the loss and accuracy equal the
    reference's chunked evaluation on the same params."""
    params, tokens = setup
    whole = _loss_and_head_grad(_loop(params), tokens)
    chunked = _loss_and_head_grad(_loop(params, loss_chunk=chunk), tokens)
    assert abs(chunked[0] - whole[0]) <= TOL_CHUNK * abs(whole[0])
    assert chunked[1] == whole[1]
    assert _rel(chunked[2].numpy(), whole[2].numpy()) <= TOL_CHUNK
    mesh, plan = make_mesh(1)
    ref_loop = RefLoop(ref.TransformerConfig(
        **CFG, dtype=jnp.float32, loss_chunk=chunk), mesh, plan, RefHP())
    state = ref_loop.init_state().replace(
        params=jax.tree_util.tree_map(jnp.asarray, params))
    m = ref_loop.evaluate(state, tokens)
    assert abs(chunked[0] - m["loss"]) <= TOL_REF * abs(m["loss"])
    assert abs(chunked[1] - m["accuracy"]) <= 1e-6


def test_chunked_ce_under_remat_trains(setup):
    """The long-context composition (save_flash_min with loss_chunk):
    two steps equal the no-remat, whole-logits loop's."""
    params, _ = setup
    ds = LMDataset(vocab_size=CFG["vocab_size"], seq_len=CFG["max_seq_len"])
    batches = list(ds.batches(2, steps=2))
    a = _loop(params)
    b = _loop(params, "save_flash_min", loss_chunk=32)
    la = [a.train_step(t)[0] for t in batches]
    lb = [b.train_step(t)[0] for t in batches]
    np.testing.assert_allclose(lb, la, rtol=TOL_CHUNK, atol=0)


def test_loss_chunk_must_divide_seq(setup):
    params, tokens = setup
    loop = _loop(params, loss_chunk=7)
    with pytest.raises(ValueError, match="loss_chunk"):
        loop.train_step(tokens)
