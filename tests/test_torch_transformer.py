"""The port's TransformerLM (kubeflow_tpu_torch/models/transformer.py)
against the reference's flax TransformerLM on the same params
(models/convert.py), plus config validation and param conversion."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from kubeflow_tpu.models import transformer as ref  # noqa: E402
from kubeflow_tpu_torch.models import transformer as port  # noqa: E402
from kubeflow_tpu_torch.models.convert import (  # noqa: E402
    params_from_jax, params_to_jax)

SMALL = dict(vocab_size=512, d_model=128, n_heads=2, head_dim=64,
             n_layers=2, d_ff=256)


def _ref_params(max_seq_len=256, seed=0):
    cfg = ref.TransformerConfig(**SMALL, max_seq_len=max_seq_len,
                                dtype=jnp.float32)
    params = ref.TransformerLM(cfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def ref_params():
    return _ref_params()


@pytest.mark.parametrize("attn_impl", ["naive", "flash"])
@pytest.mark.parametrize("S", [128, 256])
def test_logits_match_reference(ref_params, attn_impl, S):
    """f32 logits, port vs flax, same params; flash runs the Pallas
    kernels in interpret mode on the reference side and the plain
    versions on the port side. abs <= 1e-4."""
    tokens = np.random.default_rng(S).integers(0, SMALL["vocab_size"],
                                               (2, S)).astype(np.int32)
    cfg_r = ref.TransformerConfig(**SMALL, max_seq_len=256,
                                  dtype=jnp.float32, attn_impl=attn_impl)
    want = ref.TransformerLM(cfg_r).apply({"params": ref_params},
                                          jnp.asarray(tokens))
    cfg_p = port.TransformerConfig(**SMALL, max_seq_len=256,
                                   dtype="float32", attn_impl=attn_impl)
    model = port.TransformerLM(cfg_p, device="cpu")
    model.load_state_dict(params_from_jax(ref_params))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def test_bf16_residual_stream_and_f32_logits():
    """With dtype=bfloat16 the layers compute in bf16 (as flax's
    Dense/Embed with dtype=bf16) and the logits come back f32."""
    cfg = port.TransformerConfig(**SMALL, max_seq_len=128)
    assert cfg.dtype == torch.bfloat16 and cfg.param_dtype == torch.float32
    model = port.TransformerLM(cfg, generator=torch.Generator().manual_seed(0))
    seen = []
    model.layers[0].register_forward_hook(lambda m, i, o: seen.append(o))
    out = model(torch.zeros(1, 16, dtype=torch.long))
    assert seen[0].dtype == torch.bfloat16
    assert out.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_init_matches_flax_distributions(ref_params):
    """Distributions, not bits: per-leaf std within 10% of flax's draw."""
    cfg = port.TransformerConfig(**SMALL, max_seq_len=256, dtype="float32")
    model = port.TransformerLM(cfg, generator=torch.Generator().manual_seed(1))
    ours = params_to_jax(model.state_dict())
    flat_ref = jax.tree_util.tree_leaves_with_path(ref_params)
    flat_ours = dict(jax.tree_util.tree_leaves_with_path(ours))
    for path, leaf in flat_ref:
        mine = np.asarray(flat_ours[path])
        if np.std(leaf) == 0:  # norm scales
            np.testing.assert_array_equal(mine, leaf)
        else:
            assert abs(np.std(mine) / np.std(leaf) - 1) < 0.1, path


def test_params_round_trip_exact(ref_params):
    back = params_to_jax(params_from_jax({"params": ref_params}))
    a = jax.tree_util.tree_leaves_with_path(ref_params)
    b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (_, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_convert_rejects_missing_and_extra_keys(ref_params):
    bad = dict(ref_params)
    del bad["ln_f"]
    with pytest.raises(KeyError, match="ln_f/scale"):
        params_from_jax(bad)
    extra = dict(ref_params, bias={"b": np.zeros(3)})
    with pytest.raises(KeyError, match="bias/b"):
        params_from_jax(extra)
    sd = params_from_jax(ref_params)
    sd.pop("layers.1.mlp.wo.kernel")
    with pytest.raises(KeyError, match="layers.1.mlp.wo.kernel"):
        params_to_jax(sd)
    sd = params_from_jax(ref_params)
    sd["extra.weight"] = torch.zeros(1)
    with pytest.raises(KeyError, match="extra.weight"):
        params_to_jax(sd)


INVALID = [
    dict(attn_impl="bogus"),
    dict(attn_impl="ring"),
    dict(kv_page_size=-1),
    dict(kv_page_size=3, max_seq_len=8),
    dict(kv_page_size=4, max_seq_len=8, kv_pages=0),
    dict(quant="int4"),
    dict(kv_quant="int4"),
    dict(kv_quant="int8"),
    dict(lora_rank=-1),
    dict(lora_rank=2, n_experts=2),
]


@pytest.mark.parametrize("kw", INVALID, ids=lambda kw: ",".join(kw))
def test_config_validation_matches_reference(kw):
    with pytest.raises(ValueError) as want:
        ref.TransformerConfig(**kw)
    with pytest.raises(ValueError) as got:
        port.TransformerConfig(**kw)
    assert str(got.value) == str(want.value)


UNPORTED = [
    dict(n_experts=2), dict(cp=2), dict(sp=True), dict(quant="int8"),
    dict(kv_page_size=16, kv_pages=4), dict(lora_rank=4),
    # Dense decode is ported; the paged cache is the engine's.
    pytest.param(dict(decode=True, kv_page_size=16, kv_pages=4),
                 id="decode"),
    dict(remat=True), dict(loss_chunk=128),
]
# Training-only fields: every export loads and serves with them (decode
# uses neither); training with them raises.
TRAINING_ONLY = {"remat", "loss_chunk"}


@pytest.mark.parametrize("kw", UNPORTED, ids=lambda kw: ",".join(kw))
def test_unported_fields_raise_not_implemented(kw):
    ref.TransformerConfig(**kw)  # valid in the reference
    if set(kw) <= TRAINING_ONLY:
        from kubeflow_tpu_torch.parallel.lm_train import LMTrainLoop

        cfg = port.TransformerConfig(**kw)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            LMTrainLoop(cfg, device="cpu")
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port.TransformerConfig(**kw)


def test_config_defaults_match_reference():
    r, p = ref.TransformerConfig(), port.TransformerConfig()
    for f in ("vocab_size", "d_model", "n_heads", "head_dim", "n_layers",
              "d_ff", "max_seq_len", "attn_impl", "flash_min_seq",
              "flash_max_seq", "remat_policy", "lora_alpha"):
        assert getattr(r, f) == getattr(p, f), f
    assert port.PRESETS == ref.PRESETS
    with pytest.raises(ValueError, match="unknown dtype"):
        port.TransformerConfig(dtype="float16")


def test_rope_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 16, 2, 64)).astype(np.float32)
    pos = np.tile(np.arange(16, dtype=np.int32), (2, 1))
    want = ref.rope(jnp.asarray(x), jnp.asarray(pos))
    got = port.rope(torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("S,device,want", [
    (2048, "cuda", True), (2048, "cpu", False), (512, "cuda", False),
    (4096, "cuda", False), (2000, "cuda", False)])
def test_auto_picks_flash_on_cuda_inside_window(S, device, want):
    attn = port.Attention(port.TransformerConfig(**SMALL, max_seq_len=4096))
    assert attn._use_flash(S, torch.device(device)) is want
