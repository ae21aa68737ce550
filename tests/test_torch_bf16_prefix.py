"""Queue C 1 on the CPU: in bf16, do an engine's greedy tokens depend on
the prefix-cache state? The same prompts run cold, then warm (their pages
cached), through the JAX DecodeEngine and the port's
(kubeflow_tpu_torch/serving/engine.py), without a draft and with one, on
the reference's tiny fixture in bf16 with raw-init weights."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.models import transformer as ref  # noqa: E402
from kubeflow_tpu.serving import engine as ref_engine  # noqa: E402
from kubeflow_tpu_torch.models import transformer as port  # noqa: E402
from kubeflow_tpu_torch.serving.engine import DecodeEngine  # noqa: E402

from test_torch_generate import TINY  # noqa: E402


@pytest.mark.parametrize("draft", [0, 1], ids=["plain", "spec"])
def test_bf16_greedy_is_prefix_cache_invariant_on_cpu(draft):
    """Cold, then warm (every prompt's pages cached): in bf16 on the CPU
    the greedy tokens do not change, in the JAX engine or the port's, with
    a draft or without. (On the card they can: PERF.md, Queue C 1.)"""
    cfg_r = ref.TransformerConfig(**TINY, dtype=jnp.bfloat16)
    params = jax.tree_util.tree_map(np.asarray, ref.TransformerLM(
        cfg_r).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)
                    )["params"])
    cfg_p = port.TransformerConfig(**TINY, dtype="bfloat16")
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(0, 64, n))) for n in (40, 35, 20)]
    kw = dict(n_slots=4, chunk_tokens=4, kv_page_size=16, kv_pages=48,
              propose_tokens=4)
    for eng in (ref_engine.DecodeEngine(cfg_r, params, draft_layers=draft,
                                        **kw),
                DecodeEngine(cfg_p, params, draft_layers=draft, device="cpu",
                             **kw)):
        try:
            cold = eng.generate(prompts, max_new_tokens=16)
            reused = eng.prefix_stats()["tokens_reused"]
            assert eng.generate(prompts, max_new_tokens=16) == cold
            assert eng.prefix_stats()["tokens_reused"] - reused > 0
        finally:
            eng.close()
