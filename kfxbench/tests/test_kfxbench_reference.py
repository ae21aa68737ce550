"""The frozen reference against the port at a tiny size, so that drift of
either shows: the port in float32 trains and serves as the reference
does."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from conftest import tiny_context
from kfxbench.core import compare, weights
from kfxbench.reference import lm as ref_lm


def test_training_reference_follows_the_port_in_f32():
    from kfxbench.drivers import train as T

    ctx = tiny_context("coder1.3b-train-s4k", seed=41)
    ctx.config["port"] = dict(ctx.config["port"], dtype="float32")
    data = T.batches(ctx)
    loop = T.build(ctx)
    program = T.checked_steps(ctx, loop, data)
    ref = T.reference(ctx, data)
    numbers = compare.train_numbers(program, ref)
    assert numbers["loss_gap"] < 1e-5
    assert numbers["grad_gap"] < 1e-4
    assert numbers["change_gap"] < 1e-4


def test_serving_reference_matches_the_ports_forward():
    from kubeflow_tpu_torch.models.transformer import TransformerLM
    from kfxbench.drivers import serve as S

    ctx = tiny_context("dsllm7b-serve-chat", seed=43)
    cfg = dataclasses.replace(S.model_config(ctx.config),
                              dtype=torch.float32,
                              param_dtype=torch.float32)
    w = weights.make(ctx.config, 43, torch.float32, torch.device("cpu"))
    model = TransformerLM(cfg, device="cpu")
    model.load_state_dict(w)
    prompt = list(range(5, 40))
    served = [7, 300, 11, 2]
    with torch.no_grad():
        full = model(torch.tensor([prompt + served[:-1]]))[0]
    ref = ref_lm.served_logits(w, [(prompt, served)], ref_lm.Matmul())[0]
    torch.testing.assert_close(ref, full[len(prompt) - 1:], rtol=1e-4,
                               atol=1e-4)
    gap = ref_lm.served_gaps([ref], [ref.argmax(-1).tolist()])
    assert gap == [0.0]


def test_fp8_products_are_coarser_than_f32():
    torch.manual_seed(0)
    a, b = torch.randn(64, 128), torch.randn(128, 32)
    exact = a @ b
    err = (ref_lm.Matmul("fp8")(a, b) - exact).abs().max()
    assert 1e-3 < float(err) < 0.5 * float(exact.abs().max())


def test_adamw_schedule_is_the_ports():
    from kubeflow_tpu_torch.parallel.lm_train import warmup_cosine_lr

    for count in (0, 1, 49, 50, 51, 120, 199, 200, 500):
        assert ref_lm.warmup_cosine(count, 3e-4, 50, 200) == \
            pytest.approx(warmup_cosine_lr(count, 3e-4, 50, 200))


def test_small_leaves_are_judged_against_their_own_norm():
    ref = {"losses": [2.0], "raw_grad_norms": {"a": 1.0, "b": 1.0,
                                               "s": 0.02, "z": 1e-6},
           "grad_norms": {"a": 1.0, "b": 1.0, "s": 0.02, "z": 1e-6},
           "change_norms": {"a": 1.0, "b": 1.2, "s": 0.02, "z": 1e-5}}
    prog = {"losses": [2.0], "grad_norms": dict(ref["grad_norms"], s=0.022),
            "change_norms": dict(ref["change_norms"], s=0.024, z=1.0)}
    got = compare.train_numbers(prog, ref)
    # Against the median leaf the scale's gaps are small ...
    assert got["grad_gap"] == pytest.approx(0.002 / 0.51)
    assert got["change_gap"] == pytest.approx(0.004 / 1.0)
    # ... against its own norm they are 10% and 20%; the unmoved leaf
    # ``z`` is left out of the change.
    assert got["grad_gap_small"] == pytest.approx(0.1)
    assert got["change_gap_small"] == pytest.approx(0.2)
