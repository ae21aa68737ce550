"""The benchmark's operation and byte counts against hand-worked
numbers."""

from __future__ import annotations

import json

import pytest

from kfxbench.core import flops, weights
from conftest import ROOT


def _cfg(name):
    return json.loads((ROOT / "kfxbench" / "configs" /
                       f"{name}.json").read_text())


def test_coder_train_flops_per_token():
    cfg = _cfg("deepseek-coder-1.3b")
    # Per layer: qkv 2*2048*6144, out 2*2048*2048, SwiGLU 6*2048*5504;
    # head 2*2048*32256; attention 4*2048 a key, causal (4096+1)/2 keys.
    body = 24 * (25_165_824 + 8_388_608 + 67_633_152)
    head = 132_120_576
    attn_full = 24 * 4 * 2048 * 4096
    assert flops.train_flops_per_token(cfg, 4096, causal=False) == \
        3 * (body + head + attn_full)
    assert flops.train_flops_per_token(cfg, 4096, causal=False) == \
        pytest.approx(10.10e9, rel=1e-3)
    assert flops.train_flops_per_token(cfg, 4096) == \
        pytest.approx(8.890e9, rel=1e-3)


def test_full_square_count_matches_the_ports():
    from kubeflow_tpu_torch.utils.flops import \
        transformer_train_flops_per_token
    from kfxbench.drivers.train import model_config

    cfg = _cfg("deepseek-coder-1.3b")
    assert flops.train_flops_per_token(cfg, 4096, causal=False) == \
        pytest.approx(transformer_train_flops_per_token(
            model_config(cfg, 4096), 4096))


def test_kv_bytes_and_params_of_the_7b():
    cfg = _cfg("deepseek-llm-7b")
    assert flops.kv_bytes_per_token(cfg) == 491_520
    assert weights.n_params(cfg) == 6_910_365_696
    coder = _cfg("deepseek-coder-1.3b")
    assert weights.n_params(coder) == 1_346_471_936


def test_serving_counts_add_up():
    cfg = _cfg("deepseek-llm-7b")
    n = 100
    whole = flops.prompt_flops(cfg, n)
    by_token = sum(flops.body_matmul_flops(cfg)
                   + flops.attention_flops_at(cfg, p + 1)
                   for p in range(n)) + flops.head_flops(cfg)
    assert whole == pytest.approx(by_token)
    assert flops.decode_flops(cfg, 0) == pytest.approx(
        flops.prompt_flops(cfg, 1))


def test_flash_least_time_at_the_cell():
    got = flops.flash_least_seconds(4, 4096, 16, 128)
    pairs = 4096 * 4097 / 2
    assert got["flops"] == 6 * 2 * 4 * 16 * 128 * pairs
    tensor = 4 * 4096 * 16 * 128 * 2
    assert got["bytes"] == 12 * tensor + 3 * 4 * 4096 * 16 * 4
    assert got["bound"] == "compute"
    assert got["seconds"] == pytest.approx(got["flops"] / 989e12)
