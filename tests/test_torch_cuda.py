"""Card tests of the port's CUDA kernels (kubeflow_tpu_torch/ops/csrc) and
of the paths that launch them. JAX-free, so they run on a machine with a GPU
and no JAX:

    python -m pytest tests/test_torch_cuda.py -q

Each test skips where torch.cuda.is_available() is false, naming the
kernels it needs."""

import math

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("flash_fwd/flash_dq/flash_dkv CUDA kernels "
                    "(ops/csrc/flash_fwd.cu, flash_bwd.cu) need an NVIDIA "
                    "GPU; torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, seed, device, dtype):
    rng = np.random.default_rng(seed)
    D = shape[-1]
    xs = [rng.normal(size=shape) / math.sqrt(D)] + [
        rng.normal(size=shape) for _ in range(3)]
    return [torch.from_numpy(x.astype(np.float32)).to(device, dtype)
            for x in xs]


def _rel(a, b):
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("D", [64, 128, 192, 256])
def test_kernels_match_plain_version(cuda, dtype, D):
    """Each kernel against its plain version on the same inputs. bf16:
    outputs round once to bf16, so 2e-2 (the reference's bound); f32:
    only summation order differs, 1e-4."""
    dt = getattr(torch, dtype)
    q, k, v, do = _inputs((2, 256, 2, D), D, cuda, dt)
    before = dict(fa.LAUNCHES)
    o, lse = fa._fwd(q, k, v)
    o_r, lse_r = fa._fwd_reference(q, k, v)
    delta = torch.sum(do.float() * o_r.float(), -1, keepdim=True)
    dq = fa._dq(q, k, v, do, lse_r, delta)
    dk, dv = fa._dkv(q, k, v, do, lse_r, delta)
    dq_r = fa._dq_reference(q, k, v, do, lse_r, delta)
    dk_r, dv_r = fa._dkv_reference(q, k, v, do, lse_r, delta)
    torch.cuda.synchronize()
    assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}
    assert o.dtype == dt and lse.dtype == torch.float32
    tol = 2e-2 if dt == torch.bfloat16 else 1e-4
    assert float((o.float() - o_r.float()).abs().max()) <= tol
    assert float((lse - lse_r).abs().max()) <= 1e-3
    for a, b in ((dq, dq_r), (dk, dk_r), (dv, dv_r)):
        assert _rel(a, b) <= tol


def test_autograd_on_cuda_matches_cpu(cuda):
    """The autograd Function on CUDA tensors (the kernels) against the
    same Function on CPU tensors (the plain versions), f32."""
    q, k, v, do = _inputs((1, 384, 2, 64), 7, "cpu", torch.float32)
    outs = {}
    for dev in ("cpu", cuda):
        xs = [x.to(dev).requires_grad_() for x in (q, k, v)]
        out = fa.flash_attention(*xs)
        grads = torch.autograd.grad(out, xs, do.to(dev))
        outs[str(dev)] = [t.detach().cpu() for t in (out, *grads)]
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert _rel(a, b) <= 1e-4


def test_kernels_reject_what_they_do_not_take(cuda):
    x = torch.zeros(1, 128, 1, 320, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa._fwd(x, x, x)
    y = torch.zeros(1, 128, 1, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fa._fwd(y, y, y)


def test_model_auto_launches_kernels(cuda):
    from kubeflow_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM)

    cfg = TransformerConfig(vocab_size=512, d_model=128, n_heads=2,
                            head_dim=64, n_layers=2, d_ff=256,
                            max_seq_len=1024)
    model = TransformerLM(cfg, device=cuda,
                          generator=torch.Generator(cuda).manual_seed(0))
    tokens = torch.randint(0, 512, (1, 1024), device=cuda)
    fa.reset_launches()
    loss = model(tokens).logsumexp(-1).mean()
    loss.backward()
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"flash_fwd": 2, "flash_dq": 2, "flash_dkv": 2}
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


def test_runner_on_cuda_goes_through_kernels(cuda, capsys):
    from kubeflow_tpu_torch.runners import lm_runner

    fa.reset_launches()
    rc = lm_runner.main(["--preset", "small", "--dataset", "lm-small",
                         "--seq-len", "1024", "--steps", "2",
                         "--batch-size", "1", "--log-every", "1"])
    out = capsys.readouterr().out
    assert rc == 0 and "device=cuda" in out and "train_done" in out
    assert fa.LAUNCHES == {"flash_fwd": 8 * 3, "flash_dq": 8 * 2,
                           "flash_dkv": 8 * 2}
