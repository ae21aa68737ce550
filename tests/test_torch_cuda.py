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
                    "(ops/csrc/flash_fwd.cu, flash_bwd.cu, "
                    "flash_fwd_wgmma.cu, flash_dq_wgmma.cu, "
                    "flash_dkv_wgmma.cu) need an NVIDIA GPU; "
                    "torch.cuda.is_available() is false")
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
    outputs round once to bf16 (and, in the wgmma design at D 64/128, P
    and dS before their second products), so 2e-2 (the reference's
    bound); f32 (the FMA design): only summation order differs, 1e-4."""
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


def _wgmma_run(q, k, v, do):
    """The three kernels on bf16 inputs (the wgmma design), the dQ and
    dK/dV kernels fed the plain forward's lse and delta."""
    o, lse = fa._fwd(q, k, v)
    o_r, lse_r = fa._fwd_reference(q, k, v)
    delta = torch.sum(do.float() * o_r.float(), -1, keepdim=True)
    dq = fa._dq(q, k, v, do, lse_r, delta)
    dk, dv = fa._dkv(q, k, v, do, lse_r, delta)
    return (o, lse, dq, dk, dv), (o_r, lse_r, delta)


@pytest.mark.parametrize("shape", [(2, 2048, 4, 64), (1, 2048, 4, 128),
                                   (1, 320, 2, 64), (1, 320, 2, 128),
                                   (1, 64, 2, 64), (3, 192, 3, 128)])
def test_wgmma_kernels_match_plain_version(cuda, shape):
    """flash_fwd, flash_dq and flash_dkv in their wgmma design (bf16, D
    64/128; S = 320 and 192 leave a ragged half tile, S % 128 == 64, and
    S = 64 is less than one tile) against the plain versions: o 2e-2 abs,
    lse 1e-3 abs, dq/dk/dv 2e-2 relative to the max, chip_smoke.py's
    bounds. The new rounding is P and dS to bf16 before their second
    products (tests/test_torch_flash.py bounds it on the CPU)."""
    for name in fa.LAUNCHES:
        assert fa.design(torch.bfloat16, shape[-1], name) == "wgmma"
    q, k, v, do = _inputs(shape, 11, cuda, torch.bfloat16)
    before = dict(fa.LAUNCHES)
    (o, lse, dq, dk, dv), (o_r, lse_r, delta) = _wgmma_run(q, k, v, do)
    dq_r = fa._dq_reference(q, k, v, do, lse_r, delta)
    dk_r, dv_r = fa._dkv_reference(q, k, v, do, lse_r, delta)
    torch.cuda.synchronize()
    assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}
    assert bool(torch.isfinite(o.float()).all())
    assert bool(torch.isfinite(dq.float()).all())
    assert float((o.float() - o_r.float()).abs().max()) <= 2e-2
    assert float((lse - lse_r).abs().max()) <= 1e-3
    assert _rel(dq, dq_r) <= 2e-2
    assert _rel(dk, dk_r) <= 2e-2
    assert _rel(dv, dv_r) <= 2e-2


@pytest.mark.parametrize("D", [64, 128])
def test_wgmma_kernels_are_deterministic(cuda, D):
    """Two runs of each wgmma kernel on the same inputs are bit-identical
    (no atomics; every output element is written once)."""
    q, k, v, do = _inputs((2, 1024, 4, D), 5, cuda, torch.bfloat16)
    first, _ = _wgmma_run(q, k, v, do)
    second, _ = _wgmma_run(q, k, v, do)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_wgmma_inputs_at_odd_offsets(cuda):
    """A bf16 view that starts 2 bytes into its allocation is copied to an
    aligned tensor before a TMA-fed kernel sees it (forward and dQ);
    _launch itself refuses it."""
    q, k, v, do = _inputs((1, 256, 2, 64), 3, cuda, torch.bfloat16)
    buf = torch.empty(q.numel() + 1, dtype=torch.bfloat16, device=cuda)
    q_odd = buf[1:].view(q.shape)
    q_odd.copy_(q)
    assert q_odd.data_ptr() % 16
    o, _ = fa._fwd(q_odd, k, v)
    o_r, lse_r = fa._fwd_reference(q, k, v)
    assert float((o.float() - o_r.float()).abs().max()) <= 2e-2
    delta = torch.sum(do.float() * o_r.float(), -1, keepdim=True)
    dq = fa._dq(q_odd, k, v, do, lse_r, delta)
    assert _rel(dq, fa._dq_reference(q, k, v, do, lse_r, delta)) <= 2e-2
    lse = torch.empty(1, 256, 2, 1, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        fa._launch("flash_fwd", q_odd, k, v, torch.empty_like(q), lse)
    with pytest.raises(ValueError, match="aligned"):
        fa._launch("flash_dq", q_odd, k, v, do, lse_r, delta,
                   torch.empty_like(q))


def test_base_preset_launches_through_wgmma(cuda, capsys):
    """The main path's configuration (base preset, bf16, D = 64) takes the
    wgmma design, and the runner's launch counts are what they were: per
    train step one forward, one dQ and one dK/dV launch a layer, plus one
    forward a layer for the eval batch."""
    from kubeflow_tpu_torch.models.transformer import preset_config
    from kubeflow_tpu_torch.runners import lm_runner

    cfg = preset_config("base")
    assert cfg.dtype == torch.bfloat16 and cfg.head_dim == 64
    assert fa.design(torch.bfloat16, 64) == "wgmma"
    assert fa.design(torch.bfloat16, 64, "flash_dkv") == "wgmma"
    assert fa.design(torch.bfloat16, 64, "flash_dq") == "wgmma"
    fa.reset_launches()
    rc = lm_runner.main(["--preset", "base", "--dataset", "lm-small",
                         "--steps", "2", "--batch-size", "1",
                         "--warmup-steps", "1", "--log-every", "1"])
    out = capsys.readouterr().out
    assert rc == 0 and "seq_len=2048" in out
    L = cfg.n_layers
    assert fa.LAUNCHES == {"flash_fwd": L * 2 + L, "flash_dq": L * 2,
                           "flash_dkv": L * 2}


def test_autograd_on_cuda_matches_cpu(cuda):
    """The autograd Function on CUDA tensors (the kernels) against the
    same Function on CPU tensors (the plain versions), f32 (the FMA
    design alone)."""
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
