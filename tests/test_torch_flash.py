"""The port's flash attention (kubeflow_tpu_torch/ops/flash_attention.py)
against the reference's Pallas kernels (kubeflow_tpu/ops/flash_attention.py,
interpret mode) on the same numpy-seeded inputs.

On the CPU the port runs the plain PyTorch version of each kernel; the CUDA
kernels themselves are compared with those plain versions on the card
(``cuda`` marker) and by chip_smoke.py."""

import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import importlib  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

# The package re-exports a function of the same name; take the module.
ref = importlib.import_module("kubeflow_tpu.ops.flash_attention")  # noqa: E402
from kubeflow_tpu_torch.ops import flash_attention as port  # noqa: E402

SHAPES = [(2, 256, 2, 64), (1, 384, 1, 64), (1, 256, 2, 128)]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    D = shape[-1]
    q = (rng.normal(size=shape) / math.sqrt(D)).astype(np.float32)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    do = rng.normal(size=shape).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_reference_kernel(shape):
    """o and lse of the plain forward vs the Pallas _fwd_kernel, f32:
    both compute in f32 with the same blocking, so only summation order
    differs (abs <= 1e-5)."""
    q, k, v, _ = _inputs(shape, 0)
    o_r, lse_r = ref.flash_attention_fwd(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), interpret=True)
    o, lse = port.flash_attention_fwd(torch.from_numpy(q),
                                      torch.from_numpy(k),
                                      torch.from_numpy(v))
    assert tuple(lse.shape) == shape[:3] + (1,)
    assert lse.dtype == torch.float32 and o.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(o_r), atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_r), atol=1e-5,
                               rtol=0)
    assert sum(port.LAUNCHES.values()) == 0  # CPU: no kernel launched


@pytest.mark.parametrize("shape", SHAPES)
def test_gradients_match_reference_kernel(shape):
    """autograd through the port's Function (plain dQ and dK/dV) vs
    jax.grad through the reference's custom VJP (Pallas _dq_kernel and
    _dkv_kernel): relative to the max, <= 1e-4."""
    q, k, v, do = _inputs(shape, 1)

    def ref_loss(q, k, v):
        return jnp.sum(ref.flash_attention(q, k, v, interpret=True) * do)

    g_ref = jax.grad(ref_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = port.flash_attention(tq, tk, tv)
    g_port = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    for name, a, b in zip("qkv", g_port, g_ref):
        b = np.asarray(b)
        err = np.max(np.abs(a.numpy() - b)) / np.max(np.abs(b))
        assert err <= 1e-4, f"d{name}: {err}"


@pytest.mark.parametrize("s,want", [(2048, 256), (256, 256), (384, 128),
                                    (640, 128), (96, 96), (8, 8), (7, 7)])
def test_pick_block(s, want):
    assert port._pick_block(s) == ref._pick_block(s) == want
    assert port._pick_block(s, 64) == ref._pick_block(s, 64)


@pytest.mark.parametrize("s,d", [(512, 64), (2048, 128), (256, 256),
                                 (500, 64), (512, 80), (128, 32), (1024, 192)])
def test_supported_matches_reference(s, d):
    assert port.supported(s, d) == ref.supported(s, d)


def test_cuda_tensors_never_take_the_plain_path():
    """Dispatch is by device only: a non-CPU, non-CUDA tensor is refused
    instead of running the plain version."""
    x = torch.zeros(1, 128, 1, 64, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        port.flash_attention_fwd(x, x, x)


@pytest.mark.parametrize("D", [64, 128, 192, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_design_is_a_function_of_dtype_and_head_dim(dtype, D):
    """Every (dtype, D) that _launch accepts: all three kernels run on the
    tensor cores ("wgmma") for bf16 at D 64/128 and as f32 FMA
    otherwise."""
    wgmma = dtype == torch.bfloat16 and D in (64, 128)
    assert port.design(dtype, D) == port.design(dtype, D, "flash_fwd")
    assert port.design(dtype, D, "flash_fwd") == ("wgmma" if wgmma else "fma")
    assert port.design(dtype, D, "flash_dkv") == ("wgmma" if wgmma else "fma")
    assert port.design(dtype, D, "flash_dq") == ("wgmma" if wgmma else "fma")


def test_design_rejects_unknown_kernels():
    with pytest.raises(ValueError, match="unknown kernel"):
        port.design(torch.bfloat16, 64, "flash_bwd")


# The wgmma kernels' rounding, emulated in plain torch: bf16 operands with
# products summed in f32 (a product of two bf16 numbers is exact in f32),
# the forward's online softmax over the kernel's own tiles (128 query rows;
# 128 keys at D = 64, 64 at D = 128) with P rounded to bf16 before P V,
# P^T and dS^T rounded to bf16 before the dV and dK products, and dS (P in
# f32) rounded to bf16 before dS K.

def _bf16(x):
    return x.to(torch.bfloat16).float()


def _emulate_wgmma_fwd(q, k, v):
    B, S, H, D = q.shape
    bq, bk = 128, (128 if D == 64 else 64)
    qt, kt, vt = port._heads_first(q, k, v)
    o = torch.empty_like(qt)
    lse = torch.empty(B, H, S, 1)
    for q0 in range(0, S, bq):
        rows = slice(q0, min(q0 + bq, S))
        qb = qt[:, :, rows]
        n = qb.shape[2]
        m = torch.full((B, H, n, 1), port.NEG_INF)
        den = torch.zeros(B, H, n, 1)
        acc = torch.zeros_like(qb)
        for k0 in range(0, q0 + n, bk):
            cols = slice(k0, min(k0 + bk, S))
            s = qb @ kt[:, :, cols].transpose(-1, -2)
            s = torch.where(port._causal_mask(q0, n, k0, s.shape[-1], "cpu"),
                            s, port.NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            den = den * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + _bf16(p) @ vt[:, :, cols]
            m = m_new
        o[:, :, rows] = acc / den
        lse[:, :, rows] = m + torch.log(den)
    return port._seq_first(o, q.dtype), port._seq_first(lse, torch.float32)


def _emulate_wgmma_dkv(q, k, v, do, lse, delta):
    S = q.shape[1]
    qt, kt, vt, dot, lset, dt = port._heads_first(q, k, v, do, lse, delta)
    s = qt @ kt.transpose(-1, -2)
    p = torch.where(port._causal_mask(0, S, 0, S, "cpu"),
                    torch.exp(s - lset), 0.0)
    dv = _bf16(p).transpose(-1, -2) @ dot
    ds = p * (dot @ vt.transpose(-1, -2) - dt)
    dk = _bf16(ds).transpose(-1, -2) @ qt
    return port._seq_first(dk, k.dtype), port._seq_first(dv, v.dtype)


def _emulate_wgmma_dq(q, k, v, do, lse, delta):
    S = q.shape[1]
    qt, kt, vt, dot, lset, dt = port._heads_first(q, k, v, do, lse, delta)
    s = qt @ kt.transpose(-1, -2)
    p = torch.where(port._causal_mask(0, S, 0, S, "cpu"),
                    torch.exp(s - lset), 0.0)
    ds = p * (dot @ vt.transpose(-1, -2) - dt)
    return port._seq_first(_bf16(ds) @ kt, q.dtype)


def _bf16_case(shape, seed):
    """bf16 inputs, the reference's Pallas forward and its three gradients
    (jax.grad through the custom VJP: _dq_kernel and _dkv_kernel,
    interpret mode), and the emulated wgmma forward with its delta."""
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _inputs(shape, seed))
    qj, kj, vj, doj = (jnp.asarray(x.float().numpy(), dtype=jnp.bfloat16)
                       for x in (q, k, v, do))
    o_r, lse_r = ref.flash_attention_fwd(qj, kj, vj, interpret=True)
    grads = jax.grad(lambda q, k, v: jnp.sum(
        ref.flash_attention(q, k, v, interpret=True).astype(jnp.float32)
        * doj.astype(jnp.float32)), argnums=(0, 1, 2))(qj, kj, vj)
    as_np = lambda x: np.asarray(x.astype(jnp.float32))
    o, lse = _emulate_wgmma_fwd(q, k, v)
    delta = torch.sum(do.float() * o.float(), -1, keepdim=True)
    return ((q, k, v, do), (as_np(o_r), as_np(lse_r)),
            [as_np(g) for g in grads], (o, lse, delta))


def _max_rel(a, b):
    return np.max(np.abs(a.float().numpy() - b)) / np.max(np.abs(b))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape", [(1, 512, 2, 64), (1, 256, 2, 128)])
def test_wgmma_rounding_stays_within_budget_of_reference(shape, seed):
    """The wgmma kernels' bf16 numerics (emulated above) against the
    reference's Pallas kernels (interpret mode) on the same bf16 inputs,
    within chip_smoke.py's bounds: o 2e-2 abs, lse 1e-3 abs, dk/dv 2e-2
    relative to the max."""
    (q, k, v, do), (o_r, lse_r), (_, dk_r, dv_r), (o, lse, delta) = \
        _bf16_case(shape, seed)
    dk, dv = _emulate_wgmma_dkv(q, k, v, do, lse, delta)
    assert np.max(np.abs(o.float().numpy() - o_r)) <= 2e-2
    assert np.max(np.abs(lse.numpy() - lse_r)) <= 1e-3
    for a, b in ((dk, dk_r), (dv, dv_r)):
        assert _max_rel(a, b) <= 2e-2


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape", [(1, 512, 2, 64), (1, 256, 2, 128)])
def test_wgmma_dq_rounding_stays_within_budget_of_reference(shape, seed):
    """The wgmma dQ kernel's bf16 numerics (emulated above: P in f32, dS to
    bf16 before dS K) against the dq of the reference's Pallas _dq_kernel
    (interpret mode) on the same bf16 inputs: 2e-2 relative to the max,
    chip_smoke.py's bound."""
    (q, k, v, do), _, (dq_r, _, _), (_, lse, delta) = _bf16_case(shape, seed)
    dq = _emulate_wgmma_dq(q, k, v, do, lse, delta)
    assert dq.dtype == torch.bfloat16 and tuple(dq.shape) == shape
    assert _max_rel(dq, dq_r) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_kernels_match_reference_kernels(shape):
    """The CUDA kernels (f32 instantiations) against the Pallas kernels in
    interpret mode, forward and gradients. Needs JAX and a GPU in one
    process; tests/test_torch_cuda.py holds the JAX-free card tests."""
    if not torch.cuda.is_available():
        pytest.skip("flash_fwd/flash_dq/flash_dkv CUDA kernels "
                    "(ops/csrc/flash_fwd.cu, flash_bwd.cu) need an NVIDIA "
                    "GPU; torch.cuda.is_available() is false")
    q, k, v, do = _inputs(shape, 4)
    o_r, _ = ref.flash_attention_fwd(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), interpret=True)
    g_ref = jax.grad(lambda q, k, v: jnp.sum(
        ref.flash_attention(q, k, v, interpret=True) * do),
        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).cuda().requires_grad_()
                  for x in (q, k, v))
    before = dict(port.LAUNCHES)
    out = port.flash_attention(tq, tk, tv)
    grads = torch.autograd.grad(out, (tq, tk, tv),
                                torch.from_numpy(do).cuda())
    assert all(port.LAUNCHES[n] == before[n] + 1 for n in before)
    np.testing.assert_allclose(out.detach().cpu().numpy(), np.asarray(o_r),
                               atol=1e-5, rtol=0)
    for a, b in zip(grads, g_ref):
        b = np.asarray(b)
        assert np.max(np.abs(a.cpu().numpy() - b)) / np.max(np.abs(b)) <= 1e-4
