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
