"""Causal flash attention for Hopper: hand-written CUDA forward, dQ and
dK/dV kernels (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``), each beside
a plain PyTorch version of the same blocked online-softmax algorithm.

Port of ``kubeflow_tpu/ops/flash_attention.py``. Same contract:

* inputs are ``[B, S, H, D]`` (the model's layout); ``q`` is pre-scaled
  by 1/sqrt(D) (the model does it); compute is f32 whatever the input
  dtype; ``lse`` is ``[B, S, H, 1]`` f32;
* causal: K blocks above the diagonal are skipped, the diagonal block
  is masked with ``NEG_INF`` (a large finite negative, not -inf, so a
  masked score never produces NaN through ``exp(-inf - -inf)``);
* the backward recomputes the probabilities from (q, k, lse);
  ``delta = rowsum(dO * O)`` is a plain torch op outside the kernels.

Dispatch is by the tensors' device and nothing else: CPU tensors take
the plain version (what the CPU tests run), CUDA tensors launch the
kernel or raise. There is no fallback from one to the other.

``LAUNCHES`` counts kernel launches per kernel (plain-version calls do
not count), so a run can show its main path went through the kernels.

The reference splits the op into ``flash_attention_fwd`` +
``flash_attention_apply`` so remat policies can save (o, lse) and skip
the forward in the backward. This port has no remat yet, so one
``torch.autograd.Function`` takes the place of ``_flash_apply``; it saves
exactly (q, k, v, o, lse), the reference's residuals.
"""

from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -1e30
# Largest head dim the CUDA kernels are instantiated for.
MAX_HEAD_DIM = 256

LAUNCHES = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _pick_block(s: int, want: int = 256) -> int:
    b = min(want, s)
    while s % b:
        b //= 2
    return max(b, 1)


def supported(seq_len: int, head_dim: int) -> bool:
    """Shapes the kernels handle: head dim a multiple of 64, sequence a
    multiple of 128 (the reference's predicate, kept so ``attn_impl``
    picks the same path on both packages)."""
    return head_dim % 64 == 0 and seq_len % 128 == 0


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the on-card yardstick)
# ---------------------------------------------------------------------------

def _heads_first(*xs):
    """[B, S, H, X] -> f32 [B, H, S, X]."""
    return [x.float().transpose(1, 2) for x in xs]


def _seq_first(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """f32 [B, H, S, X] -> dtype [B, S, H, X], contiguous."""
    return x.to(dtype).transpose(1, 2).contiguous()


def _causal_mask(q0: int, bq: int, k0: int, bk: int, device) -> torch.Tensor:
    q_pos = q0 + torch.arange(bq, device=device)[:, None]
    k_pos = k0 + torch.arange(bk, device=device)[None, :]
    return q_pos >= k_pos


def _fwd_reference(q, k, v) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked online-softmax forward (the algorithm of the reference's
    ``_fwd_kernel``): returns (o [B,S,H,D] in q's dtype, lse [B,S,H,1]
    f32)."""
    B, S, H, D = q.shape
    bq, bk = _pick_block(S), _pick_block(S)
    qt, kt, vt = _heads_first(q, k, v)
    o = torch.empty_like(qt)
    lse = torch.empty(B, H, S, 1, dtype=torch.float32, device=q.device)
    for qi in range(S // bq):
        rows = slice(qi * bq, (qi + 1) * bq)
        qb = qt[:, :, rows]
        acc = torch.zeros_like(qb)
        m = torch.full((B, H, bq, 1), NEG_INF, device=q.device)
        den = torch.zeros(B, H, bq, 1, device=q.device)
        for j in range((qi * bq + bq + bk - 1) // bk):
            cols = slice(j * bk, (j + 1) * bk)
            s = qb @ kt[:, :, cols].transpose(-1, -2)
            s = torch.where(_causal_mask(qi * bq, bq, j * bk, bk, q.device),
                            s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            den = den * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + p @ vt[:, :, cols]
            m = m_new
        o[:, :, rows] = acc / den
        lse[:, :, rows] = m + torch.log(den)
    return _seq_first(o, q.dtype), _seq_first(lse, torch.float32)


def _dq_reference(q, k, v, do, lse, delta) -> torch.Tensor:
    """Blocked dQ (the reference's ``_dq_kernel``): per Q block, over K
    blocks up to the diagonal, ``p = exp(qk^T - lse)``,
    ``ds = p * (dO v^T - delta)``, ``dQ += ds k``."""
    B, S, H, D = q.shape
    bq, bk = _pick_block(S), _pick_block(S)
    qt, kt, vt, dot, lset, dt = _heads_first(q, k, v, do, lse, delta)
    dq = torch.empty_like(qt)
    for qi in range(S // bq):
        rows = slice(qi * bq, (qi + 1) * bq)
        acc = torch.zeros_like(qt[:, :, rows])
        for j in range((qi * bq + bq + bk - 1) // bk):
            cols = slice(j * bk, (j + 1) * bk)
            s = qt[:, :, rows] @ kt[:, :, cols].transpose(-1, -2)
            s = torch.where(_causal_mask(qi * bq, bq, j * bk, bk, q.device),
                            s, NEG_INF)
            p = torch.exp(s - lset[:, :, rows])
            dp = dot[:, :, rows] @ vt[:, :, cols].transpose(-1, -2)
            ds = p * (dp - dt[:, :, rows])
            acc = acc + ds @ kt[:, :, cols]
        dq[:, :, rows] = acc
    return _seq_first(dq, q.dtype)


def _dkv_reference(q, k, v, do, lse, delta
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked dK/dV (the reference's ``_dkv_kernel``): per K block, over
    Q blocks from the diagonal down, ``dV += p^T dO``,
    ``dK += ds^T q``."""
    B, S, H, D = q.shape
    bq, bk = _pick_block(S), _pick_block(S)
    qt, kt, vt, dot, lset, dt = _heads_first(q, k, v, do, lse, delta)
    dk = torch.empty_like(kt)
    dv = torch.empty_like(vt)
    for ki in range(S // bk):
        cols = slice(ki * bk, (ki + 1) * bk)
        acc_k = torch.zeros_like(kt[:, :, cols])
        acc_v = torch.zeros_like(vt[:, :, cols])
        for i in range((ki * bk) // bq, S // bq):
            rows = slice(i * bq, (i + 1) * bq)
            s = qt[:, :, rows] @ kt[:, :, cols].transpose(-1, -2)
            s = torch.where(_causal_mask(i * bq, bq, ki * bk, bk, q.device),
                            s, NEG_INF)
            p = torch.exp(s - lset[:, :, rows])          # [B,H,BQ,BK]
            acc_v = acc_v + p.transpose(-1, -2) @ dot[:, :, rows]
            dp = dot[:, :, rows] @ vt[:, :, cols].transpose(-1, -2)
            ds = p * (dp - dt[:, :, rows])
            acc_k = acc_k + ds.transpose(-1, -2) @ qt[:, :, rows]
        dk[:, :, cols] = acc_k
        dv[:, :, cols] = acc_v
    return _seq_first(dk, k.dtype), _seq_first(dv, v.dtype)


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _on_cuda(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda tensors, "
                         f"got {x.device}")
    return True


def _launch(name: str, *args: torch.Tensor) -> None:
    """Launch kernel ``name`` on the current stream with ``args`` in its C
    entry point's order (q first): [B, S, H, D] tensors in q's dtype and
    f32 [B, S, H, 1] vectors, all contiguous on q's device. Validates what
    the kernel takes and raises on a refused launch."""
    from .build import cuda_error_string, load_library

    q = args[0]
    if q.dim() != 4:
        raise ValueError(f"expected [B, S, H, D] tensors, "
                         f"got {tuple(q.shape)}")
    B, S, H, D = q.shape
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash kernels take bfloat16 or float32, "
                        f"got {q.dtype}")
    if D == 0 or D % 64 or D > MAX_HEAD_DIM:
        raise ValueError(f"flash kernels need head_dim a multiple of 64 "
                         f"and <= {MAX_HEAD_DIM}, got D={D}")
    if S % 64:
        raise ValueError(f"flash kernels need seq_len % 64 == 0, got S={S}")
    for t in args:
        shape, dtype = (((B, S, H, 1), torch.float32) if t.shape[-1] == 1
                        else (q.shape, q.dtype))
        if (t.shape != shape or t.dtype != dtype or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(
                f"{name}: got a {tuple(t.shape)} {t.dtype} tensor on "
                f"{t.device} (contiguous={t.is_contiguous()}), expected "
                f"{tuple(shape)} {dtype} on {q.device}, contiguous")
    fn = getattr(load_library(), "kfx_" + name)
    with torch.cuda.device(q.device):
        rc = fn(*(t.data_ptr() for t in args), B, S, H, D,
                _DTYPE_CODES[q.dtype],
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({cuda_error_string(rc)})")
    LAUNCHES[name] += 1


def _fwd(q, k, v) -> Tuple[torch.Tensor, torch.Tensor]:
    if not _on_cuda(q):
        return _fwd_reference(q, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    lse = torch.empty(*q.shape[:3], 1, dtype=torch.float32, device=q.device)
    _launch("flash_fwd", q, k, v, o, lse)
    return o, lse


def _dq(q, k, v, do, lse, delta) -> torch.Tensor:
    if not _on_cuda(q):
        return _dq_reference(q, k, v, do, lse, delta)
    q, k, v, do, lse, delta = (x.contiguous()
                               for x in (q, k, v, do, lse, delta))
    dq = torch.empty_like(q)
    _launch("flash_dq", q, k, v, do, lse, delta, dq)
    return dq


def _dkv(q, k, v, do, lse, delta) -> Tuple[torch.Tensor, torch.Tensor]:
    if not _on_cuda(q):
        return _dkv_reference(q, k, v, do, lse, delta)
    q, k, v, do, lse, delta = (x.contiguous()
                               for x in (q, k, v, do, lse, delta))
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("flash_dkv", q, k, v, do, lse, delta, dk, dv)
    return dk, dv


# ---------------------------------------------------------------------------
# Public op
# ---------------------------------------------------------------------------

class _FlashAttention(torch.autograd.Function):
    """Takes the place of the reference's ``_flash_apply`` custom VJP:
    residuals are exactly (q, k, v, o, lse); the backward runs the dQ and
    the dK/dV kernels against them."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = _fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = torch.sum(do.float() * o.float(), dim=-1, keepdim=True)
        dq = _dq(q, k, v, do, lse, delta)
        dk, dv = _dkv(q, k, v, do, lse, delta)
        return dq, dk, dv


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward only: [B, S, H, D] -> (o [B, S, H, D], lse [B, S, H, 1]
    f32). No gradient flows through this call."""
    with torch.no_grad():
        return _fwd(q.detach(), k.detach(), v.detach())


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                    ) -> torch.Tensor:
    """Causal attention, [B, S, H, D] in/out, differentiable. q must be
    pre-scaled by 1/sqrt(D) (the model's convention)."""
    return _FlashAttention.apply(q, k, v)
