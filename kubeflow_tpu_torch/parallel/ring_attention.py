"""Ring attention — port of ``kubeflow_tpu/parallel/ring_attention.py``:
exact causal attention with the sequence cut over a context-parallel
mesh axis.

Each rank holds a chunk of Q/K/V ([B, S/cp, H, D], chunk i at index i
along the axis). K/V chunks rotate around the ring by point-to-point
transfers (``comm.raw_shift``) while every rank accumulates its queries'
attention with an online softmax, in f32 as in the reference, with the
reference's pin of fully masked block rows (``m <= NEG_INF / 2 -> 0``).
Causality uses global positions.

The transfers are not differentiable ops, so the backward is written
out (``_Ring``): P is rebuilt from the saved per-row log-sum-exp, dQ
accumulates locally, and dK / dV travel with their K / V chunk around
the ring and arrive home after cp shifts.

Forms: ``ring_attention(q, k, v, mesh, axis)`` on local chunks (the
model's cp path), ``make_ring_attention(mesh, axis)`` on global [B, S,
H, D] tensors (each rank computes its chunk; the output and the input
grads come back whole on every rank).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import comm

NEG_INF = -1e30


def _scores(q, k, q_pos, k_pos):
    """[B, H, Sq, Sk] scores of pre-scaled q against k, masked causally
    by global position with NEG_INF; and the mask."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    mask = q_pos[:, None] >= k_pos[None, :]
    return torch.where(mask[None, None], s, NEG_INF), mask


def _block_attend(q, k, v, q_pos, k_pos):
    """One Q-chunk x KV-chunk pass: (numerator [B, Sq, H, D], row max
    [B, H, Sq], row sumexp [B, H, Sq]) for the online-softmax merge."""
    s, _ = _scores(q, k, q_pos, k_pos)
    m = s.amax(-1)
    # Rows with every key masked: pin the max to 0 so they contribute
    # sumexp ~0 instead of exp(NEG_INF - NEG_INF) = 1.
    m = torch.where(m <= NEG_INF / 2, 0.0, m)
    p = torch.exp(s - m[..., None])
    return torch.einsum("bhqk,bkhd->bqhd", p, v), m, p.sum(-1)


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mesh, axis):
        cp, idx = mesh.shape[axis], mesh.index(axis)
        B, S, H, D = q.shape
        q32, k32, v32 = (x.to(torch.float32) for x in (q, k, v))
        ar = torch.arange(S, device=q.device)
        q_pos = idx * S + ar
        num = torch.zeros(B, S, H, D, dtype=torch.float32, device=q.device)
        mx = torch.full((B, H, S), NEG_INF, dtype=torch.float32,
                        device=q.device)
        den = torch.zeros(B, H, S, dtype=torch.float32, device=q.device)
        kc, vc = k32, v32
        for step in range(cp):
            src = (idx - step) % cp   # whose K/V this rank holds now
            n_new, m_new, d_new = _block_attend(q32, kc, vc, q_pos,
                                                src * S + ar)
            m_tot = torch.maximum(mx, m_new)
            alpha, beta = torch.exp(mx - m_tot), torch.exp(m_new - m_tot)
            num = num * alpha.transpose(1, 2)[..., None] \
                + n_new * beta.transpose(1, 2)[..., None]
            den = den * alpha + d_new * beta
            mx = m_tot
            if step < cp - 1:
                kc = comm.raw_shift(kc, mesh, axis, 1)
                vc = comm.raw_shift(vc, mesh, axis, 1)
        den = den.clamp_min(1e-30)
        out = num / den.transpose(1, 2)[..., None]
        ctx.save_for_backward(q32, k32, v32, out, mx + torch.log(den))
        ctx.mesh, ctx.axis, ctx.dtypes = mesh, axis, (q.dtype, k.dtype,
                                                      v.dtype)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q32, k32, v32, out, lse = ctx.saved_tensors
        mesh, axis = ctx.mesh, ctx.axis
        cp, idx = mesh.shape[axis], mesh.index(axis)
        S = q32.shape[1]
        ar = torch.arange(S, device=q32.device)
        q_pos = idx * S + ar
        g = g.to(torch.float32)
        delta = (g * out).sum(-1).transpose(1, 2)          # [B, H, S]
        dq = torch.zeros_like(q32)
        kc, vc = k32, v32
        dk, dv = torch.zeros_like(k32), torch.zeros_like(v32)
        for step in range(cp):
            src = (idx - step) % cp
            s, mask = _scores(q32, kc, q_pos, src * S + ar)
            p = torch.where(mask[None, None], torch.exp(s - lse[..., None]),
                            0.0)
            dv = dv + torch.einsum("bhqk,bqhd->bkhd", p, g)
            dp = torch.einsum("bqhd,bkhd->bhqk", g, vc)
            ds = p * (dp - delta[..., None])
            dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, kc)
            dk = dk + torch.einsum("bhqk,bqhd->bkhd", ds, q32)
            # dK/dV travel with their chunk: cp shifts bring them home.
            dk = comm.raw_shift(dk, mesh, axis, 1)
            dv = comm.raw_shift(dv, mesh, axis, 1)
            if step < cp - 1:
                kc = comm.raw_shift(kc, mesh, axis, 1)
                vc = comm.raw_shift(vc, mesh, axis, 1)
        qt, kt, vt = ctx.dtypes
        return dq.to(qt), dk.to(kt), dv.to(vt), None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh, axis: str = "ctx") -> torch.Tensor:
    """Causal attention over a ring. q/k/v: [B, S_local, H, D], this
    rank's chunk (global sequence = the chunks in axis order); q must
    already be scaled by 1/sqrt(D). Returns q's dtype."""
    return _Ring.apply(q, k, v, mesh, axis)


def make_ring_attention(mesh, axis: str = "ctx",
                        batch_axis: Optional[str] = None):
    """Global [B, S, H, D] in and out: each rank takes its chunk of S
    (and of B over ``batch_axis``), runs the ring, and all-gathers the
    output; the grads of the inputs come back whole on every rank."""
    def fn(q, k, v):
        def local(x):
            x = comm.split(x, mesh, axis, 1)
            return x if batch_axis is None else comm.split(
                x, mesh, batch_axis, 0)

        out = ring_attention(local(q), local(k), local(v), mesh, axis)
        if batch_axis is not None:
            out = comm.gather(out, mesh, batch_axis, 0)
        return comm.gather(out, mesh, axis, 1)
    return fn


__all__ = ["NEG_INF", "make_ring_attention", "ring_attention"]
