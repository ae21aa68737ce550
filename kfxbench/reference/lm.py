"""Plain PyTorch reference of the decoder the benchmark runs, in float32.

A frozen copy of the block as the port computes it, written from the
equations and sharing no code with the program:

* pre-norm layers: RMSNorm (eps 1e-6, a learned scale), causal
  multi-head attention with as many K/V heads as query heads, RMSNorm,
  SwiGLU MLP whose ``wi`` holds gate || up (the gate is the first half);
* rotary embeddings rotating the two halves of each head, base 10,000;
  queries scaled by 1/sqrt(head_dim); no biases; an untied head;
* training: mean cross-entropy over every token, AdamW with the global
  norm clip, decoupled decay on every leaf, bias correction, and the
  warmup-cosine schedule read at the count before the update.

Weights are the benchmark's leaves (``core/weights.py`` names them as the
port's ``state_dict`` does). Products run through a ``Matmul`` policy:
``"f32"`` is the reference (TF32 off), ``"fp8"`` rounds both operands of
every product to float8 e4m3 with a per-tensor scale and keeps the
bfloat16 result, the precision below the configuration's bfloat16 that
serves as the control. Work runs layer by layer, so the largest model
fits beside what the program leaves on the card.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / FP8_MAX
    codes = (x.float() / scale).to(torch.float8_e4m3fn)
    return codes.to(torch.bfloat16), scale


class _Fp8Product(torch.autograd.Function):
    """a @ b with both operands rounded to e4m3 (per-tensor scale), the
    product in bfloat16; the backward's products round the same way."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return fp8_matmul(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return fp8_matmul(g, b.transpose(-1, -2)), \
            fp8_matmul(a.transpose(-1, -2), g)


def fp8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ca, sa = _fp8(a)
    cb, sb = _fp8(b)
    return torch.matmul(ca, cb).float() * (sa * sb)


class Matmul:
    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "f32":
            return torch.matmul(a.float(), b.float())
        return _Fp8Product.apply(a.float(), b.float())


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, positions: torch.Tensor,
         base: float = 10_000.0) -> torch.Tensor:
    """x [..., S, H, D], positions [S]: rotate the two halves of D."""
    half = x.shape[-1] // 2
    inv = base ** (-torch.arange(half, dtype=torch.float32,
                                 device=x.device) / half)
    ang = positions.float()[:, None] * inv                  # [S, half]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mm: Matmul) -> torch.Tensor:
    """q, k, v [S, H, D] (q already scaled) -> [S, H, D]."""
    S = q.shape[0]
    scores = mm(q.transpose(0, 1), k.permute(1, 2, 0))      # [H, S, S]
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), -1)
    return mm(probs, v.transpose(0, 1)).transpose(0, 1)


LAYER_LEAVES = ("ln1.scale", "attn.query.kernel", "attn.key.kernel",
                "attn.value.kernel", "attn.out.kernel", "ln2.scale",
                "mlp.wi.kernel", "mlp.wo.kernel")


def layer_weights(W: Dict[str, torch.Tensor], i: int
                  ) -> Dict[str, torch.Tensor]:
    return {n: W[f"layers.{i}.{n}"].float() for n in LAYER_LEAVES}


def block(x: torch.Tensor, w: Dict[str, torch.Tensor], mm: Matmul
          ) -> torch.Tensor:
    """One layer over x [B, S, d] at positions 0..S-1 of each row."""
    B, S, d = x.shape
    H, D = w["attn.query.kernel"].shape[1:]
    pos = torch.arange(S, device=x.device)
    h = rms_norm(x, w["ln1.scale"])
    q = rope(mm(h, w["attn.query.kernel"].reshape(d, H * D)).view(
        B, S, H, D), pos) / math.sqrt(D)
    k = rope(mm(h, w["attn.key.kernel"].reshape(d, H * D)).view(
        B, S, H, D), pos)
    v = mm(h, w["attn.value.kernel"].reshape(d, H * D)).view(B, S, H, D)
    att = torch.stack([causal_attention(q[b], k[b], v[b], mm)
                       for b in range(B)])
    x = x + mm(att.reshape(B, S, H * D), w["attn.out.kernel"].reshape(
        H * D, d))
    h = rms_norm(x, w["ln2.scale"])
    gate, up = mm(h, w["mlp.wi.kernel"]).chunk(2, -1)
    return x + mm(F.silu(gate) * up, w["mlp.wo.kernel"])


def n_layers(W: Dict[str, torch.Tensor]) -> int:
    return sum(1 for n in W if n.endswith(".ln1.scale"))


# -- serving: logits of served tokens ----------------------------------------

@torch.no_grad()
def served_logits(W: Dict[str, torch.Tensor],
                  seqs: Sequence[Tuple[Sequence[int], Sequence[int]]],
                  mm: Matmul) -> List[torch.Tensor]:
    """For each (prompt, served) pair, the logits [len(served), V] that
    predict each served token from the prompt and the served tokens
    before it (one forward pass over prompt + served[:-1])."""
    dev = W["embed.embedding"].device
    xs = []
    for prompt, served in seqs:
        ids = torch.tensor(list(prompt) + list(served)[:-1], device=dev)
        xs.append(W["embed.embedding"][ids].float()[None])
    for i in range(n_layers(W)):
        w = layer_weights(W, i)
        xs = [block(x, w, mm) for x in xs]
        del w
    head = W["lm_head.kernel"].float()
    out = []
    for (prompt, served), x in zip(seqs, xs):
        h = rms_norm(x[0, len(prompt) - 1:], W["ln_f.scale"].float())
        out.append(mm(h, head))
    return out


def served_gaps(ref_logits: Sequence[torch.Tensor],
                tokens: Sequence[Sequence[int]]) -> List[float]:
    """Per sequence, the widest gap by which a token's reference logit
    lies below the reference's best at its position."""
    gaps = []
    for logits, toks in zip(ref_logits, tokens):
        t = torch.tensor(list(toks), device=logits.device)
        best = logits.max(-1).values
        gaps.append(float((best - logits.gather(1, t[:, None])[:, 0]).max()))
    return gaps


# -- training: loss, gradients and AdamW --------------------------------------

def loss_and_grads(W: Dict[str, torch.Tensor], tokens: torch.Tensor,
                   mm: Matmul) -> Tuple[float, Dict[str, torch.Tensor]]:
    """Mean cross-entropy of ``tokens`` [B, S + 1] (inputs || shifted
    targets) and the gradient of every leaf. The forward keeps only each
    layer's input; the backward runs layer by layer, recomputing that
    layer's forward under autograd."""
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    L = n_layers(W)
    grads: Dict[str, torch.Tensor] = {}
    with torch.no_grad():
        xs = [W["embed.embedding"][inp].float()]
        for i in range(L):
            xs.append(block(xs[-1], layer_weights(W, i), mm))
    x = xs.pop().requires_grad_()
    lnf = W["ln_f.scale"].detach().float().requires_grad_()
    head = W["lm_head.kernel"].detach().float().requires_grad_()
    logits = mm(rms_norm(x, lnf), head)
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tgt.reshape(-1))
    loss.backward()
    del logits
    grads["ln_f.scale"], grads["lm_head.kernel"] = lnf.grad, head.grad
    dx = x.grad
    for i in reversed(range(L)):
        x = xs.pop().requires_grad_()
        w = {n: t.detach().requires_grad_()
             for n, t in layer_weights(W, i).items()}
        block(x, w, mm).backward(dx)
        for n, t in w.items():
            grads[f"layers.{i}.{n}"] = t.grad
        dx = x.grad
    emb = torch.zeros_like(W["embed.embedding"], dtype=torch.float32)
    emb.index_add_(0, inp.reshape(-1), dx.reshape(-1, dx.shape[-1]))
    grads["embed.embedding"] = emb
    return float(loss.detach()), grads


def warmup_cosine(count: int, peak: float, warmup: int, decay: int) -> float:
    """Linear 0 -> peak over ``warmup`` counts, then cosine to 0 at
    ``decay``."""
    if count < warmup:
        return peak * max(count, 0) / warmup
    t = min(count - warmup, decay - warmup)
    return peak * 0.5 * (1.0 + math.cos(math.pi * t / (decay - warmup)))


class AdamW:
    """Global-norm clip, then Adam (b1, b2, eps) with bias correction,
    decoupled weight decay on every leaf, learning rate read at the count
    before the update."""

    def __init__(self, hp: dict, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8):
        self.hp, self.b1, self.b2, self.eps = hp, b1, b2, eps
        self.decay = max(hp["total_steps"], hp["warmup_steps"] + 1)
        self.mu: Dict[str, torch.Tensor] = {}
        self.nu: Dict[str, torch.Tensor] = {}
        self.count = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Update ``params`` in place; returns the clipped gradients."""
        norm = math.sqrt(sum(float((g * g).sum()) for g in grads.values()))
        clip = self.hp["grad_clip"]
        scale = 1.0 if norm < clip else clip / norm
        lr = warmup_cosine(self.count, self.hp["learning_rate"],
                           self.hp["warmup_steps"], self.decay)
        t = self.count + 1
        b1, b2 = self.b1, self.b2
        for n, p in params.items():
            g = grads[n] * scale
            grads[n] = g
            mu = self.mu.setdefault(n, torch.zeros_like(p))
            nu = self.nu.setdefault(n, torch.zeros_like(p))
            mu.mul_(b1).add_(g, alpha=1 - b1)
            nu.mul_(b2).addcmul_(g, g, value=1 - b2)
            upd = (mu / (1 - b1 ** t)) / (
                torch.sqrt(nu / (1 - b2 ** t)) + self.eps)
            upd.add_(p, alpha=self.hp["weight_decay"])
            p.add_(upd, alpha=-lr)
        self.count = t
        return grads


def train(W: Dict[str, torch.Tensor], batches: Sequence[torch.Tensor],
          hp: dict, mm: Matmul, rows: Optional[int] = None
          ) -> Dict[str, object]:
    """Train the f32 leaves ``W`` (updated in place) for one step a batch.
    ``rows`` keeps only the first rows of each batch. Returns each step's
    loss, each leaf's norm of the first clipped gradient, of the first raw
    gradient, and of its change over all the steps."""
    start = {n: p.detach().clone() for n, p in W.items()}
    opt = AdamW(hp)
    losses: List[float] = []
    first: Dict[str, float] = {}
    raw: Dict[str, float] = {}
    for i, tokens in enumerate(batches):
        if rows is not None:
            tokens = tokens[:rows]
        loss, grads = loss_and_grads(W, tokens, mm)
        losses.append(loss)
        if i == 0:
            raw = {n: float(g.norm()) for n, g in grads.items()}
        clipped = opt.step(W, grads)
        if i == 0:
            first = {n: float(g.norm()) for n, g in clipped.items()}
        del grads, clipped
    change = {n: float((W[n] - start[n]).norm()) for n in W}
    return {"losses": losses, "grad_norms": first, "raw_grad_norms": raw,
            "change_norms": change}
