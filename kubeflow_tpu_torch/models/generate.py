"""Autoregressive generation for TransformerLM — port of
``kubeflow_tpu/models/generate.py``: a dense KV-cache prefill, then one
one-token decode step per new token.

The reference compiles prefill plus a ``lax.scan`` of decode steps into
one dispatch per call; eager PyTorch runs the same steps as a Python loop
under ``torch.inference_mode()``. Everything else is the reference's:
the train-time params are reused verbatim and only the config flips to
``decode=True``; prompts are right-padded to a power-of-two bucket with
position id -1 (the decode attention masks pad slots by cached position,
so padding never changes the numbers); ``max_new_tokens`` pads to its
bucket and the tail is sliced off; the next-token context is the last
real prompt token's logits. Sampling: greedy (temperature <= 0),
temperature, and top-k with the reference's tie rule, drawn from a
``torch.Generator`` seeded by ``seed`` (the reference draws from JAX's
threefry, which a torch stream cannot reproduce: the port's streams are
deterministic per seed and follow the same distribution). A
``quant="int8"`` config serves int8 weights over the dense cache.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from .convert import params_from_jax
from .transformer import (KVCache, QuantDense, TransformerConfig,
                          TransformerLM)


def pow2_bucket(n: int, cap: int) -> int:
    """The prompt/length bucket policy (powers of two from 8, capped). It
    fixes the cache layout (where pads sit) and the capacity error, so it
    stays the reference's even though eager PyTorch compiles nothing."""
    b = 8
    while b < n:
        b *= 2
    return min(b, cap)


def prefill_chunks(tail_len: int, chunk: int, cap: int) -> list:
    """The chunked-prefill schedule for a ``tail_len``-token prompt tail:
    [(offset, length, bucket)], every chunk ``chunk`` tokens except the
    remainder, each bucketed by ``pow2_bucket`` (the reference's contract;
    the engine's chunked admission dispatches exactly these)."""
    out = []
    off = 0
    while off < tail_len:
        length = min(chunk, tail_len - off)
        out.append((off, length, pow2_bucket(length, cap)))
        off += length
    return out


def decode_config(cfg: TransformerConfig,
                  max_len: Optional[int] = None) -> TransformerConfig:
    """The serving-time decode variant of a train config: KV cache on,
    dense attention (the decode step is one token; flash and the
    parallelism knobs are training-shape machinery)."""
    return dataclasses.replace(
        cfg, decode=True, remat=False, sp=False, cp=1, attn_impl="xla",
        max_seq_len=max_len or cfg.max_seq_len)


def _sample(logits: torch.Tensor, generator: torch.Generator,
            temperature: float, top_k: int) -> torch.Tensor:
    """logits [B, V] f32 -> token ids [B] (int64). ``temperature <= 0`` is
    greedy (the first argmax); otherwise ``logits / max(T, 1e-6)``, and
    with ``top_k > 0`` every logit below the k-th largest (taken from a
    sort, ``srt[V - top_k]``) is masked, so ties at the k-th value all
    survive, as in the reference."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    V = logits.shape[-1]
    scaled = logits / max(float(temperature), 1e-6)
    if top_k > 0:
        srt = torch.sort(scaled, dim=-1).values
        kth = srt[:, max(V - int(top_k), 0)][:, None]
        scaled = scaled.masked_fill(scaled < kth, float("-inf"))
    probs = torch.softmax(scaled, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _state_dict(params: Mapping[str, Any]) -> Mapping[str, Any]:
    """The reference's param tree (nested dicts, what ``load_lm`` returns)
    or a port ``state_dict`` (flat, tensor values) -> a ``state_dict``."""
    if any(isinstance(v, Mapping) for v in params.values()):
        return params_from_jax(params)
    return params


def load_decode_model(cfg: TransformerConfig, params: Mapping[str, Any],
                      device: torch.device) -> TransformerLM:
    """The decode-mode ``TransformerLM`` for ``cfg`` with ``params`` (a
    reference param tree or a port ``state_dict``) on ``device``. Params go
    to the device once (the reference's device_put); the model is built on
    the meta device so no random init is drawn. Float params take
    ``cfg.param_dtype``; a ``QuantDense``'s int8 kernel and f32 scale keep
    their dtypes (a blanket cast would turn the codes into floats and
    round the scales)."""
    model = TransformerLM(cfg, device="meta")
    frozen = {f"{name}.{leaf}" for name, mod in model.named_modules()
              if isinstance(mod, QuantDense) for leaf in ("kernel", "scale")}
    want = {k: t.dtype for k, t in model.state_dict().items()}
    sd = {k: torch.as_tensor(v).to(
              device, want[k] if k in frozen else cfg.param_dtype)
          for k, v in _state_dict(params).items()}
    model.load_state_dict(sd, assign=True)
    return model.eval().requires_grad_(False)


class LMGenerator:
    """Owns the decode-mode model on one device. Holds nothing a call
    mutates (the KV cache and the sampling generator are made per call),
    so threads may call ``generate`` concurrently."""

    def __init__(self, cfg: TransformerConfig, params: Mapping[str, Any],
                 max_len: Optional[int] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.cfg = decode_config(cfg, max_len)
        self.device = resolve_device(device)
        self.model = load_decode_model(self.cfg, params, self.device)

    @torch.inference_mode()
    def generate(self, prompts, max_new_tokens: int = 32,
                 temperature: float = 0.0, top_k: int = 0,
                 seed: int = 0) -> list:
        """prompts: list of token-id lists (any lengths). Returns a list of
        generated id lists (``max_new_tokens`` each)."""
        cfg = self.cfg
        cap = cfg.max_seq_len
        if not prompts or any(len(p) == 0 for p in prompts):
            raise ValueError("prompts must be non-empty token-id lists")
        longest = max(len(p) for p in prompts)
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        new_bucket = pow2_bucket(max_new_tokens, cap)
        if longest + new_bucket > cap:
            if longest + max_new_tokens > cap:
                raise ValueError(
                    f"prompt ({longest}) + max_new_tokens "
                    f"({max_new_tokens}) exceeds the cache capacity {cap}")
            new_bucket = max_new_tokens  # exact fit, no bucket headroom
        pad = pow2_bucket(longest, cap - new_bucket)
        B = len(prompts)
        tokens = np.zeros((B, pad), np.int64)
        true_len = np.zeros((B,), np.int64)
        for i, p in enumerate(prompts):
            tokens[i, :len(p)] = p
            true_len[i] = len(p)
        # An out-of-range id would fault the embedding gather on the card.
        if tokens.min() < 0 or tokens.max() >= cfg.vocab_size:
            raise ValueError(
                f"prompt token ids must be in [0, {cfg.vocab_size})")
        dev = self.device
        tok = torch.from_numpy(tokens).to(dev)
        tl = torch.from_numpy(true_len).to(dev)
        ar = torch.arange(pad, device=dev)[None, :]
        pos = torch.where(ar < tl[:, None], ar, -1).to(torch.int32)
        cache = KVCache.allocate(cfg, B, dev)
        logits = self.model(tok, pos, cache)
        prev = logits[torch.arange(B, device=dev), tl - 1]   # [B, V]
        del logits
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        cur = tl.to(torch.int32)
        out = []
        for _ in range(new_bucket):
            t = _sample(prev, gen, temperature, top_k)
            out.append(t)
            prev = self.model(t[:, None], cur[:, None], cache)[:, 0]
            cur = cur + 1
        toks = torch.stack(out, 1)[:, :max_new_tokens]
        return toks.cpu().tolist()
