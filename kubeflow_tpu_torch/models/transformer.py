"""Decoder-only transformer LM — PyTorch port of
``kubeflow_tpu/models/transformer.py`` (dense training path and dense
KV-cache decode).

Same math and the same precision rules as the flax reference:

  * params f32; with ``dtype=bfloat16`` every embedding lookup and
    projection casts both operands to bf16 and returns bf16 (what flax's
    ``nn.Embed``/``nn.Dense(dtype=bf16)`` do), so the residual stream
    stays in bf16; norms compute in f32 and return ``dtype``; logits f32;
  * RoPE over the two halves of the head dim, pre-LN blocks, SwiGLU FFN
    (gate = first half of ``wi``'s output), untied lm_head;
  * kernels keep the flax layouts (``[d, H, D]`` for q/k/v, ``[H, D, d]``
    for the output projection, ``[in, out]`` for dense layers), so
    ``models/convert.py`` is a renaming plus a split of the scanned layer
    stack.

Layers are an ``nn.ModuleList`` (eager PyTorch has no use for a scan).
Decode mode (``decode=True``) keeps the reference's dense cache as an
explicit ``KVCache`` the caller allocates and passes to ``forward``
instead of a flax "cache" collection.
Initialisation matches flax's distributions, not its bits: lecun-normal
(truncated) kernels by fan-in, embeddings normal with std 1/sqrt(d_model),
norm scales 1.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import flash_attention as flash_ops

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# Fields this slice does not implement -> the ROADMAP item that brings them.
_NOT_IN_SLICE = (
    ("n_experts", lambda c: c.n_experts > 0, "Queue A 4, MoE"),
    ("cp", lambda c: c.cp > 1, "Queue A 6, multi-GPU"),
    ("sp", lambda c: c.sp, "Queue A 6, multi-GPU"),
    ("quant", lambda c: bool(c.quant),
     "Queue A 5, the engine (int8 weights/KV)"),
    ("kv_page_size", lambda c: c.kv_page_size > 0,
     "Queue A 5, the engine (paged decode)"),
    ("kv_quant", lambda c: bool(c.kv_quant),
     "Queue A 5, the engine (int8 weights/KV)"),
    ("lora_rank", lambda c: c.lora_rank > 0, "Queue A 5, the engine (LoRA)"),
)
# ``remat`` and ``loss_chunk`` only matter to training, so they are refused
# where training would use them (parallel/lm_train.py), not here: every
# dense export loads and serves whatever it was trained with.


def _as_dtype(x: Any) -> torch.dtype:
    if isinstance(x, torch.dtype):
        return x
    if isinstance(x, str) and x in _DTYPES:
        return _DTYPES[x]
    raise ValueError(f"unknown dtype {x!r} (expected a torch dtype or one "
                     f"of {sorted(_DTYPES)})")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The reference's config: same fields, defaults and validation.
    ``dtype``/``param_dtype`` are torch dtypes (the strings "bfloat16" /
    "float32" are accepted too)."""

    vocab_size: int = 32_000
    d_model: int = 512
    n_heads: int = 8
    head_dim: int = 64
    n_layers: int = 8
    d_ff: int = 2048
    max_seq_len: int = 2048
    n_experts: int = 0
    expert_top_k: int = 2
    capacity_factor: float = 1.25
    moe_dispatch: str = "capacity"
    dropout: float = 0.0
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = False
    remat_policy: str = "nothing"
    sp: bool = False
    cp: int = 1
    # "auto" picks the CUDA flash kernels on a CUDA device when the shape
    # qualifies and S lies in [flash_min_seq, flash_max_seq); "flash" /
    # "naive" force one ("xla" is the reference's legacy alias of
    # "naive"); "ring" needs cp>1.
    attn_impl: str = "auto"
    # The window defaults are the reference's, measured on a TPU v5e (dense
    # XLA attention won below S=1024 there). They have not been
    # re-measured on the H100; the port keeps them so "auto" picks the same
    # path on both packages.
    flash_min_seq: int = 1024
    flash_max_seq: int = 4096
    loss_chunk: int = 0
    decode: bool = False
    kv_page_size: int = 0
    kv_pages: int = 0
    quant: str = ""
    kv_quant: str = ""
    lora_rank: int = 0
    lora_alpha: float = 16.0

    def __post_init__(self):
        object.__setattr__(self, "dtype", _as_dtype(self.dtype))
        object.__setattr__(self, "param_dtype", _as_dtype(self.param_dtype))
        if self.attn_impl not in ("auto", "flash", "xla", "naive", "ring"):
            raise ValueError(
                f"unknown attn_impl {self.attn_impl!r} (expected 'auto', "
                "'flash', 'naive'/'xla' or 'ring')")
        if self.attn_impl == "ring" and self.cp <= 1:
            raise ValueError(
                "attn_impl='ring' needs the sequence axis sharded: set "
                "cp>1 (ring attention rotates K/V over the 'ctx' mesh "
                "axis; with cp=1 there is no ring)")
        if self.kv_page_size < 0 or self.kv_pages < 0:
            raise ValueError("kv_page_size / kv_pages must be >= 0")
        if self.kv_page_size > 0:
            if self.max_seq_len % self.kv_page_size:
                raise ValueError(
                    f"kv_page_size {self.kv_page_size} must divide "
                    f"max_seq_len {self.max_seq_len} (the gathered view "
                    "must tile exactly)")
            if self.kv_pages < 1:
                raise ValueError(
                    "kv_pages must be >= 1 when kv_page_size > 0")
        if self.quant not in ("", "int8"):
            raise ValueError(
                f"unknown quant {self.quant!r} (expected '' or 'int8')")
        if self.kv_quant not in ("", "int8"):
            raise ValueError(
                f"unknown kv_quant {self.kv_quant!r} "
                "(expected '' or 'int8')")
        if self.kv_quant and self.kv_page_size == 0:
            raise ValueError(
                "kv_quant requires the paged cache (kv_page_size > 0): "
                "the dense one-shot layout is the full-precision oracle")
        if self.lora_rank < 0:
            raise ValueError("lora_rank must be >= 0 (0 = no LoRA)")
        if self.lora_rank > 0 and self.n_experts > 0:
            raise ValueError(
                "lora_rank targets the dense FFN (mlp.wi/wo); MoE "
                "expert weights are not LoRA targets — fine-tune a "
                "dense config or set lora_rank=0")
        for name, used, item in _NOT_IN_SLICE:
            if used(self):
                raise NotImplementedError(
                    f"TransformerConfig.{name}={getattr(self, name)!r} is not "
                    f"ported yet (ROADMAP.md, {item}); the port has dense "
                    "training and dense one-shot decode")

    @property
    def qkv_features(self) -> int:
        return self.n_heads * self.head_dim


def rope(x: torch.Tensor, positions: torch.Tensor,
         base: float = 10_000.0) -> torch.Tensor:
    """Rotary embeddings over the last dim, rotating the two halves (not
    interleaved pairs). x: [B, S, H, D]; positions: [B, S]."""
    d = x.shape[-1]
    half = d // 2
    freq = base ** (-torch.arange(0, half, dtype=torch.float32,
                                  device=x.device) / half)
    angles = positions[..., None].to(torch.float32) * freq   # [B, S, half]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


@dataclasses.dataclass
class LayerKV:
    """One layer's dense cache: ``key``/``value`` [B, L, H, D] in
    ``cfg.dtype`` and the cached position id of each slot, ``pos`` [B, L]
    int32 (-1 = empty or a right-pad token, masked)."""

    key: torch.Tensor
    value: torch.Tensor
    pos: torch.Tensor


@dataclasses.dataclass
class KVCache:
    """The decode-mode cache of every layer, L = ``cfg.max_seq_len`` slots
    per batch row, and each row's write cursor ``cursor`` [B] int32.

    ``TransformerLM.forward(tokens, positions, cache)`` writes the S new
    K/V (pad tokens included) at each row's cursor and advances it by S.
    Rows advance together, so ``length`` (host side) is every row's
    cursor: the write guard reads it without waiting for the device. The
    reference relies on XLA dropping out-of-range scatter updates; PyTorch
    raises or faults instead, so a write past L is refused up front."""

    layers: List[LayerKV]
    cursor: torch.Tensor
    length: int = 0

    @classmethod
    def allocate(cls, cfg: "TransformerConfig", batch: int,
                 device: Any = None) -> "KVCache":
        L, H, D = cfg.max_seq_len, cfg.n_heads, cfg.head_dim
        layers = [LayerKV(
            torch.zeros(batch, L, H, D, dtype=cfg.dtype, device=device),
            torch.zeros(batch, L, H, D, dtype=cfg.dtype, device=device),
            torch.full((batch, L), -1, dtype=torch.int32, device=device))
            for _ in range(cfg.n_layers)]
        return cls(layers, torch.zeros(batch, dtype=torch.int32,
                                       device=device))


def flash_window_ok(cfg: TransformerConfig, seq_len: int) -> bool:
    """Whether ``seq_len`` falls in the configured attn_impl="auto"
    flash window (flash_max_seq <= 0 means unbounded above)."""
    if seq_len < cfg.flash_min_seq:
        return False
    return cfg.flash_max_seq <= 0 or seq_len < cfg.flash_max_seq


def _lecun_normal_(w: torch.Tensor, fan_in: int,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's lecun_normal: truncated normal at +-2 std, variance 1/fan_in
    after truncation (std / .8796 before it)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


class Dense(nn.Module):
    """flax ``nn.Dense``/``DenseGeneral`` without bias: a ``kernel`` of
    shape ``in_shape + out_shape`` contracted over the input's trailing
    ``len(in_shape)`` dims, both operands cast to ``dtype``."""

    def __init__(self, in_shape, out_shape, cfg: TransformerConfig):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        self.dtype = cfg.dtype
        self.kernel = nn.Parameter(torch.empty(
            *self.in_shape, *self.out_shape, dtype=cfg.param_dtype))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            _lecun_normal_(self.kernel, math.prod(self.in_shape), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n_in, n_out = math.prod(self.in_shape), math.prod(self.out_shape)
        lead = x.shape[:x.dim() - len(self.in_shape)]
        w = self.kernel.to(self.dtype).reshape(n_in, n_out)
        y = torch.matmul(x.to(self.dtype).reshape(*lead, n_in), w)
        return y.reshape(*lead, *self.out_shape)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        var = torch.mean(xf * xf, -1, keepdim=True)
        y = xf * torch.rsqrt(var + 1e-6)
        return (y * self.scale).to(self.dtype)


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        heads = (cfg.n_heads, cfg.head_dim)
        self.query = Dense((cfg.d_model,), heads, cfg)
        self.key = Dense((cfg.d_model,), heads, cfg)
        self.value = Dense((cfg.d_model,), heads, cfg)
        self.out = Dense(heads, (cfg.d_model,), cfg)

    def _use_flash(self, seq_len: int, device: torch.device) -> bool:
        cfg = self.cfg
        if cfg.attn_impl in ("xla", "naive", "ring"):
            return False
        if cfg.attn_impl == "flash" and cfg.head_dim % 64:
            raise ValueError(
                f"attn_impl='flash' needs head_dim%64==0, "
                f"got D={cfg.head_dim}")
        ok = flash_ops.supported(seq_len, cfg.head_dim)
        if cfg.attn_impl == "flash":
            return ok
        # auto: the CUDA kernels inside the configured window. The
        # reference asks for a TPU backend here; the port asks for a CUDA
        # device (on the CPU "auto" means the dense path, as it does for
        # the reference off-TPU).
        return ok and device.type == "cuda" and flash_window_ok(cfg, seq_len)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                kv: Optional[LayerKV] = None,
                cursor: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        B, S, _ = x.shape
        q = self.query(x)
        k = self.key(x)
        v = self.value(x)
        pos = torch.clamp(positions, min=0)
        q = rope(q, pos)
        k = rope(k, pos)
        q = q / math.sqrt(cfg.head_dim)
        if kv is not None:
            out = self._decode_attend(q, k, v, positions, kv, cursor)
        elif self._use_flash(S, x.device):
            out = flash_ops.flash_attention(q, k, v)
        else:
            # Dense causal attention: scores in the compute dtype, masked
            # with the dtype's min, softmax in f32 (the reference's path).
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
            mask = torch.ones(S, S, dtype=torch.bool,
                              device=x.device).tril()
            scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
            probs = torch.softmax(scores.to(torch.float32), -1)
            out = torch.einsum("bhqk,bkhd->bqhd", probs.to(cfg.dtype), v)
        return self.out(out)

    def _decode_attend(self, q, k, v, positions, kv: LayerKV,
                       cursor: torch.Tensor) -> torch.Tensor:
        """The reference's dense ``_decode_attend`` branch: write the S new
        K/V and their position ids at each row's cursor, then attend over
        the whole cache, masked by cached position (``0 <= kp <= qp``), so
        pad slots (-1) and not-yet-written slots never contribute and
        query i of a multi-token window sees the window's earlier
        tokens."""
        cfg = self.cfg
        B, S = q.shape[:2]
        rows = torch.arange(B, device=q.device)[:, None]
        at = cursor.long()[:, None] + torch.arange(S, device=q.device)[None]
        kv.key[rows, at] = k.to(cfg.dtype)
        kv.value[rows, at] = v.to(cfg.dtype)
        kv.pos[rows, at] = positions.to(torch.int32)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, kv.key)   # [B, H, S, L]
        kp = kv.pos[:, None, None, :]
        qp = positions[:, None, :, None]
        mask = (kp >= 0) & (kp <= qp)
        scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
        probs = torch.softmax(scores.to(torch.float32), -1)
        return torch.einsum("bhqk,bkhd->bqhd", probs.to(cfg.dtype), kv.value)


class DenseFFN(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.wi = Dense((cfg.d_model,), (2 * cfg.d_ff,), cfg)
        self.wo = Dense((cfg.d_ff,), (cfg.d_model,), cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate, up = torch.chunk(self.wi(x), 2, dim=-1)
        return self.wo(F.silu(gate) * up)  # SwiGLU


class Block(nn.Module):
    """One pre-LN decoder layer."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, cfg.dtype)
        self.attn = Attention(cfg)
        self.ln2 = RMSNorm(cfg.d_model, cfg.dtype)
        self.mlp = DenseFFN(cfg)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                kv: Optional[LayerKV] = None,
                cursor: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), positions, kv, cursor)
        return x + self.mlp(self.ln2(x))


class Embed(nn.Module):
    """flax ``nn.Embed``: the table is cast to ``dtype`` for the lookup."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.dtype = cfg.dtype
        self.embedding = nn.Parameter(torch.empty(
            cfg.vocab_size, cfg.d_model, dtype=cfg.param_dtype))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            nn.init.normal_(self.embedding, 0.0,
                            1.0 / math.sqrt(self.embedding.shape[1]),
                            generator=generator)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens, self.embedding).to(self.dtype)


class TransformerLM(nn.Module):
    """Returns f32 logits [B, S, vocab]. Call with int tokens [B, S]."""

    def __init__(self, cfg: TransformerConfig,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        # Params are allocated on ``device`` directly (a base-size model
        # would otherwise pass through host memory first).
        with torch.device(device if device is not None else "cpu"):
            self.embed = Embed(cfg)
            self.layers = nn.ModuleList(
                Block(cfg) for _ in range(cfg.n_layers))
            self.ln_f = RMSNorm(cfg.d_model, cfg.dtype)
            self.lm_head = Dense((cfg.d_model,), (cfg.vocab_size,), cfg)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        """Draw every param from flax's init distributions with
        ``generator`` (which must live on the params' device)."""
        for mod in self.modules():
            if mod is not self and hasattr(mod, "reset_parameters"):
                mod.reset_parameters(generator)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                cache: Optional[KVCache] = None) -> torch.Tensor:
        """``cache`` is required with ``cfg.decode`` and refused without
        it: a decode model always reads and extends its cache, as the
        reference's does."""
        cfg = self.cfg
        if cfg.decode != (cache is not None):
            raise ValueError("a KVCache is passed exactly when cfg.decode "
                             f"is set (decode={cfg.decode})")
        S = tokens.shape[1]
        if cache is not None and cache.length + S > cfg.max_seq_len:
            raise ValueError(
                f"KV cache overflow: {cache.length} cached + {S} new tokens "
                f"exceed max_seq_len {cfg.max_seq_len}")
        x = self.embed(tokens)
        if positions is None:
            positions = torch.arange(S, device=tokens.device,
                                     dtype=torch.int32).expand(tokens.shape)
        for i, layer in enumerate(self.layers):
            if cache is None:
                x = layer(x, positions)
            else:
                x = layer(x, positions, cache.layers[i], cache.cursor)
        if cache is not None:
            cache.cursor += S
            cache.length += S
        return self.lm_head(self.ln_f(x)).to(torch.float32)


def n_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


# Named size presets (flagship ladder).
PRESETS: Dict[str, Dict[str, int]] = {
    "tiny": dict(d_model=128, n_heads=4, head_dim=32, n_layers=2, d_ff=512,
                 vocab_size=1024, max_seq_len=256),
    "small": dict(d_model=512, n_heads=8, head_dim=64, n_layers=8, d_ff=2048,
                  vocab_size=32_000, max_seq_len=2048),
    "base": dict(d_model=1024, n_heads=16, head_dim=64, n_layers=24,
                 d_ff=4096, vocab_size=32_000, max_seq_len=4096),
    "large": dict(d_model=2048, n_heads=16, head_dim=128, n_layers=24,
                  d_ff=8192, vocab_size=32_000, max_seq_len=4096),
}


def preset_config(name: str, **overrides) -> TransformerConfig:
    base = dict(PRESETS[name])
    base.update(overrides)
    return TransformerConfig(**base)
