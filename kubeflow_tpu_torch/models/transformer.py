"""Decoder-only transformer LM — PyTorch port of
``kubeflow_tpu/models/transformer.py`` (training with or without remat,
on one device or sharded over a mesh of ranks (``TransformerLM.shard``:
tp, sp, cp, fsdp, ep), dense or MoE FFN, dense KV-cache decode, the
engine's paged KV-cache decode and the layer-truncated speculative
draft).

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

``cfg.quant == "int8"`` serves int8 weights (``QuantDense``: an int8
kernel and an f32 per-output-channel scale applied to the product, the
reference's ``QuantDenseGeneral``) in the attention projections, the
dense FFN and the lm_head; ``quantize_params_int8`` makes their params
from a full-precision reference-layout tree. ``cfg.kv_quant == "int8"``
stores the paged pool's K/V as int8 with a per-token f32 scale plane
beside each (quantize on write, dequantize after the gather).

LoRA (``cfg.lora_rank > 0``, the fine-tuner's model): the attention
q/k/v/out and dense-FFN wi/wo projections carry train-time factors
``<name>_lora_a`` [d_in, r] (normal, std 0.02) and ``<name>_lora_b`` [r,
d_out] (zero, so step 0 is the base) and add ``(x @ A) @ B * alpha / r``
to the projection's output. Serving many adapters over one base goes
through the ``lora`` / ``adapter_ids`` arguments of ``forward`` instead:
per-layer stacks of every adapter slot's factors, gathered per batch row
(``lora_gather_delta``; id -1 = the base). With neither, the forward is
the pre-LoRA one.

Layers are an ``nn.ModuleList`` (eager PyTorch has no use for a scan).
``cfg.remat`` runs each layer under ``torch.utils.checkpoint`` (the
reference's ``nn.remat``) with the reference's save policies
(``REMAT_POLICIES``): the reference's ``checkpoint_name`` tags become
name scopes (``remat_name``) around the ops that produce the tagged
tensors, and a selective-checkpoint policy keeps the outputs of those ops
(a matrix product, or the ``kfx::flash_fwd`` op for ``flash_o`` /
``flash_lse``); nothing is copied to tag it. MoE layers (``MoEFFN``)
return their Switch aux loss through ``forward(..., aux_out=[])``.
Decode mode (``decode=True``) keeps the reference's caches as explicit
state the caller allocates and passes to ``forward`` instead of a flax
"cache" collection: the dense ``KVCache`` (``kv_page_size == 0``, the
one-shot path) or the paged ``PagedKVCache`` (``kv_page_size > 0``, the
serving engine's pool, addressed through per-row block tables).
Initialisation matches flax's distributions, not its bits: lecun-normal
(truncated) kernels by fan-in, embeddings normal with std 1/sqrt(d_model),
norm scales 1.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import math
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as _ckpt

from ..ops import flash_attention as flash_ops
from ..parallel import comm

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


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
    """One layer's cache: ``key``/``value`` [..., H, D] in ``cfg.dtype``
    (int8 in an int8 paged pool, with the per-token f32 ``key_scale`` /
    ``value_scale`` planes beside them) and the cached position id of each
    slot, ``pos`` (-1 = empty or a right-pad token, masked)."""

    key: torch.Tensor
    value: torch.Tensor
    pos: torch.Tensor
    key_scale: Optional[torch.Tensor] = None
    value_scale: Optional[torch.Tensor] = None


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


@dataclasses.dataclass
class PagedKVCache:
    """The engine's paged decode cache: ONE pool of ``cfg.kv_pages``
    pages of ``cfg.kv_page_size`` token slots each, shared by every
    request slot and independent of the batch. Each layer's pool is
    ``key``/``value`` [N, P, H, D] in ``cfg.dtype`` and ``pos`` [N, P]
    int32 (the cached position id, -1 = empty), stored stacked over the
    layers ([n_layers, N + 1, ...]) so that one op invalidates or copies
    a page in every layer.

    Page N (one past the pool) is the SINK: every write the reference
    drops (a pad position, a negative location, a block the row's table
    has not allocated) lands there instead, because PyTorch has no
    dropping scatter. No block table maps it and the gather clips table
    entries to N - 1, so it is never read. Routing writes to it keeps
    the decode step free of host syncs (no boolean-mask indexing).

    With ``cfg.kv_quant == "int8"`` the entries are int8 and
    ``key_scale`` / ``value_scale`` [n_layers, N + 1, P] f32 hold each
    token's scale (the sink page's too: the scale writes take the same
    routing)."""

    key: torch.Tensor
    value: torch.Tensor
    pos: torch.Tensor
    key_scale: Optional[torch.Tensor] = None
    value_scale: Optional[torch.Tensor] = None

    @classmethod
    def allocate(cls, cfg: "TransformerConfig",
                 device: Any = None) -> "PagedKVCache":
        if cfg.kv_page_size < 1:
            raise ValueError("PagedKVCache needs cfg.kv_page_size > 0")
        n, N, P = cfg.n_layers, cfg.kv_pages, cfg.kv_page_size
        H, D = cfg.n_heads, cfg.head_dim
        int8 = cfg.kv_quant == "int8"
        dt = torch.int8 if int8 else cfg.dtype

        def scale_plane():
            return torch.zeros(n, N + 1, P, dtype=torch.float32,
                               device=device) if int8 else None

        return cls(
            torch.zeros(n, N + 1, P, H, D, dtype=dt, device=device),
            torch.zeros(n, N + 1, P, H, D, dtype=dt, device=device),
            torch.full((n, N + 1, P), -1, dtype=torch.int32, device=device),
            scale_plane(), scale_plane())

    @property
    def scales(self) -> List[torch.Tensor]:
        """The int8 pool's scale planes (none for a full-precision pool)."""
        return [t for t in (self.key_scale, self.value_scale)
                if t is not None]

    @property
    def layers(self) -> List[LayerKV]:
        ks, vs = self.key_scale, self.value_scale
        return [LayerKV(self.key[i], self.value[i], self.pos[i],
                        None if ks is None else ks[i],
                        None if vs is None else vs[i])
                for i in range(self.key.shape[0])]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.key, self.value, self.pos, *self.scales))


# ---------------------------------------------------------------------------
# Remat: the reference's checkpoint_name tags and save policies
# ---------------------------------------------------------------------------
#
# A tag names the tensor an op produces. The reference wraps the tensor
# (``checkpoint_name(y, "attn_q")``); here the op runs inside
# ``remat_name("attn_q")`` and the selective-checkpoint policy, which
# sees every op as the dispatcher runs it, keeps the output of the
# scope's matrix product. The outputs of the flash forward come out of
# one ``kfx::flash_fwd`` launch, so they are kept together, when both
# ``flash_o`` and ``flash_lse`` are in the save set (the reference keeps
# either alone, but then re-runs the kernel for the other).

_REMAT_NAME: "contextvars.ContextVar[Tuple[str, ...]]" = \
    contextvars.ContextVar("kfx_remat_name", default=())

_aten = torch.ops.aten
# Matrix products as the dispatcher sees them (matmul and einsum lower to
# these): the counterpart of XLA's dot_general.
_MATMULS = frozenset((_aten.mm.default, _aten.addmm.default,
                      _aten.bmm.default, _aten.baddbmm.default))
_NO_BATCH_MATMULS = frozenset((_aten.mm.default, _aten.addmm.default))


@contextlib.contextmanager
def remat_name(*names: str):
    """Tag the tensors the enclosed matrix product (or flash forward)
    produces with ``names``, for the remat save policies."""
    tok = _REMAT_NAME.set(names)
    try:
        yield
    finally:
        _REMAT_NAME.reset(tok)


def _save_ops(ops) -> Callable:
    def policy(ctx, op, *args, **kwargs):
        return (_ckpt.CheckpointPolicy.MUST_SAVE if op in ops
                else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)
    return policy


def _save_names(*names: str) -> Callable:
    keep = frozenset(names)

    def policy(ctx, op, *args, **kwargs):
        tags = _REMAT_NAME.get()
        if tags and keep.issuperset(tags) and (
                op in _MATMULS or op == flash_ops.FLASH_FWD_OP):
            return _ckpt.CheckpointPolicy.MUST_SAVE
        return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE
    return policy


# The reference's policies (models/transformer.py, TransformerLM), with
# the same save sets; "nothing" is full remat.
REMAT_POLICIES: Dict[str, Optional[Callable]] = {
    "nothing": None,
    "dots": _save_ops(_MATMULS),
    "dots_no_batch": _save_ops(_NO_BATCH_MATMULS),
    "save_dense": _save_names(
        "attn_q", "attn_k", "attn_v", "attn_out", "mlp_wi", "mlp_wo",
        "moe_wi", "moe_wo"),
    "save_flash": _save_names(
        "attn_q", "attn_k", "attn_v", "flash_o", "flash_lse"),
    "save_flash_min": _save_names("flash_o", "flash_lse"),
    "save_flash_full": _save_names(
        "attn_q", "attn_k", "attn_v", "attn_out", "mlp_wo", "flash_o",
        "flash_lse"),
}


def remat_policy(name: str) -> Optional[Callable]:
    """The selective-checkpoint policy of ``name`` (None = full remat);
    ``save_names:a,b,...`` keeps an ad-hoc set. Raises the reference's
    ValueError for an unknown name."""
    if name.startswith("save_names:"):
        return _save_names(*(n for n in name.split(":", 1)[1].split(",")
                             if n))
    try:
        return REMAT_POLICIES[name]
    except KeyError:
        raise ValueError(f"unknown remat_policy {name!r} "
                         f"(have {sorted(REMAT_POLICIES)})") from None


def flash_window_ok(cfg: TransformerConfig, seq_len: int) -> bool:
    """Whether ``seq_len`` falls in the configured attn_impl="auto"
    flash window (flash_max_seq <= 0 means unbounded above)."""
    if seq_len < cfg.flash_min_seq:
        return False
    return cfg.flash_max_seq <= 0 or seq_len < cfg.flash_max_seq


# ---------------------------------------------------------------------------
# Meshes: the model's params cut over a RankMesh, and the collectives
# ---------------------------------------------------------------------------
#
# ``TransformerLM.shard`` keeps this rank's slice of every param, as
# ``parallel/mesh.py``'s rules cut it, and gives every module the
# ``ModelParallel`` it runs under. The forward then inserts the
# collectives GSPMD inserts for the reference (parallel/comm.py):
#   * tp: heads of q/k/v/out, the FFN hidden (column- then row-parallel)
#     and the vocab of the embedding and the lm_head are cut over "model";
#     a tensor-parallel region is entered with ``enter`` and left with
#     ``exit`` (an all-reduce; under sp a reduce-scatter of the sequence,
#     whose inverse all-gather is ``enter``). The vocab-parallel loss is
#     parallel/lm_train.py's;
#   * sp: between those regions the residual stream is cut on S over
#     "model" (the reference's ``Block.sp_shard``);
#   * cp: S is cut over "ctx" for the whole stack, with global positions;
#     attention is the ring (parallel/ring_attention.py); the MoE layer
#     gathers the sequence (its routing groups are whole rows);
#   * fsdp: dims named "embed" are cut over "data" at rest and gathered
#     before each use (``ModelParallel.use``), grads reduce-scattered;
#   * ep: the experts are cut over "data"; token buffers move by
#     all-to-all.
# The SwiGLU kernels' hidden dim is gate || up: a rank keeps the matching
# slices of both halves, so its SwiGLU is local (``_PAIRED``).

_AXES_BY_SUFFIX: Dict[str, Tuple[Optional[str], ...]] = {
    "embed.embedding": ("vocab", "embed"),
    "attn.query.kernel": ("embed", "heads", "kv"),
    "attn.key.kernel": ("embed", "heads", "kv"),
    "attn.value.kernel": ("embed", "heads", "kv"),
    "attn.out.kernel": ("heads", "kv", "embed"),
    "mlp.wi.kernel": ("embed", "mlp"),
    "mlp.wo.kernel": ("mlp", "embed"),
    "moe.gate.kernel": ("embed", None),
    "moe.wi": ("expert", "embed", "expert_mlp"),
    "moe.wo": ("expert", "expert_mlp", "embed"),
    "lm_head.kernel": ("embed", "vocab"),
}
# Params whose last dim is gate || up (split per half).
_PAIRED = ("mlp.wi.kernel", "moe.wi")
# Dims tensor parallelism must cut (the Megatron layout has no
# replicated variant of these regions here).
_TP_AXES = ("vocab", "heads", "mlp", "expert_mlp")


def _suffix(name: str, suffixes) -> Optional[str]:
    for suf in suffixes:
        if name == suf or name.endswith("." + suf):
            return suf
    return None


def param_logical_axes(shapes: Dict[str, Tuple[int, ...]]
                       ) -> Dict[str, Tuple[Optional[str], ...]]:
    """Logical axis names of every param of a ``state_dict`` ({name:
    shape} -> {name: axes}), the reference's ``param_logical_axes`` over
    the port's names: norms and anything unmatched are replicated. The
    port's layers are separate modules, so there is no "layers" axis."""
    out = {}
    for name, shape in shapes.items():
        suf = _suffix(name, _AXES_BY_SUFFIX)
        axes = _AXES_BY_SUFFIX[suf] if suf else (None,) * len(shape)
        if len(axes) != len(shape):
            raise ValueError(f"{name}: axes {axes} for shape {shape}")
        out[name] = axes
    return out


def local_shard(name: str, full: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's slice of the full param ``name`` cut as ``spec`` (a
    mesh axis or None per dim) says; "stage" is not a tensor cut."""
    x = full
    for dim, ax in enumerate(spec):
        if ax is None or ax == "stage" or mesh.shape[ax] == 1:
            continue
        n, i = mesh.shape[ax], mesh.index(ax)
        if _suffix(name, _PAIRED) and dim == x.dim() - 1:
            x = x.unflatten(dim, (2, -1)).chunk(n, dim + 1)[i].flatten(
                dim, dim + 1)
        else:
            x = x.chunk(n, dim)[i]
    return x.clone()


def full_from_shards(name: str, local: torch.Tensor, spec, mesh
                     ) -> torch.Tensor:
    """Inverse of ``local_shard``: the full param, all-gathered over the
    axes that cut it (collective over those axes' groups); always a new
    tensor."""
    x = local.clone()
    for dim, ax in enumerate(spec):
        if ax is None or ax == "stage" or mesh.shape[ax] == 1:
            continue
        n = mesh.shape[ax]
        g = comm.raw_all_gather(x, mesh, ax, dim)
        if _suffix(name, _PAIRED) and dim == x.dim() - 1:
            g = g.unflatten(dim, (n, 2, -1)).transpose(dim, dim + 1) \
                .flatten(dim, dim + 2)
        x = g
    return x


class ModelParallel:
    """The mesh a sharded ``TransformerLM`` runs on (``shard``)."""

    def __init__(self, mesh, cfg: "TransformerConfig"):
        self.mesh = mesh
        self.tp = mesh.shape["model"]
        self.dp = mesh.shape["data"]
        self.cp = mesh.shape["ctx"]
        self.sp = cfg.sp and self.tp > 1
        self.ep = False   # experts cut over "data" (set by shard)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """Into a tensor-parallel region: identity (all-reduce of the
        grad), or under sp the all-gather of the sequence."""
        if self.tp == 1:
            return x
        if self.sp:
            return comm.gather_from(x, self.mesh, "model", 1)
        return comm.copy_to(x, self.mesh, "model")

    def exit(self, y: torch.Tensor) -> torch.Tensor:
        """Out of a tensor-parallel region: the all-reduce of the partial
        sums, or under sp their reduce-scatter over the sequence."""
        if self.tp == 1:
            return y
        if self.sp:
            return comm.scatter_to(y, self.mesh, "model", 1)
        return comm.reduce_from(y, self.mesh, "model")

    def use(self, p: torch.Tensor) -> torch.Tensor:
        """``p`` whole along its fsdp dim (all-gathered over "data";
        the grad reduce-scattered back)."""
        dim = getattr(p, "kfx_fsdp_dim", None)
        return p if dim is None else comm.gather_from(p, self.mesh, "data",
                                                      dim)


def _partial_axes(name: str, spec, mesh, cfg: "TransformerConfig"
                  ) -> Tuple[str, ...]:
    """The mesh axes over which ``name``'s grad is a partial sum that
    the train loop all-reduces after the backward: "data" unless the
    param is cut on it (fsdp's reduce-scatter and ep's all-to-all sum
    there), "ctx" always (each rank holds a slice of the sequence),
    "model" for the norms under sp (they see a slice of the sequence)
    and the MoE router under tp (it weighs partial expert outputs)."""
    out = []
    if mesh.shape["data"] > 1 and "data" not in spec:
        out.append("data")
    if mesh.shape["ctx"] > 1:
        out.append("ctx")
    if mesh.shape["model"] > 1 and "model" not in spec and (
            name.endswith("moe.gate.kernel")
            or (cfg.sp and name.endswith("scale"))):
        out.append("model")
    return tuple(out)


# Attention activations probe (the reference's ``activation_probe``):
# ``fn(name, tensor)`` sees q/k/v, the attention mix and each layer's
# residual input; parallel/spmd_check.py's replication check reads them.
_ACTIVATION_PROBE: "contextvars.ContextVar[Optional[Callable]]" = \
    contextvars.ContextVar("kfx_activation_probe", default=None)


def _probe(name: str, x: torch.Tensor) -> None:
    fn = _ACTIVATION_PROBE.get()
    if fn is not None:
        fn(name, x)


@contextlib.contextmanager
def activation_probe(fn: Callable):
    """Scope ``fn(name, tensor)`` as the activation probe."""
    tok = _ACTIVATION_PROBE.set(fn)
    try:
        yield
    finally:
        _ACTIVATION_PROBE.reset(tok)


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

    def __init__(self, in_shape, out_shape, cfg: TransformerConfig,
                 dtype: Optional[torch.dtype] = None,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        self.dtype = dtype or cfg.dtype
        self.kernel = nn.Parameter(torch.empty(
            *self.in_shape, *self.out_shape,
            dtype=param_dtype or cfg.param_dtype))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            _lecun_normal_(self.kernel, math.prod(self.in_shape), generator)

    par: Optional[ModelParallel] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernel = self.kernel if self.par is None else self.par.use(
            self.kernel)
        in_shape, out_shape = kernel.shape[:len(self.in_shape)], \
            kernel.shape[len(self.in_shape):]
        n_in, n_out = math.prod(in_shape), math.prod(out_shape)
        lead = x.shape[:x.dim() - len(in_shape)]
        w = kernel.to(self.dtype).reshape(n_in, n_out)
        y = torch.matmul(x.to(self.dtype).reshape(*lead, n_in), w)
        return y.reshape(*lead, *out_shape)


# ---------------------------------------------------------------------------
# int8 weights: the reference's per-output-channel symmetric scheme
# ---------------------------------------------------------------------------
#
# Module paths ``quantize_params_int8`` rewrites (and ``QuantDense``
# consumes when cfg.quant == "int8"): path suffix -> number of OUTPUT
# axes of that kernel (the scale's shape; every other non-layer axis is a
# contraction axis the per-channel max reduces over). Embeddings, norms
# and MoE experts stay full precision.
_QUANT_SUFFIXES: Dict[Tuple[str, ...], int] = {
    ("attn", "query"): 2,
    ("attn", "key"): 2,
    ("attn", "value"): 2,
    ("attn", "out"): 1,
    ("mlp", "wi"): 1,
    ("mlp", "wo"): 1,
    ("lm_head",): 1,
}


def _quant_suffix(path: Tuple[str, ...]) -> Optional[int]:
    for suffix, n_out in _QUANT_SUFFIXES.items():
        if path[-len(suffix):] == suffix:
            return n_out
    return None


def _np_f32(w) -> np.ndarray:
    """An f32 numpy copy of an array or a tensor (a bf16 leaf of a
    reference tree may be a tensor: numpy has no bfloat16)."""
    if isinstance(w, torch.Tensor):
        return w.detach().to("cpu", torch.float32).numpy()
    return np.asarray(w, np.float32)


def _is_int8(x) -> bool:
    return (x.dtype == torch.int8 if isinstance(x, torch.Tensor)
            else np.asarray(x).dtype == np.int8)


def quantize_leaf_int8(w, n_out: int, lead: int = 0
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """THE per-channel symmetric int8 scheme: max|w| over the contraction
    axes (everything between ``lead`` layer-stack axes and the last
    ``n_out`` output axes), ``scale = amax / 127`` in f32 (1 for an
    all-zero channel, so dequant is exact), values rounded half-to-even
    and clipped to [-127, 127]. Returns (q int8, scale f32). The
    classifier export's quantizer (serving/export.py) is this with
    ``n_out=1``."""
    w = _np_f32(w)
    red = tuple(range(lead, w.ndim - n_out))
    amax = np.max(np.abs(w), axis=red)
    scale = np.where(amax > 0, amax / np.float32(127.0),
                     np.float32(1.0)).astype(np.float32)
    q = np.clip(np.round(w / np.expand_dims(scale, red)), -127, 127)
    return q.astype(np.int8), scale


def dequantize_leaf_int8(q, scale, n_out: int, lead: int = 0) -> np.ndarray:
    """Inverse of ``quantize_leaf_int8`` (up to the quantization error):
    ``q * scale`` in f32, the scale broadcast over the contraction axes."""
    q = np.asarray(q)
    red = tuple(range(lead, q.ndim - n_out))
    return q.astype(np.float32) * np.expand_dims(_np_f32(scale), red)


def _map_quant_leaves(params, fn):
    """Rebuild a reference-layout tree, replacing each covered
    projection's dict ``v`` with ``fn(v, n_out, lead)`` (None keeps it);
    the input is not mutated."""
    def walk(node, path):
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            p = path + (k,)
            n_out = _quant_suffix(p)
            got = None
            if isinstance(v, dict) and "kernel" in v and n_out is not None:
                got = fn(v, n_out, 1 if "layers" in p else 0)
            out[k] = got if got is not None else walk(v, p)
        return out

    return walk(params, ())


def quantize_params_int8(params):
    """Full-precision TransformerLM params (the reference's layout: nested
    dicts of arrays, the layers stacked) -> the ``quant="int8"``
    structure: each covered projection's ``{"kernel": w}`` becomes
    ``{"kernel": int8, "scale": f32}`` with one scale per output channel,
    per layer for the stacked kernels. Everything else passes through."""
    def quant(v, n_out, lead):
        if _is_int8(v["kernel"]):
            return None
        q, scale = quantize_leaf_int8(v["kernel"], n_out, lead=lead)
        return {**{k: x for k, x in v.items() if k != "kernel"},
                "kernel": q, "scale": scale}

    return _map_quant_leaves(params, quant)


def dequantize_params_int8(params):
    """Inverse of ``quantize_params_int8`` (up to the quantization error):
    int8 kernels expand back to f32 ``q * scale`` and the scale leaves go
    (the ``KFX_LM_QUANT=0`` escape hatch)."""
    def dequant(v, n_out, lead):
        if "scale" not in v or not _is_int8(v["kernel"]):
            return None
        w = dequantize_leaf_int8(v["kernel"], v["scale"], n_out, lead=lead)
        return {**{k: x for k, x in v.items()
                   if k not in ("kernel", "scale")}, "kernel": w}

    return _map_quant_leaves(params, dequant)


def params_quantized(params) -> bool:
    """Whether a param tree (nested dicts) or a ``state_dict`` carries
    int8 kernels."""
    if isinstance(params, dict):
        return any(params_quantized(v) for v in params.values())
    return _is_int8(params)


class QuantDense(nn.Module):
    """The reference's ``QuantDenseGeneral``: an int8 ``kernel`` of shape
    ``in_shape + out_shape`` and an f32 ``scale`` of ``out_shape``, both
    frozen, with the scale applied to the product, never to the kernel:
    ``y = (x @ kernel.to(dtype)) * scale`` in f32, then ``dtype``. The
    convert materialises a ``dtype`` copy of the kernel on every call
    (there is no fused int8-weight product here). Init is structural
    (zero kernel, unit scales): real params come from
    ``quantize_params_int8``."""

    def __init__(self, in_shape, out_shape, cfg: TransformerConfig,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        self.dtype = dtype or cfg.dtype
        self.kernel = nn.Parameter(torch.zeros(
            *self.in_shape, *self.out_shape, dtype=torch.int8),
            requires_grad=False)
        self.scale = nn.Parameter(torch.ones(
            *self.out_shape, dtype=torch.float32), requires_grad=False)

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.kernel.zero_()
            self.scale.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n_in, n_out = math.prod(self.in_shape), math.prod(self.out_shape)
        lead = x.shape[:x.dim() - len(self.in_shape)]
        w = self.kernel.to(self.dtype).reshape(n_in, n_out)
        y = torch.matmul(x.to(self.dtype).reshape(*lead, n_in), w)
        y = (y.to(torch.float32) * self.scale.reshape(n_out)).to(self.dtype)
        return y.reshape(*lead, *self.out_shape)


def _dense(cfg: TransformerConfig) -> type:
    """The projection class of ``cfg``: ``QuantDense`` under int8 weights."""
    return QuantDense if cfg.quant == "int8" else Dense


# 1/127 in f32: the reference's compiled decode step computes max|x| / 127
# as a product with this constant (XLA folds a constant divisor into its
# reciprocal), so multiplying by it writes the reference's scales bit for
# bit.
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def _q8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int8 pool's quantize-on-write (the reference's ``q8``): each
    token's K/V row [..., H, D] rounded half-to-even to int8 against its
    own scale ``max|x| / 127`` in f32; a zero row gives zero codes and
    scale 0."""
    xf = x.to(torch.float32)
    s = xf.abs().amax(dim=(-2, -1)) * _INV_127
    q = torch.round(xf / s.clamp_min(1e-30)[..., None, None])
    return q.clamp(-127, 127).to(torch.int8), s


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


# ---------------------------------------------------------------------------
# LoRA: train-time factors and the serving-time batched gather
# ---------------------------------------------------------------------------

# One layer's serving stacks: {"attn": {"query": {"a": [n_slots, d_in, r],
# "b": [n_slots, r, d_out]}, ...}, "mlp": {...}} (serving/adapters.py).
LoraTree = Dict[str, Dict[str, Dict[str, torch.Tensor]]]


def lora_gather_delta(x: torch.Tensor, entry: Dict[str, torch.Tensor],
                      adapter_ids: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
    """Batched-gather LoRA (the reference's ``lora_gather_delta``): one
    projection's low-rank correction for a batch in which every row may
    wear a different adapter. ``entry`` is the projection's serving stack
    ``{"a": [n_slots, d_in, r], "b": [n_slots, r, d_out]}`` (alpha/rank
    already folded into ``b``) and ``adapter_ids`` [B] picks each row's
    slot, -1 for the base: that row's delta is exactly 0. x is the
    projection INPUT [B, S, d_in]; returns [B, S, d_out] in ``dtype``."""
    ids = adapter_ids.long()
    safe = ids.clamp_min(0)
    a = entry["a"].index_select(0, safe).to(dtype)     # [B, d_in, r]
    b = entry["b"].index_select(0, safe).to(dtype)     # [B, r, d_out]
    d = torch.bmm(torch.bmm(x.to(dtype), a), b)
    return torch.where((ids >= 0)[:, None, None], d, 0.0)


def lora_layers(tree: Dict[str, Any], n_layers: int) -> List[LoraTree]:
    """Per-layer views of serving stacks whose leaves carry a leading
    layers axis ([L, n_slots, ...]): the form ``TransformerLM.forward``
    takes. The views share the stacks' storage, so a slot written in
    place is seen."""
    return [{mod: {name: {k: v[i] for k, v in pair.items()}
                   for name, pair in node.items()}
             for mod, node in tree.items()} for i in range(n_layers)]


class _LoraFactors:
    """Mixin for a module whose projections ``names`` take train-time LoRA
    factors when ``cfg.lora_rank > 0``."""

    def _add_lora(self, cfg: TransformerConfig,
                  dims: Dict[str, Tuple[int, int]]) -> None:
        self._lora_names = tuple(dims) if cfg.lora_rank > 0 else ()
        for name in self._lora_names:
            d_in, d_out = dims[name]
            setattr(self, f"{name}_lora_a", nn.Parameter(torch.empty(
                d_in, cfg.lora_rank, dtype=torch.float32)))
            setattr(self, f"{name}_lora_b", nn.Parameter(torch.zeros(
                cfg.lora_rank, d_out, dtype=torch.float32)))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            for name in self._lora_names:
                nn.init.normal_(getattr(self, f"{name}_lora_a"), 0.0, 0.02,
                                generator=generator)
                # B starts at zero: step 0 of a fine-tune IS the base.
                getattr(self, f"{name}_lora_b").zero_()

    def _lora(self, name: str, y: torch.Tensor, inp: torch.Tensor,
              lora: Optional[Dict[str, Dict[str, torch.Tensor]]],
              adapter_ids: Optional[torch.Tensor]) -> torch.Tensor:
        """``y`` (projection ``name``'s output, any trailing feature
        shape) plus every configured correction: the train-time factors
        and the serving stack ``lora[name]``. With neither, ``y``."""
        cfg = self.cfg
        entry = (lora or {}).get(name)
        if name not in self._lora_names and entry is None:
            return y
        B, S = y.shape[:2]
        flat = inp.reshape(B, S, -1)
        delta = None
        if name in self._lora_names:
            a = getattr(self, f"{name}_lora_a")
            b = getattr(self, f"{name}_lora_b")
            h = torch.matmul(flat.to(cfg.dtype), a.to(cfg.dtype))
            delta = torch.matmul(h, b.to(cfg.dtype)) \
                * (cfg.lora_alpha / cfg.lora_rank)
        if entry is not None:
            g = lora_gather_delta(flat, entry, adapter_ids, cfg.dtype)
            delta = g if delta is None else delta + g
        return y + delta.reshape(y.shape).to(y.dtype)


class Attention(_LoraFactors, nn.Module):
    par: Optional[ModelParallel] = None

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        heads = (cfg.n_heads, cfg.head_dim)
        proj = _dense(cfg)
        self.query = proj((cfg.d_model,), heads, cfg)
        self.key = proj((cfg.d_model,), heads, cfg)
        self.value = proj((cfg.d_model,), heads, cfg)
        self.out = proj(heads, (cfg.d_model,), cfg)
        d, q = cfg.d_model, cfg.qkv_features
        self._add_lora(cfg, {"query": (d, q), "key": (d, q),
                             "value": (d, q), "out": (q, d)})

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
                cursor: Optional[torch.Tensor] = None,
                block_tables: Optional[torch.Tensor] = None,
                write_locations: Optional[torch.Tensor] = None,
                lora=None, adapter_ids: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        cfg, par = self.cfg, self.par
        if par is not None:
            x = par.enter(x)
        B, S, _ = x.shape
        tag = _tagger(cfg)
        # LoRA corrections land at the projection OUTPUT, before rope and
        # the head scaling: where a merged kernel W + scale A B puts them.
        with tag("attn_q"):
            q = self.query(x)
        q = self._lora("query", q, x, lora, adapter_ids)
        with tag("attn_k"):
            k = self.key(x)
        k = self._lora("key", k, x, lora, adapter_ids)
        with tag("attn_v"):
            v = self.value(x)
        v = self._lora("value", v, x, lora, adapter_ids)
        pos = torch.clamp(positions, min=0)
        q = rope(q, pos)
        k = rope(k, pos)
        q = q / math.sqrt(cfg.head_dim)
        _probe("attn_q", q)
        _probe("attn_k", k)
        _probe("attn_v", v)
        if kv is not None and block_tables is not None:
            out = self._paged_attend(q, k, v, positions, kv, block_tables,
                                     write_locations)
        elif kv is not None:
            out = self._decode_attend(q, k, v, positions, kv, cursor)
        elif par is not None and par.cp > 1:
            # S cut over "ctx": exact causal ring attention in f32 (the
            # reference's shard_map around ring_attention), local heads.
            from ..parallel.ring_attention import ring_attention

            out = ring_attention(q, k, v, par.mesh)
        elif self._use_flash(S, x.device):
            # The forward op's outputs carry the flash_o / flash_lse tags,
            # so a save_flash* policy keeps them and the backward runs only
            # the two backward kernels.
            with tag("flash_o", "flash_lse"):
                o, lse = flash_ops.flash_attention_fwd(q, k, v)
            out = flash_ops.flash_attention_apply(q, k, v, o, lse)
        else:
            # Dense causal attention: scores in the compute dtype, masked
            # with the dtype's min, softmax in f32 (the reference's path).
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
            mask = torch.ones(S, S, dtype=torch.bool,
                              device=x.device).tril()
            scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
            probs = torch.softmax(scores.to(torch.float32), -1)
            out = torch.einsum("bhqk,bkhd->bqhd", probs.to(cfg.dtype), v)
        _probe("attn_mix", out)
        with tag("attn_out"):
            y = self.out(out)
        y = self._lora("out", y, out, lora, adapter_ids)
        return y if par is None else par.exit(y)

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
        return self._attend_cached(q, kv.key, kv.value, kv.pos, positions)

    def _paged_attend(self, q, k, v, positions, kv: LayerKV,
                      block_tables: torch.Tensor,
                      write_locations: Optional[torch.Tensor]
                      ) -> torch.Tensor:
        """The reference's paged ``_decode_attend`` branch (vLLM-style):
        ``kv`` is one layer of a ``PagedKVCache`` ([N + 1, P, ...], page
        N the sink) and ``block_tables`` [B, L/P] maps each row's logical
        block to a physical page (-1 = unallocated). Each token writes at
        its LOCATION in the row's logical space (page = table[loc // P],
        slot = loc % P): ``write_locations`` [B, S], defaulting to the
        position id (exact for prefill); the engine's decode steps pass
        the dense-equivalent location, so the logical layout, pad gaps
        included, is the one-shot cache's. Writes of pad positions, of
        negative or out-of-range locations and into unallocated blocks go
        to the sink page. Then each row gathers its logical [L] view
        through its table: unallocated blocks read page 0 with position
        -1, so the same ``0 <= kp <= qp`` rule masks them."""
        cfg = self.cfg
        B, S, H, D = q.shape
        # The pool's own geometry: a speculative draft shares this module
        # with the target but owns a pool of another page count.
        N, P, L = kv.key.shape[0] - 1, kv.key.shape[1], cfg.max_seq_len
        loc = positions if write_locations is None else write_locations
        ok = (positions >= 0) & (loc >= 0) & (loc < L)
        blk = torch.where(ok, loc // P, 0).long()
        page = torch.gather(block_tables, 1, blk)               # [B, S]
        page = torch.where(ok & (page >= 0), page, N).long()
        slot = torch.where(ok, loc % P, 0).long()
        int8 = kv.key_scale is not None
        if int8:
            # Quantize on write; the scale planes take the entries' routing
            # (the sink page absorbs the dropped writes of both).
            kq, ks = _q8(k)
            vq, vs = _q8(v)
            kv.key[page, slot] = kq
            kv.value[page, slot] = vq
            kv.key_scale[page, slot] = ks
            kv.value_scale[page, slot] = vs
        else:
            kv.key[page, slot] = k.to(cfg.dtype)
            kv.value[page, slot] = v.to(cfg.dtype)
        kv.pos[page, slot] = positions.to(torch.int32)
        pt = block_tables.clamp(0, N - 1).long()                # [B, L/P]
        gk = kv.key[pt].reshape(B, L, H, D)
        gv = kv.value[pt].reshape(B, L, H, D)
        if int8:
            # Dequantize after the gather: entries times their token's
            # scale in f32, then the compute dtype.
            gks = kv.key_scale[pt].reshape(B, L)[..., None, None]
            gvs = kv.value_scale[pt].reshape(B, L)[..., None, None]
            gk = (gk.to(torch.float32) * gks).to(cfg.dtype)
            gv = (gv.to(torch.float32) * gvs).to(cfg.dtype)
        gp = torch.where(block_tables[..., None] >= 0, kv.pos[pt],
                         -1).reshape(B, L)
        return self._attend_cached(q, gk, gv, gp, positions)

    def _attend_cached(self, q, gk, gv, gp, positions) -> torch.Tensor:
        """Attention of the S queries over a cached [B, L] view, masked by
        cached position (``0 <= kp <= qp``): empty and pad slots (-1) and
        not-yet-written slots never contribute, and query i of a
        multi-token window sees the window's earlier tokens."""
        scores = torch.einsum("bqhd,bkhd->bhqk", q, gk)       # [B, H, S, L]
        kp = gp[:, None, None, :]
        qp = positions[:, None, :, None]
        mask = (kp >= 0) & (kp <= qp)
        scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
        probs = torch.softmax(scores.to(torch.float32), -1)
        return torch.einsum("bhqk,bkhd->bqhd", probs.to(self.cfg.dtype), gv)


def _tagger(cfg: TransformerConfig) -> Callable:
    """``remat_name`` when the model rematerialises, else a no-op scope
    (the tags cost nothing on the decode path)."""
    return remat_name if cfg.remat else _no_scope


def _no_scope(*names: str):
    return contextlib.nullcontext()


class DenseFFN(_LoraFactors, nn.Module):
    par: Optional[ModelParallel] = None

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        proj = _dense(cfg)
        self.wi = proj((cfg.d_model,), (2 * cfg.d_ff,), cfg)
        self.wo = proj((cfg.d_ff,), (cfg.d_model,), cfg)
        self._add_lora(cfg, {"wi": (cfg.d_model, 2 * cfg.d_ff),
                             "wo": (cfg.d_ff, cfg.d_model)})

    def forward(self, x: torch.Tensor, lora=None,
                adapter_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        tag = _tagger(self.cfg)
        if self.par is not None:
            x = self.par.enter(x)
        with tag("mlp_wi"):
            h = self.wi(x)
        h = self._lora("wi", h, x, lora, adapter_ids)
        gate, up = torch.chunk(h, 2, dim=-1)
        act = F.silu(gate) * up  # SwiGLU
        with tag("mlp_wo"):
            y = self.wo(act)
        y = self._lora("wo", y, act, lora, adapter_ids)
        return y if self.par is None else self.par.exit(y)


class MoEFFN(nn.Module):
    """Top-k routed experts (the reference's ``MoEFFN``): an f32 router
    ``gate``, expert kernels ``wi`` [E, d, 2F] and ``wo`` [E, F, d] in
    ``param_dtype``, top-k routing with renormalised weights, and dispatch
    and combine as einsums against one-hot routing tensors.

    ``moe_dispatch="capacity"`` is GShard slotting: each batch row is a
    routing group, every expert owns C = clamp(ceil(capacity_factor * K *
    S / E), 1, S) slots a group, tokens claim slots in sequence order by a
    cumsum over the k-major-last flattening (every first choice before any
    second choice), and tokens past capacity are dropped (their FFN output
    is 0). k is folded before the slot one-hot, so the largest tensor is
    [B, S, E, C]. With C == S nothing drops and it equals ``"dense"``, the
    masked exact oracle. ``forward`` returns (y, the Switch aux loss
    E * sum(me * ce)).

    Under a mesh the routing groups stay whole rows (cp gathers the
    sequence first), ``me`` and ``ce`` are means over the global batch
    (all-reduced over "data"), and with the experts cut over "data" (ep)
    each data rank runs its E/dp experts on every rank's buffers for them,
    exchanged by all-to-all."""

    par: Optional[ModelParallel] = None

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        E, d, F_ = cfg.n_experts, cfg.d_model, cfg.d_ff
        self.gate = Dense((d,), (E,), cfg, dtype=torch.float32,
                          param_dtype=torch.float32)
        self.wi = nn.Parameter(torch.empty(E, d, 2 * F_,
                                           dtype=cfg.param_dtype))
        self.wo = nn.Parameter(torch.empty(E, F_, d, dtype=cfg.param_dtype))

    def reset_parameters(self, generator=None) -> None:
        # flax's lecun_normal on [E, in, out] counts the leading axis into
        # the fan-in (receptive field E).
        E = self.cfg.n_experts
        with torch.no_grad():
            _lecun_normal_(self.wi, E * self.wi.shape[1], generator)
            _lecun_normal_(self.wo, E * self.wo.shape[1], generator)

    def _experts(self, xe: torch.Tensor) -> torch.Tensor:
        """xe: [E, B, T, d] per-expert token buffers -> [E, B, T, d]."""
        cfg, par = self.cfg, self.par
        tag = _tagger(cfg)
        wi, wo = self.wi, self.wo
        if par is not None:
            wi, wo = par.use(wi), par.use(wo)
        if par is not None and par.ep:
            xe = self._exchange(xe, back=False)
        with tag("moe_wi"):
            h = torch.einsum("ebtd,edf->ebtf", xe, wi.to(cfg.dtype))
        gate_h, up = torch.chunk(h, 2, dim=-1)
        with tag("moe_wo"):
            ye = torch.einsum("ebtf,efd->ebtd", F.silu(gate_h) * up,
                              wo.to(cfg.dtype))
        if par is not None and par.ep:
            ye = self._exchange(ye, back=True)
        return ye

    def _exchange(self, xe: torch.Tensor, back: bool) -> torch.Tensor:
        """ep: every data rank's [E, B, T, d] buffers to the owners of
        their experts, as [E/dp, dp * B, T, d] (rows in data-rank order);
        ``back`` is the inverse."""
        par = self.par
        n = par.dp
        if not back:
            got = comm.all_to_all(xe, par.mesh, "data")
            return got.unflatten(0, (n, -1)).transpose(0, 1).flatten(1, 2)
        out = xe.unflatten(1, (n, -1)).transpose(0, 1).flatten(0, 1)
        return comm.all_to_all(out.contiguous(), par.mesh, "data")

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg, par = self.cfg, self.par
        if par is not None:
            x = par.enter(x)
            if par.cp > 1:
                x = comm.gather_from(x, par.mesh, "ctx", 1)
        B, S, _ = x.shape
        E, K, dt = cfg.n_experts, cfg.expert_top_k, cfg.dtype
        probs = torch.softmax(self.gate(x.to(torch.float32)), -1)
        weights, idx = torch.topk(probs, K, dim=-1)
        weights = weights / weights.sum(-1, keepdim=True)
        one_hot = F.one_hot(idx, E)                       # [B, S, K, E]
        if cfg.moe_dispatch == "capacity":
            cap = max(1, min(int(math.ceil(cfg.capacity_factor * K * S / E)),
                             S))
            ohp = one_hot.transpose(1, 2).reshape(B, K * S, E)
            pos = torch.cumsum(ohp, 1) - ohp              # [B, K*S, E]
            keep = (pos < cap) * ohp
            pos = pos.reshape(B, K, S, E).transpose(1, 2)
            keep = keep.reshape(B, K, S, E).transpose(1, 2)
            # A (token, expert) pair is claimed by at most one k (top-k
            # indices are distinct), so k folds before the slot one-hot.
            pos_se = (pos * keep).sum(2)                  # [B, S, E]
            keep_se = keep.sum(2)                         # 0/1 [B, S, E]
            w_se = (weights[..., None] * keep).sum(2)
            dispatch = F.one_hot(pos_se, cap).to(dt) \
                * keep_se.to(dt)[..., None]               # [B, S, E, C]
            combine = w_se.to(dt)[..., None] * dispatch
            xe = torch.einsum("bsd,bsec->ebcd", x, dispatch)
            y = torch.einsum("ebcd,bsec->bsd", self._experts(xe), combine)
        elif cfg.moe_dispatch == "dense":
            # Every expert sees every token, masked: exact at any capacity,
            # E times the token FLOPs (the numerics oracle).
            combine = torch.einsum("bsk,bske->bse", weights.to(dt),
                                   one_hot.to(dt))
            dispatch = (combine > 0).to(dt)
            xe = torch.einsum("bsd,bse->ebsd", x, dispatch)
            y = torch.einsum("ebsd,bse->bsd", self._experts(xe), combine)
        else:
            raise ValueError(
                f"unknown moe_dispatch {cfg.moe_dispatch!r} "
                "(expected 'capacity' or 'dense')")
        # Load-balancing auxiliary loss (Switch-style) over the first
        # choices.
        if par is None:
            me = one_hot[..., 0, :].to(torch.float32).mean((0, 1))
            ce = probs.mean((0, 1))
            return y, E * torch.sum(me * ce)
        n = B * S * par.dp
        me = comm.raw_all_reduce(one_hot[..., 0, :].to(torch.float32).sum(
            (0, 1)), par.mesh, "data") / n
        ce = comm.all_reduce_sum(probs.sum((0, 1)), par.mesh, "data") / n
        if par.cp > 1:
            y = y.chunk(par.cp, 1)[par.mesh.index("ctx")]
        return par.exit(y), E * torch.sum(me * ce)


class Block(nn.Module):
    """One pre-LN decoder layer: attention, then the dense SwiGLU FFN
    (``mlp``) or, with ``n_experts > 0``, the routed experts (``moe``),
    whose aux loss is appended to ``aux_out`` when one is given."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, cfg.dtype)
        self.attn = Attention(cfg)
        self.ln2 = RMSNorm(cfg.d_model, cfg.dtype)
        if cfg.n_experts > 0:
            self.moe = MoEFFN(cfg)
        else:
            self.mlp = DenseFFN(cfg)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                kv: Optional[LayerKV] = None,
                cursor: Optional[torch.Tensor] = None,
                block_tables: Optional[torch.Tensor] = None,
                write_locations: Optional[torch.Tensor] = None,
                aux_out: Optional[List[torch.Tensor]] = None,
                lora: Optional[LoraTree] = None,
                adapter_ids: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """``lora`` is this layer's serving stacks (``lora_layers``) and
        ``adapter_ids`` [B] each row's slot in them."""
        lora = lora or {}
        _probe("residual", x)
        x = x + self.attn(self.ln1(x), positions, kv, cursor, block_tables,
                          write_locations, lora.get("attn"), adapter_ids)
        h = self.ln2(x)
        if hasattr(self, "moe"):
            y, aux = self.moe(h)
            if aux_out is not None:
                aux_out.append(aux)
            return x + y
        return x + self.mlp(h, lora.get("mlp"), adapter_ids)


def _layer_with_aux(layer: Block, x: torch.Tensor, positions: torch.Tensor
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One training-path layer call returning (x, its MoE aux or None):
    the unit ``torch.utils.checkpoint`` re-runs, so a recompute fills a
    list of its own, never the caller's."""
    aux: List[torch.Tensor] = []
    x = layer(x, positions, aux_out=aux)
    return x, (aux[0] if aux else None)


class Embed(nn.Module):
    """flax ``nn.Embed``: the table is cast to ``dtype`` for the lookup.
    With the vocab cut over "model", each rank looks up the tokens of its
    rows (zeros for the others) and the region's exit sums them."""

    par: Optional[ModelParallel] = None

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
        par = self.par
        if par is None:
            return F.embedding(tokens, self.embedding).to(self.dtype)
        table = par.use(self.embedding)
        if par.tp == 1:
            return F.embedding(tokens, table).to(self.dtype)
        rows = table.shape[0]
        lo = par.mesh.index("model") * rows
        mine = (tokens >= lo) & (tokens < lo + rows)
        x = F.embedding(torch.where(mine, tokens - lo, 0), table) \
            * mine[..., None]
        return par.exit(x.to(self.dtype))


class TransformerLM(nn.Module):
    """Returns f32 logits [B, S, vocab]. Call with int tokens [B, S].
    After ``shard`` it runs on a mesh: tokens are this rank's rows (and,
    under cp, its slice of the sequence) and the logits its vocab slice."""

    par: Optional[ModelParallel] = None

    def __init__(self, cfg: TransformerConfig,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        # torch.utils.checkpoint's arguments for one remat'd layer; an
        # unknown policy raises here, as the reference's does at apply.
        self._remat_kw: Dict[str, Any] = {}
        if cfg.remat:
            policy = remat_policy(cfg.remat_policy)
            if policy is not None:
                self._remat_kw["context_fn"] = functools.partial(
                    _ckpt.create_selective_checkpoint_contexts, policy)
        # Params are allocated on ``device`` directly (a base-size model
        # would otherwise pass through host memory first).
        with torch.device(device if device is not None else "cpu"):
            self.embed = Embed(cfg)
            self.layers = nn.ModuleList(
                Block(cfg) for _ in range(cfg.n_layers))
            self.ln_f = RMSNorm(cfg.d_model, cfg.dtype)
            self.lm_head = _dense(cfg)((cfg.d_model,), (cfg.vocab_size,),
                                       cfg)
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
                cache: Union[KVCache, PagedKVCache, None] = None,
                block_tables: Optional[torch.Tensor] = None,
                write_locations: Optional[torch.Tensor] = None,
                return_hidden: bool = False,
                aux_out: Optional[List[torch.Tensor]] = None,
                lora=None, adapter_ids: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """``cache`` is required with ``cfg.decode`` and refused without
        it: a decode model always reads and extends its cache, as the
        reference's does. ``kv_page_size > 0`` takes a ``PagedKVCache``
        with ``block_tables`` [B, L/P] int32 and optional
        ``write_locations`` [B, S] (see ``Attention._paged_attend``);
        otherwise a dense ``KVCache``.

        ``return_hidden`` returns ``ln_f(x)`` [B, S, d] before the
        ``lm_head`` (chunked cross-entropy applies the head per chunk).
        ``aux_out``, a list, receives each MoE layer's aux loss. Without a
        cache, with ``cfg.remat`` and grad enabled, each layer runs under
        ``torch.utils.checkpoint`` with the ``remat_policy``.

        ``lora`` is the multi-tenant serving stacks (serving/adapters.py),
        one tree a layer (``lora_layers``); ``adapter_ids`` [B] picks each
        row's adapter slot (-1, the default, is the base). Without
        ``lora`` the forward is the pre-LoRA one."""
        cfg = self.cfg
        if cfg.decode != (cache is not None):
            raise ValueError("a KVCache is passed exactly when cfg.decode "
                             f"is set (decode={cfg.decode})")
        paged = cfg.kv_page_size > 0
        if cache is not None and (
                isinstance(cache, PagedKVCache) != paged
                or (block_tables is not None) != paged):
            raise ValueError(
                "kv_page_size > 0 decodes through a PagedKVCache with "
                "block_tables; kv_page_size == 0 through a dense KVCache "
                f"without them (kv_page_size={cfg.kv_page_size})")
        S = tokens.shape[1]
        if isinstance(cache, KVCache) and \
                cache.length + S > cfg.max_seq_len:
            raise ValueError(
                f"KV cache overflow: {cache.length} cached + {S} new tokens "
                f"exceed max_seq_len {cfg.max_seq_len}")
        x = self.embed(tokens)
        if positions is None:
            # Global positions: under cp this rank holds slice i of S.
            lo = 0 if self.par is None else \
                self.par.mesh.index("ctx") * S
            positions = torch.arange(lo, lo + S, device=tokens.device,
                                     dtype=torch.int32).expand(tokens.shape)
        layers_kv = cache.layers if cache is not None else None
        if lora and adapter_ids is None:
            adapter_ids = torch.full((tokens.shape[0],), -1,
                                     dtype=torch.int64, device=tokens.device)
        remat = cfg.remat and cache is None and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            if lora:
                x = layer(x, positions, layers_kv[i] if cache is not None
                          else None, getattr(cache, "cursor", None),
                          block_tables, write_locations, aux_out,
                          lora[i], adapter_ids)
            elif cache is None:
                x, aux = self.run_layer(layer, x, positions, remat)
                if aux is not None and aux_out is not None:
                    aux_out.append(aux)
            elif paged:
                x = layer(x, positions, layers_kv[i], None, block_tables,
                          write_locations)
            else:
                x = layer(x, positions, layers_kv[i], cache.cursor)
        if isinstance(cache, KVCache):
            cache.cursor += S
            cache.length += S
        x = self.ln_f(x)
        if self.par is not None:
            x = self.par.enter(x)   # the vocab-parallel head's region
        if return_hidden:
            return x
        return self.lm_head(x).to(torch.float32)

    def run_layer(self, layer: Block, x: torch.Tensor,
                  positions: torch.Tensor, remat: bool
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """One training-path layer: (x, its MoE aux or None), under
        ``torch.utils.checkpoint`` with the remat policy when ``remat``."""
        if remat:
            # No randomness in a layer: no RNG state to keep.
            return _ckpt.checkpoint(
                _layer_with_aux, layer, x, positions, use_reentrant=False,
                preserve_rng_state=False, **self._remat_kw)
        return _layer_with_aux(layer, x, positions)

    def shard(self, mesh, plan) -> "TransformerLM":
        """Keep this rank's slice of every param as ``parallel/mesh.py``'s
        rules cut it under ``plan`` on ``mesh``, and run every module
        under the mesh from here on. Each param records its cut
        (``kfx_spec``), its fsdp dim (``kfx_fsdp_dim``) and the axes its
        grad is summed over after the backward (``kfx_partial``)."""
        from ..parallel.mesh import param_sharding_rules, tree_shardings

        cfg = self.cfg
        if cfg.lora_rank or cfg.quant or cfg.decode:
            raise ValueError("a sharded TransformerLM trains: no LoRA "
                             "factors, int8 weights or decode caches")
        par = ModelParallel(mesh, cfg)
        named = dict(self.named_parameters())
        shapes = {n: tuple(p.shape) for n, p in named.items()}
        axes = param_logical_axes(shapes)
        specs = tree_shardings(mesh, axes, param_sharding_rules(plan),
                               shapes)
        for name, p in named.items():
            spec = specs[name]
            for dim, (logical, ax) in enumerate(zip(axes[name], spec)):
                if par.tp > 1 and logical in _TP_AXES and ax is None:
                    raise ValueError(
                        f"tp={par.tp} does not divide {name} dim {dim} "
                        f"({logical}, {shapes[name][dim]})")
            with torch.no_grad():
                p.data = local_shard(name, p.data, spec, mesh)
            p.kfx_spec = spec
            p.kfx_fsdp_dim = next(
                (d for d, (logical, ax) in enumerate(zip(axes[name], spec))
                 if ax == "data" and logical == "embed"), None)
            p.kfx_partial = _partial_axes(name, spec, mesh, cfg)
            if name.endswith("moe.wi"):
                par.ep = spec[0] == "data"
        for mod in self.modules():
            mod.par = par
        return self


def truncate_layers(model: TransformerLM, n_layers: int,
                    **overrides) -> TransformerLM:
    """The first ``n_layers`` layers of ``model`` as a model of their own,
    sharing ``embed``, ``ln_f`` and ``lm_head``: port of the reference's
    ``truncate_layers``, the serving engine's speculative DRAFT (a
    same-tokenizer prefix of the target whose early-exit logits propose
    tokens the full model verifies). The draft's modules ARE the
    target's (shared Parameters, no copies); its config is the target's
    with ``n_layers`` and ``overrides`` (e.g. the draft pool's
    ``kv_pages``) replaced."""
    depth = len(model.layers)
    if not 1 <= n_layers <= depth:
        raise ValueError(f"draft n_layers {n_layers} not in [1, {depth}]")
    cfg = dataclasses.replace(model.cfg, n_layers=n_layers, **overrides)
    draft = TransformerLM.__new__(TransformerLM)
    nn.Module.__init__(draft)
    draft.cfg = cfg
    draft._remat_kw = model._remat_kw
    draft.embed = model.embed
    draft.layers = nn.ModuleList(model.layers[:n_layers])
    draft.ln_f = model.ln_f
    draft.lm_head = model.lm_head
    return draft.train(model.training)


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
