"""Param conversion between the reference's flax trees and the port's
``state_dict``s: the TransformerLM (``params_from_jax`` /
``params_to_jax``) and the classifier zoo (``classifier_params_from_jax``
/ ``classifier_params_to_jax``, below).

The reference's ``TransformerLM`` params (under ``nn.scan``) are::

    embed/embedding                       [V, d]
    layers/attn/{query,key,value}/kernel  [L, d, H, D]
    layers/attn/out/kernel                [L, H, D, d]
    layers/ln1/scale, layers/ln2/scale    [L, d]
    layers/mlp/wi/kernel                  [L, d, 2F]
    layers/mlp/wo/kernel                  [L, F, d]
      or, with experts (MoEFFN):
    layers/moe/gate/kernel                [L, d, E]
    layers/moe/wi                         [L, E, d, 2F]
    layers/moe/wo                         [L, E, F, d]
    ln_f/scale                            [d]
    lm_head/kernel                        [d, V]

A LoRA fine-tune's tree (``lora_rank > 0``) also holds the factors
``layers/attn/{query,key,value,out}_lora_{a,b}`` and
``layers/mlp/{wi,wo}_lora_{a,b}`` ([L, d_in, r] and [L, r, d_out]), the
port's ``layers.{i}.attn.query_lora_a`` ...

An int8 tree (``quant="int8"``, ``transformer.quantize_params_int8``)
holds ``{kernel: int8, scale: f32}`` beside each quantized kernel
(q/k/v scales ``[L, H, D]``, the others ``[L, out]``); the scales convert
like the kernels (``layers.{i}.attn.query.scale`` ...).

The port keeps every kernel's layout, so conversion renames the leaves
and splits the stacked ``[L, ...]`` leaves per layer
(``layers.{i}.attn.query.kernel`` ...). Trees are nested dicts of numpy
arrays (a bfloat16 leaf, which numpy cannot hold, may be a torch
tensor); nothing here imports JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

# Leaf paths outside the layer stack: flax path -> state_dict key.
_TOP = {
    ("embed", "embedding"): "embed.embedding",
    ("ln_f", "scale"): "ln_f.scale",
    ("lm_head", "kernel"): "lm_head.kernel",
}
# Leaf paths inside the stack (under "layers"): flax path -> key suffix,
# for the attention and norms, then for each kind of FFN.
_LAYER = {
    ("attn", "query", "kernel"): "attn.query.kernel",
    ("attn", "key", "kernel"): "attn.key.kernel",
    ("attn", "value", "kernel"): "attn.value.kernel",
    ("attn", "out", "kernel"): "attn.out.kernel",
    ("ln1", "scale"): "ln1.scale",
    ("ln2", "scale"): "ln2.scale",
}
_DENSE_FFN = {
    ("mlp", "wi", "kernel"): "mlp.wi.kernel",
    ("mlp", "wo", "kernel"): "mlp.wo.kernel",
}
_MOE_FFN = {
    ("moe", "gate", "kernel"): "moe.gate.kernel",
    ("moe", "wi"): "moe.wi",
    ("moe", "wo"): "moe.wo",
}


def _with_scales(leaves: Dict[tuple, str]) -> Dict[tuple, str]:
    """``leaves`` plus the scale leaf beside every kernel an int8 tree
    quantizes (attention, dense FFN, lm_head)."""
    out = dict(leaves)
    for path, key in leaves.items():
        if path[-1] == "kernel" and path[0] in ("attn", "mlp", "lm_head"):
            out[path[:-1] + ("scale",)] = key[:-len("kernel")] + "scale"
    return out


# The LoRA factor leaves of a fine-tune's tree (dense FFN only).
_LORA = {(mod, f"{name}_lora_{ab}"): f"{mod}.{name}_lora_{ab}"
         for mod, names in (("attn", ("query", "key", "value", "out")),
                            ("mlp", ("wi", "wo")))
         for name in names for ab in "ab"}


def _layer_leaves(moe: bool, quant: bool = False,
                  lora: bool = False) -> Dict[tuple, str]:
    leaves = {**_LAYER, **(_MOE_FFN if moe else _DENSE_FFN)}
    if quant:
        leaves = _with_scales(leaves)
    return {**leaves, **_LORA} if lora else leaves


def _top_leaves(quant: bool) -> Dict[tuple, str]:
    return _with_scales(_TOP) if quant else _TOP


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v if isinstance(v, torch.Tensor) \
                else np.asarray(v)
    return out


def _tensor(x) -> torch.Tensor:
    """A CPU tensor that owns a copy of ``x`` (an array or a tensor)."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    return torch.from_numpy(np.array(x))


def _set(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """The reference's param tree (nested dicts of arrays, optionally
    wrapped in ``{"params": ...}``) -> a ``state_dict`` for the port's
    ``TransformerLM``. Raises ``KeyError`` on a missing or unknown leaf."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    flat = _flatten(tree)
    quant = ("lm_head", "scale") in flat
    layer = _layer_leaves(("layers", "moe", "wi") in flat, quant,
                          ("layers", "attn", "query_lora_a") in flat)
    top = _top_leaves(quant)
    want = set(top) | {("layers",) + p for p in layer}
    missing = sorted("/".join(p) for p in want - set(flat))
    extra = sorted("/".join(p) for p in set(flat) - want)
    if missing or extra:
        raise KeyError(f"param tree does not match the TransformerLM: "
                       f"missing {missing}, unexpected {extra}")
    out = {key: _tensor(flat[path]) for path, key in top.items()}
    depths = {flat[("layers",) + p].shape[0] for p in layer}
    if len(depths) != 1:
        raise ValueError(f"stacked layer leaves disagree on depth: {depths}")
    for path, suffix in layer.items():
        stacked = flat[("layers",) + path]
        for i in range(stacked.shape[0]):
            out[f"layers.{i}.{suffix}"] = _tensor(stacked[i])
    return out


def lora_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A LoRA leaf tree in the reference's layout (``layers/attn/
    query_lora_a`` ... stacked over the layers; the lora side of
    ``serving/adapters.split_lora_tree``) -> the factor entries of a
    ``state_dict``. Raises ``KeyError`` on a missing factor."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    flat = _flatten(tree)
    out = {}
    for path, suffix in _LORA.items():
        stacked = flat[("layers",) + path]
        for i in range(stacked.shape[0]):
            out[f"layers.{i}.{suffix}"] = _tensor(stacked[i])
    return out


def _layout(keys) -> tuple:
    """(depth, top leaves, layer leaves) of a ``state_dict``'s keys.
    Raises ``KeyError`` on a missing or unknown key."""
    keys = set(keys)
    depth = 0
    while f"layers.{depth}.{_LAYER[('ln1', 'scale')]}" in keys:
        depth += 1
    quant = "lm_head.scale" in keys
    layer = _layer_leaves(f"layers.0.{_MOE_FFN[('moe', 'wi')]}" in keys,
                          quant, "layers.0.attn.query_lora_a" in keys)
    top = _top_leaves(quant)
    want = set(top.values()) | {f"layers.{i}.{s}" for i in range(depth)
                                for s in layer.values()}
    missing, extra = sorted(want - keys), sorted(keys - want)
    if missing or extra or depth == 0:
        raise KeyError(f"state_dict does not match the TransformerLM: "
                       f"missing {missing}, unexpected {extra}, "
                       f"depth {depth}")
    return depth, top, layer


def tree_signature(state_dict: Mapping[str, torch.Tensor]
                   ) -> Dict[tuple, tuple]:
    """{reference path: (shape, dtype name)} of the tree ``params_to_jax``
    would make from ``state_dict``, read from the tensors' metadata alone
    (nothing is copied, so a device-resident model costs no transfer)."""
    depth, top, layer = _layout(state_dict)

    def meta(t, lead=()):
        return lead + tuple(t.shape), str(t.dtype).replace("torch.", "")

    out = {path: meta(state_dict[key]) for path, key in top.items()}
    for path, suffix in layer.items():
        out[("layers",) + path] = meta(state_dict[f"layers.0.{suffix}"],
                                       (depth,))
    return out


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """Inverse of ``params_from_jax``: nested dicts of numpy arrays with
    the layer leaves stacked on a leading axis. Raises ``KeyError`` on a
    missing or unknown key."""
    depth, top, layer = _layout(state_dict)
    sd = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}
    tree: dict = {}
    for path, key in top.items():
        _set(tree, path, sd[key])
    for path, suffix in layer.items():
        _set(tree, ("layers",) + path,
             np.stack([sd[f"layers.{i}.{suffix}"] for i in range(depth)]))
    return tree


# -- the classifier zoo (mlp, cnn, resnet18/50, vit, vit-s) ----------------
#
# The port's classifiers name their modules as flax auto-names them
# (Dense_i, Conv_i, BatchNorm_i, conv_init, bn_init, ResNetBlock_i /
# BottleneckBlock_i with conv_proj and norm_proj, head, patch_embed,
# pos_embed, ViTBlock_i with MultiHeadDotProductAttention_0 {query, key,
# value, out} and LayerNorm_i), so a flax path is a state_dict key with
# "/" for ".". Conv kernels are the one layout change: flax's [kh, kw,
# cin, cout] is the port's ``weight`` [cout, cin, kh, kw]. BatchNorm's
# ``batch_stats`` {mean, var} are the port's buffers of the same names.

_STATS = ("mean", "var")


def _check_classifier(name: str) -> None:
    from .registry import model_names

    if name not in model_names():
        raise KeyError(f"unknown model {name!r}; have {model_names()}")


def classifier_params_from_jax(name: str, params: Mapping,
                               batch_stats: Mapping = None
                               ) -> Dict[str, torch.Tensor]:
    """The reference classifier ``name``'s flax ``params`` (and
    ``batch_stats``) -> a ``state_dict`` for the port's model of the same
    name. Exact: values are copied, conv kernels transposed."""
    _check_classifier(name)
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(params).items():
        t = _tensor(leaf)
        if path[-1] == "kernel" and t.ndim == 4:
            path, t = path[:-1] + ("weight",), t.permute(3, 2, 0, 1)
        out[".".join(path)] = t.contiguous()
    for path, leaf in _flatten(batch_stats or {}).items():
        if path[-1] not in _STATS:
            raise KeyError(f"unexpected batch_stats leaf {'/'.join(path)}")
        out[".".join(path)] = _tensor(leaf)
    return out


def classifier_params_to_jax(name: str,
                             state_dict: Mapping[str, torch.Tensor]):
    """Inverse of ``classifier_params_from_jax``: (params, batch_stats) as
    nested dicts of f32 numpy arrays in flax's layout."""
    _check_classifier(name)
    params: dict = {}
    stats: dict = {}
    for key, t in state_dict.items():
        path = tuple(key.split("."))
        t = t.detach().cpu()
        if path[-1] in _STATS:
            _set(stats, path, t.numpy().copy())
            continue
        if path[-1] == "weight" and t.ndim == 4:
            path, t = path[:-1] + ("kernel",), t.permute(2, 3, 1, 0)
        _set(params, path, np.ascontiguousarray(t.numpy()))
    return params, stats
