"""Param conversion between the reference's flax tree and the port's
``state_dict``.

The reference's ``TransformerLM`` params (under ``nn.scan``) are::

    embed/embedding                       [V, d]
    layers/attn/{query,key,value}/kernel  [L, d, H, D]
    layers/attn/out/kernel                [L, H, D, d]
    layers/ln1/scale, layers/ln2/scale    [L, d]
    layers/mlp/wi/kernel                  [L, d, 2F]
    layers/mlp/wo/kernel                  [L, F, d]
    ln_f/scale                            [d]
    lm_head/kernel                        [d, V]

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
# Leaf paths inside the stack (under "layers"): flax path -> key suffix.
_LAYER = {
    ("attn", "query", "kernel"): "attn.query.kernel",
    ("attn", "key", "kernel"): "attn.key.kernel",
    ("attn", "value", "kernel"): "attn.value.kernel",
    ("attn", "out", "kernel"): "attn.out.kernel",
    ("ln1", "scale"): "ln1.scale",
    ("ln2", "scale"): "ln2.scale",
    ("mlp", "wi", "kernel"): "mlp.wi.kernel",
    ("mlp", "wo", "kernel"): "mlp.wo.kernel",
}


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
    want = set(_TOP) | {("layers",) + p for p in _LAYER}
    missing = sorted("/".join(p) for p in want - set(flat))
    extra = sorted("/".join(p) for p in set(flat) - want)
    if missing or extra:
        raise KeyError(f"param tree does not match the dense TransformerLM: "
                       f"missing {missing}, unexpected {extra}")
    out = {key: _tensor(flat[path]) for path, key in _TOP.items()}
    depths = {flat[("layers",) + p].shape[0] for p in _LAYER}
    if len(depths) != 1:
        raise ValueError(f"stacked layer leaves disagree on depth: {depths}")
    for path, suffix in _LAYER.items():
        stacked = flat[("layers",) + path]
        for i in range(stacked.shape[0]):
            out[f"layers.{i}.{suffix}"] = _tensor(stacked[i])
    return out


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """Inverse of ``params_from_jax``: nested dicts of numpy arrays with
    the layer leaves stacked on a leading axis. Raises ``KeyError`` on a
    missing or unknown key."""
    sd = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}
    depth = 0
    while f"layers.{depth}.{_LAYER[('ln1', 'scale')]}" in sd:
        depth += 1
    want = set(_TOP.values()) | {f"layers.{i}.{s}" for i in range(depth)
                                 for s in _LAYER.values()}
    missing, extra = sorted(want - set(sd)), sorted(set(sd) - want)
    if missing or extra or depth == 0:
        raise KeyError(f"state_dict does not match the dense TransformerLM: "
                       f"missing {missing}, unexpected {extra}, "
                       f"depth {depth}")
    tree: dict = {}
    for path, key in _TOP.items():
        _set(tree, path, sd[key])
    for path, suffix in _LAYER.items():
        _set(tree, ("layers",) + path,
             np.stack([sd[f"layers.{i}.{suffix}"] for i in range(depth)]))
    return tree
