"""Classifier export format — port of ``kubeflow_tpu/serving/export.py``
(the ``storageUri`` payload an InferenceService loads).

A directory with:
  config.json    — ``model``, ``input_shape``, ``num_classes``,
                   ``format_version`` and, for a quantized export, a
                   ``quant`` block
  params.msgpack — {params, batch_stats} in flax's layout and msgpack
                   encoding (``models.convert.classifier_params_to_jax``,
                   ``serving/_msgpack.py``), byte for byte what the
                   reference writes for the same weights

so the reference's ``JaxPredictor`` serves a port export and the port's
serves a reference export. ``quantize="int8"`` stores every kernel as
per-output-channel symmetric int8 with an f32 scale per output channel
(the ``{"q", "scale"}`` pair); ``load_exported`` dequantizes on load.

LoRA adapter artifacts (``export_adapter`` / ``load_adapter``): a
directory with ``adapter_config.json`` (format version, name, rank,
alpha, targets and the base dims) and ``params.msgpack`` holding the flat
target tree ``{"attn.query": {"a": [L, d_in, r], "b": [L, r, d_out]},
...}``, unscaled. The same flat tree gives the reference's bytes, and each
package reads the other's artifacts.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..models.transformer import dequantize_leaf_int8, quantize_leaf_int8
from . import _msgpack

# v1: the unversioned {model, input_shape, num_classes} config. v2: adds
# format_version and the optional quant block. Loaders treat a missing
# field as v1, so every pre-versioning export stays loadable.
FORMAT_VERSION = 2
CONFIG_FILE = "config.json"
PARAMS_FILE = "params.msgpack"

# LoRA adapter artifacts: a format of their own beside the model export
# (an adapter is a rank-r correction to a model, not a model).
ADAPTER_CONFIG_FILE = "adapter_config.json"
ADAPTER_FORMAT_VERSION = 1


def _np_leaf(x) -> np.ndarray:
    """A numpy copy of an array or a (device) tensor."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def export_adapter(directory: str, name: str, cfg, lora_flat,
                   rank: int, alpha: float) -> str:
    """Write one versioned LoRA adapter artifact from the flat target tree
    (``serving/adapters.extract_lora`` makes one from a fine-tune's
    tree). The factors are stored unscaled; alpha/rank is metadata,
    folded in when the serving pool loads the adapter."""
    if rank < 1:
        raise ValueError("adapter rank must be >= 1")
    if not lora_flat:
        raise ValueError("lora_flat is empty — nothing to export "
                         "(did the fine-tune config set lora_rank?)")
    os.makedirs(directory, exist_ok=True)
    config = {
        "format_version": ADAPTER_FORMAT_VERSION,
        "kind": "lora_adapter",
        "name": str(name),
        "rank": int(rank),
        "alpha": float(alpha),
        "targets": sorted(lora_flat),
        "base": {
            "d_model": cfg.d_model, "n_layers": cfg.n_layers,
            "n_heads": cfg.n_heads, "head_dim": cfg.head_dim,
            "d_ff": cfg.d_ff, "vocab_size": cfg.vocab_size,
        },
    }
    with open(os.path.join(directory, ADAPTER_CONFIG_FILE), "w") as f:
        json.dump(config, f)
    payload = {k: {kk: _np_leaf(vv) for kk, vv in v.items()}
               for k, v in lora_flat.items()}
    with open(os.path.join(directory, PARAMS_FILE), "wb") as f:
        _msgpack.dump(payload, f)
    return directory


def _adapter_path(uri: str) -> str:
    return uri[len("file://"):] if uri.startswith("file://") else uri


def load_adapter(uri: str) -> Tuple[Dict[str, Any], Any]:
    """Load an adapter artifact (a path or a file:// URI) -> (config,
    flat A/B tree of numpy arrays). A directory that is not an adapter
    artifact (a model export, say) raises."""
    path = _adapter_path(uri)
    with open(os.path.join(path, ADAPTER_CONFIG_FILE)) as f:
        config = json.load(f)
    if config.get("kind") != "lora_adapter":
        raise ValueError(f"{uri} is not a LoRA adapter artifact")
    return config, _msgpack.load(os.path.join(path, PARAMS_FILE))


def peek_adapter_rank(uri: str) -> int:
    """The declared rank from an artifact's config alone (no tensor IO):
    the pool's auto-rank reads every configured source once."""
    with open(os.path.join(_adapter_path(uri), ADAPTER_CONFIG_FILE)) as f:
        return int(json.load(f).get("rank", 0))


def quantize_tree_int8(tree: Any) -> Any:
    """Every array leaf NAMED "kernel" with >= 2 dims becomes ``{"q":
    int8, "scale": f32[out]}`` (the last axis is the output channel for
    Dense [in, out] and Conv [kh, kw, cin, cout] alike), by the LM's
    per-channel formula (``models/transformer.quantize_leaf_int8`` with
    one output axis). Biases, norm scales and batch_stats pass through;
    the input is not mutated."""
    def walk(node):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if k == "kernel" and not isinstance(v, dict):
                    w = np.asarray(v)
                    if w.ndim >= 2 and w.dtype != np.int8:
                        q, scale = quantize_leaf_int8(w, 1)
                        out[k] = {"q": q, "scale": scale}
                        continue
                out[k] = walk(v)
            return out
        return node

    return walk(tree)


def dequantize_tree_int8(tree: Any) -> Any:
    """Inverse of ``quantize_tree_int8`` (up to quantization error)."""
    def walk(node):
        if isinstance(node, dict):
            if set(node) == {"q", "scale"}:
                q = np.asarray(node["q"])
                if q.dtype == np.int8:
                    return dequantize_leaf_int8(q, node["scale"], 1)
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(tree)


def _sorted(tree):
    """Every dict's keys in sorted order: the order ``jax.device_get``
    leaves a flax tree in, so the file is the reference's byte for byte."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def export_params(directory: str, model_name: str, input_shape,
                  num_classes: int, state: Any, quantize: str = "") -> str:
    """Write a servable export from a ``training.loop.TrainState`` (or any
    object whose ``params`` and ``batch_stats`` map the port model's
    state_dict names to tensors)."""
    from ..models.convert import classifier_params_to_jax

    if quantize not in ("", "int8"):
        raise ValueError(
            f"unknown quantize {quantize!r} (expected '' or 'int8')")
    os.makedirs(directory, exist_ok=True)
    params, stats = classifier_params_to_jax(
        model_name, {**state.params, **state.batch_stats})
    params = _sorted(params)
    if quantize == "int8":
        params = quantize_tree_int8(params)
    with open(os.path.join(directory, PARAMS_FILE), "wb") as f:
        _msgpack.dump({"params": params, "batch_stats": _sorted(stats)}, f)
    config: Dict[str, Any] = {"model": model_name,
                              "input_shape": list(input_shape),
                              "num_classes": int(num_classes),
                              "format_version": FORMAT_VERSION}
    if quantize == "int8":
        config["quant"] = {"weights": "int8",
                           "scheme": "per_channel_symmetric"}
    with open(os.path.join(directory, CONFIG_FILE), "w") as f:
        json.dump(config, f)
    return directory


def export_format_version(config: Dict[str, Any]) -> int:
    """Tolerant version read: pre-versioning exports (no field) are v1."""
    try:
        return int(config.get("format_version", 1))
    except (TypeError, ValueError):
        return 1


def load_exported(uri: str) -> Tuple[Dict, Any]:
    """Load an export -> (config, {params, batch_stats}) as numpy trees in
    flax's layout. Accepts a bare path or a file:// URI; an int8 export is
    dequantized here (classifier servers rebuild full-precision models)."""
    path = uri[len("file://"):] if uri.startswith("file://") else uri
    with open(os.path.join(path, CONFIG_FILE)) as f:
        config = json.load(f)
    payload = _msgpack.load(os.path.join(path, PARAMS_FILE))
    quant: Optional[Dict] = config.get("quant")
    if quant and quant.get("weights") == "int8":
        payload = dict(payload)
        payload["params"] = dequantize_tree_int8(payload.get("params"))
    return config, payload
