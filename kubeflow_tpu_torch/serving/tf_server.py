"""TensorFlow SavedModel predictor — port of
``kubeflow_tpu/serving/tf_server.py`` (the reference's TFServing runtime)
behind the same V1 data plane.

The serve side is the reference's: pure TensorFlow on the host
(``tf.saved_model.load`` + the ``serving_default`` signature), imported
inside ``load``/``_call``, so a machine without TensorFlow still imports
this module. It serves the SavedModels the reference's
``export_savedmodel`` writes: the standard tree (``saved_model.pb`` +
``variables/``) plus a ``kfx_config.json`` sidecar with the input shape
and class count.

The reference's exporter converts a flax forward through ``jax2tf``. The
port has no JAX, and the card's machine has no TensorFlow, so the port's
``export_savedmodel`` raises (ROADMAP.md Queue A 9b, a SavedModel exporter
for the port's registry models).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np

from .server import Predictor

SAVED_MODEL_FILE = "saved_model.pb"
SIDECAR_FILE = "kfx_config.json"


def is_tf_export(model_dir: str) -> bool:
    return os.path.exists(os.path.join(model_dir, SAVED_MODEL_FILE))


def export_savedmodel(directory: str, model_name: str, input_shape,
                      num_classes: int, state) -> str:
    """Not ported: the reference converts a flax forward with jax2tf."""
    raise NotImplementedError(
        "export_savedmodel: the reference converts a flax forward through "
        "jax2tf; a SavedModel exporter for the port's registry models is "
        "ROADMAP.md Queue A 9b")


class TFPredictor(Predictor):
    """V1-protocol predictor over a SavedModel's serving_default (host)."""

    def __init__(self, model_dir: str, name: str = "",
                 max_batch_size: int = 64, device: str = "cpu"):
        self.model_dir = model_dir
        self.name = name or "model"
        self.max_batch_size = max_batch_size
        self.device = "cpu"   # the host, whatever the caller asked
        self.input_shape: Optional[tuple] = None
        self.num_classes: Optional[int] = None
        self._fn = None
        self._loaded = None  # keep the SavedModel object alive

    def load(self) -> None:
        os.environ.setdefault("CUDA_VISIBLE_DEVICES", "-1")
        os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "2")
        import tensorflow as tf

        self._loaded = tf.saved_model.load(self.model_dir)
        self._fn = self._loaded.signatures["serving_default"]
        sidecar = os.path.join(self.model_dir, SIDECAR_FILE)
        if os.path.exists(sidecar):
            with open(sidecar) as f:
                meta = json.load(f)
            self.input_shape = tuple(meta.get("input_shape") or ())
            self.num_classes = meta.get("num_classes")
        if not self.input_shape:
            # Fall back to the signature (batch dim is polymorphic/None).
            _, kw = self._fn.structured_input_signature
            spec = next(iter(kw.values()))
            self.input_shape = tuple(int(d) for d in spec.shape[1:])
        # Warm the function (first trace/XlaCallModule init).
        self._call(np.zeros((1, *self.input_shape), np.float32))
        self.ready = True

    def _call(self, x: np.ndarray) -> np.ndarray:
        import tensorflow as tf

        out = self._fn(tf.constant(x))
        return next(iter(out.values())).numpy()

    def predict(self, instances: np.ndarray,
                probabilities: bool = False) -> Dict[str, Any]:
        logits = []
        for start in range(0, instances.shape[0], self.max_batch_size):
            chunk = np.asarray(instances[start:start + self.max_batch_size],
                               np.float32)
            logits.append(self._call(chunk))
        lg = np.concatenate(logits, 0)
        out: Dict[str, Any] = {"predictions": lg.argmax(-1).tolist()}
        if probabilities:
            e = np.exp(lg - lg.max(-1, keepdims=True))
            out["probabilities"] = (e / e.sum(-1, keepdims=True)).tolist()
        return out
