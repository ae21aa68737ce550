"""scikit-learn predictor — port of ``kubeflow_tpu/serving/sklearn_server.py``
(KFServing's sklearn-server: the V1 data plane and micro-batcher are
shared, only the predict backend differs). scikit-learn has no device, so
this predictor runs on the host, as the reference's does; ``joblib`` is
imported inside the functions that use it (a machine without
scikit-learn still imports the module).

Serves a joblib export: a directory with ``model.joblib`` (and an
optional ``config.json`` carrying input_shape/num_classes metadata).
Non-tabular inputs (e.g. images) are flattened to ``(n, features)`` —
the sklearn estimator contract — using the recorded input_shape.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np

from .server import Predictor, load_export_meta

MODEL_FILE = "model.joblib"


def export_sklearn(directory: str, estimator, input_shape=None,
                   num_classes: Optional[int] = None) -> str:
    """Write a servable sklearn export (joblib-pickled estimator)."""
    import joblib

    os.makedirs(directory, exist_ok=True)
    joblib.dump(estimator, os.path.join(directory, MODEL_FILE))
    meta: Dict[str, Any] = {"framework": "sklearn"}
    if input_shape is not None:
        meta["input_shape"] = list(input_shape)
    if num_classes is not None:
        meta["num_classes"] = int(num_classes)
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(meta, f)
    return directory


def is_sklearn_export(model_dir: str) -> bool:
    return os.path.exists(os.path.join(model_dir, MODEL_FILE))


class SKLearnPredictor(Predictor):
    """V1-protocol predictor over a joblib-loaded sklearn estimator."""

    def __init__(self, model_dir: str, name: str = "",
                 max_batch_size: int = 256, device: str = "cpu"):
        self.model_dir = model_dir
        self.name = name or "model"
        self.max_batch_size = max_batch_size
        self.device = "cpu"   # the host, whatever the caller asked
        self._estimator = None
        self.input_shape = None
        self.num_classes = None

    def load(self) -> None:
        import joblib

        self._estimator = joblib.load(
            os.path.join(self.model_dir, MODEL_FILE))
        self.input_shape, self.num_classes = load_export_meta(
            self.model_dir)
        self.ready = True

    def predict(self, instances: np.ndarray,
                probabilities: bool = False) -> Dict[str, Any]:
        x = np.asarray(instances)
        if len(x) == 0:
            # V1-protocol parity with the jax predictor: empty instances
            # is a valid request, not a 500.
            out: Dict[str, Any] = {"predictions": []}
            if probabilities:
                out["probabilities"] = []
            return out
        # sklearn estimators take (n, features): flatten any image-shaped
        # input the same way the jax mlp's Flatten layer would.
        if x.ndim > 2:
            x = x.reshape(len(x), -1)
        outs = []
        probs = []
        for i in range(0, len(x), self.max_batch_size):
            chunk = x[i:i + self.max_batch_size]
            outs.append(np.asarray(self._estimator.predict(chunk)))
            if probabilities:
                if not hasattr(self._estimator, "predict_proba"):
                    raise ValueError(
                        f"estimator {type(self._estimator).__name__} has "
                        f"no predict_proba")
                probs.append(np.asarray(
                    self._estimator.predict_proba(chunk)))
        result: Dict[str, Any] = {
            "predictions": np.concatenate(outs).tolist()}
        if probabilities:
            result["probabilities"] = np.concatenate(probs).tolist()
        return result
