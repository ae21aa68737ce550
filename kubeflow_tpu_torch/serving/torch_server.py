"""PyTorch predictor — port of ``kubeflow_tpu/serving/torch_server.py``
(KFServing's pytorch-server: the V1 data plane and micro-batcher are
shared, only the predict backend differs).

Serves a TorchScript export: a directory with ``model.pt`` and an optional
``config.json`` carrying input_shape/num_classes metadata, the reference's
layout, so each package serves the other's exports. The reference runs the
module on the host CPU; the port loads it onto the card (``cuda`` unless
the caller passes ``device="cpu"``) and runs each ``max_batch_size`` chunk
there under ``torch.inference_mode()``, with the argmax and softmax on the
device and one copy back a request.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from .server import Predictor, load_export_meta

MODEL_FILE = "model.pt"


def export_torchscript(directory: str, module, input_shape=None,
                       num_classes: Optional[int] = None,
                       example_inputs=None) -> str:
    """Write a servable TorchScript export. The module is scripted, as the
    reference does; with ``example_inputs`` it is traced on them instead
    (for modules that script cannot compile, such as the zoo's ResNet,
    which looks its blocks up by name)."""
    os.makedirs(directory, exist_ok=True)
    if example_inputs is None:
        compiled = torch.jit.script(module)
    else:
        compiled = torch.jit.trace(module, example_inputs)
    compiled.save(os.path.join(directory, MODEL_FILE))
    meta: Dict[str, Any] = {"framework": "pytorch"}
    if input_shape is not None:
        meta["input_shape"] = list(input_shape)
    if num_classes is not None:
        meta["num_classes"] = int(num_classes)
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(meta, f)
    return directory


def is_torch_export(model_dir: str) -> bool:
    return os.path.exists(os.path.join(model_dir, MODEL_FILE))


class TorchPredictor(Predictor):
    """V1-protocol predictor over a TorchScript module on one device."""

    def __init__(self, model_dir: str, name: str = "",
                 max_batch_size: int = 64, device: str = "cuda"):
        self.model_dir = model_dir
        self.name = name or "model"
        self.max_batch_size = max_batch_size
        self.device = "cuda" if device in ("auto", "default") else device
        self._dev: Optional[torch.device] = None
        self._module = None
        self.input_shape = None
        self.num_classes = None

    def load(self) -> None:
        from ..device import resolve_device

        self._dev = resolve_device(self.device)
        self._module = torch.jit.load(
            os.path.join(self.model_dir, MODEL_FILE), map_location=self._dev)
        self._module.eval()
        self.input_shape, self.num_classes = load_export_meta(
            self.model_dir)
        # Warm one forward so the first request doesn't pay lazy init.
        if self.input_shape:
            self.predict(np.zeros((1,) + self.input_shape, np.float32))
        self.ready = True

    def predict(self, instances: np.ndarray,
                probabilities: bool = False) -> Dict[str, Any]:
        x = torch.from_numpy(np.asarray(instances, np.float32))
        with torch.inference_mode():
            logits = torch.cat([
                self._module(x[i:i + self.max_batch_size].to(self._dev))
                for i in range(0, len(x), self.max_batch_size)])
            preds = logits.argmax(-1)
            if not probabilities:
                return {"predictions": preds.cpu().tolist()}
            probs = torch.softmax(logits, -1)
            # One copy to the host: the class ids ride as the last column
            # (exact in f32 below 2**24 classes).
            host = torch.cat([probs.float(), preds[:, None].float()],
                             -1).cpu()
        return {"predictions": host[:, -1].long().tolist(),
                "probabilities": host[:, :-1].tolist()}
