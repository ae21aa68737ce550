"""Classifier training: the single-device train loop and checkpoint/resume
(ports of ``kubeflow_tpu/training/``)."""

from .checkpoint import Checkpointer  # noqa: F401
from .loop import TrainLoop, TrainMetrics, TrainState  # noqa: F401
