"""kubeflow_tpu_torch — the PyTorch/CUDA port of kfx's data plane.

A second package beside ``kubeflow_tpu`` (the JAX reference), with the
same subpackage layout, written for NVIDIA Hopper (H100):

  data/       deterministic synthetic LM and image data (own copies of
              the reference's; image batches also drawn on the device)
  models/     TransformerLM (nn.Module, dense and paged KV-cache decode),
              the one-shot LMGenerator, the classifier zoo (mlp, cnn,
              resnet18/50, vit, vit-s) by name, param conversion from/to
              the reference's flax trees
  obs/        the metrics registry, request spans and the flight recorder
  ops/        hand-written CUDA flash attention (forward, dQ, dK/dV) beside
              plain PyTorch versions of the same blocked algorithm
  parallel/   the single-device LM train loop (AdamW, warmup-cosine)
  training/   the classifier TrainLoop (optax's optimizers) and the
              Checkpointer both runners resume from
  runners/    ``python -m kubeflow_tpu_torch.runners.lm_runner`` and the
              JAXJob worker ``...runners.jax_runner``
  serving/    the LM and classifier exports (the reference's formats),
              the DecodeEngine, and the V1 model server (``:generate``,
              ``:predict`` with the micro-batcher), ``python -m
              kubeflow_tpu_torch.serving.server``
  utils/      FLOP accounting and MFU against the H100's peak; Prometheus
              text rendering

It imports torch, numpy and the standard library only — never jax, flax,
optax, orbax, or any module of ``kubeflow_tpu``. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; a ``cuda`` request
on a machine without a GPU raises instead of falling back.
"""

__version__ = "0.1.0"
