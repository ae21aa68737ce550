"""kubeflow_tpu_torch — the PyTorch/CUDA port of kfx's data plane.

A second package beside ``kubeflow_tpu`` (the JAX reference), with the
same subpackage layout, written for NVIDIA Hopper (H100):

  data/       deterministic synthetic LM data (own copy of the reference's)
  models/     TransformerLM (nn.Module, dense KV-cache decode), the
              one-shot LMGenerator, param conversion from/to the
              reference's flax tree
  obs/        the metrics registry and request spans the server reports
  ops/        hand-written CUDA flash attention (forward, dQ, dK/dV) beside
              plain PyTorch versions of the same blocked algorithm
  parallel/   the single-device LM train loop (AdamW, warmup-cosine)
  runners/    ``python -m kubeflow_tpu_torch.runners.lm_runner``
  serving/    the LM export (reads and writes the reference's format) and
              the V1 model server, ``python -m
              kubeflow_tpu_torch.serving.server``
  utils/      FLOP accounting and MFU against the H100's peak; Prometheus
              text rendering

It imports torch, numpy and the standard library only — never jax, flax,
optax, orbax, or any module of ``kubeflow_tpu``. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; a ``cuda`` request
on a machine without a GPU raises instead of falling back.
"""

__version__ = "0.1.0"
