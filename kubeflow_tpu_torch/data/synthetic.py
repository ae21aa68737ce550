"""Deterministic synthetic image classification datasets — the port's
copy of ``kubeflow_tpu/data/synthetic.py``: ``batches`` and
``eval_arrays`` are the reference's byte for byte; ``device_batch_fn``
draws with torch on the card.

Each class c gets a fixed random prototype P_c; a sample is
``clip(P_c + sigma * noise)``. A model that learns the prototypes reaches
high accuracy, so loss/accuracy curves are informative (needed by the HPO
objective plumbing), while generation is pure-compute and reproducible
from (name, split, seed) — no downloads, no files.

Shapes mirror the real datasets the reference examples use
(tf-operator mnist example: 28x28x1/10-way; resnet-cifar10: 32x32x3/10-way).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import zlib

import numpy as np

_SPECS = {
    # name: (train_n, eval_n, shape, classes, sigma, label_noise)
    # label_noise bounds achievable accuracy below 1.0 so objective curves
    # stay informative for HPO comparisons.
    "mnist": (60_000, 10_000, (28, 28, 1), 10, 0.9, 0.10),
    "cifar10": (50_000, 10_000, (32, 32, 3), 10, 1.1, 0.18),
    "imagenet-tiny": (100_000, 10_000, (64, 64, 3), 200, 1.2, 0.25),
    # Full ImageNet geometry (224^2, 1000-way) for input-shape probes:
    # separates a conv stack's MFU ceiling from the small-stem shapes
    # the CIFAR examples use (bench resnet50 ladder).
    "imagenet-sim": (100_000, 10_000, (224, 224, 3), 1000, 1.2, 0.25),
}


@dataclasses.dataclass
class Dataset:
    name: str
    split: str
    n: int
    shape: Tuple[int, ...]
    num_classes: int
    sigma: float
    label_noise: float = 0.0
    seed: int = 0

    def _prototypes(self) -> np.ndarray:
        # Class prototypes depend on (name, seed) only — shared across splits
        # so train and eval are drawn from the same distribution.
        rng = np.random.default_rng(
            np.random.SeedSequence([zlib.crc32(self.name.encode()), self.seed]))
        return rng.uniform(0.0, 1.0,
                           size=(self.num_classes,) + self.shape).astype(np.float32)

    def batches(self, batch_size: int, *, shard_index: int = 0,
                num_shards: int = 1, steps: int | None = None,
                epoch_seed: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield (images, labels) host shards.

        With ``num_shards > 1`` each shard gets ``batch_size // num_shards``
        disjoint samples per step — the per-process slice of a global batch
        (the data-parallel input pipeline contract).
        """
        if batch_size % num_shards:
            raise ValueError(f"batch_size {batch_size} not divisible by "
                             f"num_shards {num_shards}")
        per_shard = batch_size // num_shards
        protos = self._prototypes()
        split_tag = 0 if self.split == "train" else 1
        step = 0
        while steps is None or step < steps:
            # Seed is a pure function of (dataset identity, split, epoch, step,
            # shard) => every process regenerates exactly its slice.
            rng = np.random.default_rng(np.random.SeedSequence(
                [zlib.crc32(self.name.encode()), self.seed, split_tag,
                 epoch_seed, step, shard_index]))
            labels = rng.integers(0, self.num_classes, size=per_shard)
            noise = rng.normal(0.0, self.sigma,
                               size=(per_shard,) + self.shape).astype(np.float32)
            images = np.clip(protos[labels] + noise, 0.0, 1.0)
            labels = self._flip_labels(labels, rng)
            yield images, labels.astype(np.int32)
            step += 1

    def device_batch_fn(self):
        """A per-step batch generator on the device: the dataset is a
        *distribution* (prototype + noise), so batches are drawn where the
        model trains, with no host-to-device copy of images a step.

        Returns fn(protos, generator, batch_size) -> (images, labels),
        with the prototype table as numpy in ``fn.consts``: the train loop
        places it on its device once and passes it in (at ImageNet
        geometry it is 1000 x 224^2 x 3 f32 = 602 MB). ``generator`` is a
        ``torch.Generator`` on that device; the train loop seeds one from
        (seed + 1, absolute step), so a resumed run continues the stream.
        Same distribution as ``batches`` (sigma, label noise), a different
        random stream: equivalent training, not bit-equal batches (the
        reference's device stream differs from its host stream too).
        """
        import torch

        C, sigma, p_flip = self.num_classes, self.sigma, self.label_noise
        shape = self.shape

        def make(protos, generator, batch_size: int):
            dev = protos.device
            labels = torch.randint(0, C, (batch_size,), generator=generator,
                                   device=dev)
            noise = torch.randn((batch_size,) + shape, generator=generator,
                                device=dev)
            images = torch.clamp(protos[labels] + sigma * noise, 0.0, 1.0)
            if p_flip > 0:
                flip = torch.rand(batch_size, generator=generator,
                                  device=dev) < p_flip
                other = torch.randint(0, C, (batch_size,),
                                      generator=generator, device=dev)
                labels = torch.where(flip, other, labels)
            return images, labels

        make.consts = self._prototypes()
        return make

    def eval_arrays(self, n: int | None = None) -> Tuple[np.ndarray, np.ndarray]:
        """A fixed eval set (single host-sized arrays)."""
        n = min(n or self.n, self.n)
        protos = self._prototypes()
        rng = np.random.default_rng(np.random.SeedSequence(
            [zlib.crc32(self.name.encode()), self.seed, 1, 999]))
        labels = rng.integers(0, self.num_classes, size=n)
        noise = rng.normal(0.0, self.sigma, size=(n,) + self.shape).astype(np.float32)
        images = np.clip(protos[labels] + noise, 0.0, 1.0)
        labels = self._flip_labels(labels, rng)
        return images, labels.astype(np.int32)

    def _flip_labels(self, labels: np.ndarray, rng) -> np.ndarray:
        if self.label_noise <= 0:
            return labels
        flip = rng.random(labels.shape) < self.label_noise
        return np.where(flip, rng.integers(0, self.num_classes,
                                           size=labels.shape), labels)


def get_dataset(name: str, split: str = "train", seed: int = 0) -> Dataset:
    try:
        train_n, eval_n, shape, classes, sigma, label_noise = _SPECS[name]
    except KeyError:
        raise KeyError(f"unknown dataset {name!r}; have {sorted(_SPECS)}") from None
    return Dataset(name=name, split=split,
                   n=train_n if split == "train" else eval_n,
                   shape=shape, num_classes=classes, sigma=sigma,
                   label_noise=label_noise, seed=seed)
