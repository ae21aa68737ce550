"""Deterministic synthetic language-modeling data.

Token streams are sampled from a fixed random first-order Markov chain
(per (vocab, seed)): the transition table is low-entropy (each token has
~8 plausible successors), so cross-entropy has a meaningful floor a
learning model approaches — loss curves are informative for HPO and for
regression-testing optimizer changes, while generation stays pure-compute
and exactly reproducible per (seed, split, step, shard). No downloads.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class LMDataset:
    vocab_size: int = 1024
    seq_len: int = 256
    branching: int = 8  # plausible successors per token
    seed: int = 0
    split: str = "train"

    def _transitions(self) -> Tuple[np.ndarray, np.ndarray]:
        """(successors [V, B], probs [B]) — the chain definition."""
        rng = np.random.default_rng(np.random.SeedSequence(
            [0x4C4D, self.vocab_size, self.branching, self.seed]))
        succ = rng.integers(0, self.vocab_size,
                            size=(self.vocab_size, self.branching))
        probs = rng.dirichlet(np.ones(self.branching) * 2.0)
        probs = np.sort(probs)[::-1]
        return succ, probs

    def entropy_floor(self) -> float:
        """Per-token cross-entropy of the true chain (nats) — the loss a
        perfect model converges to."""
        _, probs = self._transitions()
        return float(-(probs * np.log(probs)).sum())

    def batches(self, batch_size: int, *, shard_index: int = 0,
                num_shards: int = 1, steps: Optional[int] = None,
                epoch_seed: int = 0) -> Iterator[np.ndarray]:
        """Yield token arrays [per_shard, seq_len+1] (inputs||target shift).

        Same disjoint-shard contract as the image datasets: shards of one
        global batch are disjoint and reassemble deterministically.
        """
        if batch_size % num_shards:
            raise ValueError(f"batch_size {batch_size} not divisible by "
                             f"num_shards {num_shards}")
        per = batch_size // num_shards
        succ, probs = self._transitions()
        split_tag = 0 if self.split == "train" else 1
        step = 0
        while steps is None or step < steps:
            rng = np.random.default_rng(np.random.SeedSequence(
                [0x4C4D, self.seed, split_tag, epoch_seed, step, shard_index]))
            toks = np.empty((per, self.seq_len + 1), np.int32)
            toks[:, 0] = rng.integers(0, self.vocab_size, size=per)
            choices = rng.choice(self.branching, p=probs,
                                 size=(per, self.seq_len))
            for t in range(self.seq_len):
                toks[:, t + 1] = succ[toks[:, t], choices[:, t]]
            yield toks
            step += 1

    def eval_batch(self, n: int) -> np.ndarray:
        return next(LMDataset(self.vocab_size, self.seq_len, self.branching,
                              self.seed, "eval").batches(n))


_LM_SPECS = {
    # name: (vocab, seq_len, branching)
    "lm-tiny": (1024, 256, 8),
    "lm-small": (32_000, 2048, 8),
    "lm-long": (32_000, 16_384, 8),
}


def get_lm_dataset(name: str, seed: int = 0, split: str = "train",
                   seq_len: Optional[int] = None) -> LMDataset:
    try:
        vocab, default_seq, branching = _LM_SPECS[name]
    except KeyError:
        raise KeyError(
            f"unknown LM dataset {name!r}; have {sorted(_LM_SPECS)}") from None
    return LMDataset(vocab_size=vocab, seq_len=seq_len or default_seq,
                     branching=branching, seed=seed, split=split)
