"""Traffic of kind ``packed_lm``: pretraining batches for the ``train``
driver. Documents with log-normal lengths (``doc_tokens``, drawn from a
table of ``table`` quantiles) are packed end to end, separated by
``eos``, into ``batch`` rows of ``seq_len + 1`` tokens (inputs and
shifted targets), with ids from a Zipf law (``zipf_a``) over the
vocabulary. ``pool_batches`` distinct batches are made up front and the
steps cycle through them."""

from __future__ import annotations

from typing import List

import numpy as np

from kfxbench.core.traffic import lognormal_table, seed64


def batches(mix: dict, vocab: int, eos: int, seed: int) -> List[np.ndarray]:
    """``pool_batches`` int64 batches [batch, seq_len + 1] of packed
    documents, every row distinct."""
    B, S = mix["batch"], mix["seq_len"]
    n_batches = mix["pool_batches"]
    rng = np.random.default_rng([seed64(seed), 1])
    need = n_batches * B * (S + 1)
    table = lognormal_table(mix["doc_tokens"], mix["table"])
    docs = table[rng.permutation(len(table))]
    lengths: List[int] = []
    total, i = 0, 0
    while total < need:
        lengths.append(int(docs[i % len(docs)]))
        total += lengths[-1] + 1
        i += 1
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** -mix["zipf_a"]
    # Rank r is id perm[r]: the seed decides which ids are frequent.
    ids = rng.permutation(vocab)
    stream = ids[rng.choice(vocab, size=total, p=p / p.sum())]
    ends = np.cumsum(np.asarray(lengths) + 1) - 1
    stream[ends] = eos
    rows = stream[:need].reshape(n_batches, B, S + 1)
    return [np.ascontiguousarray(b) for b in rows]
