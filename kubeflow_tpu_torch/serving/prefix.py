"""Prefix keying for the engine's prefix cache — the port's copy of
``chain_hash`` from ``kubeflow_tpu/serving/prefix.py``.

The engine's ``PrefixCache`` (serving/engine.py) keys cached prompt pages
by a CHAIN hash: page i's key folds page i-1's key, so a key match is a
match of the whole prefix, not of one page in isolation. The keys are
the reference's byte for byte, so both packages agree on which prompts
share pages.
"""

from __future__ import annotations

import hashlib
from typing import Sequence

import numpy as np


def chain_hash(parent: bytes, tokens: Sequence[int]) -> bytes:
    """One page link of the chain: SHA-256 over the parent key + this
    page's token ids (int64 bytes, the PrefixCache convention)."""
    h = hashlib.sha256(parent)
    h.update(np.asarray(list(tokens), np.int64).tobytes())
    return h.digest()
