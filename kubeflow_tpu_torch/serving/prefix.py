"""Prefix keying for the engine's prefix cache and the KV transfer wire —
the port's copy of ``chain_hash`` and ``payload_chain`` from
``kubeflow_tpu/serving/prefix.py``.

The engine's ``PrefixCache`` (serving/engine.py) keys cached prompt pages
by a CHAIN hash: page i's key folds page i-1's key, so a key match is a
match of the whole prefix, not of one page in isolation. The keys are
the reference's byte for byte, so both packages agree on which prompts
share pages. ``payload_chain`` folds the same way over wire frames
(serving/kvtransfer.py), so both packages verify each other's page
streams.
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


def payload_chain(parent: bytes, payload: bytes) -> bytes:
    """One frame link of the TRANSFER chain (serving/kvtransfer.py):
    SHA-256 over the parent digest + the frame's raw bytes, the
    ``chain_hash`` fold applied to wire frames. A page stream severed or
    corrupted in transit breaks the chain at the first bad frame, so the
    receiver discards the partial import whole."""
    h = hashlib.sha256(parent)
    h.update(payload)
    return h.digest()
