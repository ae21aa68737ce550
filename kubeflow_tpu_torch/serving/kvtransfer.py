"""Page-granular KV transfer plane — the port's copy of
``kubeflow_tpu/serving/kvtransfer.py``: the wire codec, the host-RAM
offload tier, and the HTTP client that move paged KV cache state between
replicas (and between device memory and host RAM).

The paged pool (serving/engine.py) makes a KV hand-off a list of page
copies; this module gives those copies a verified wire format and three
consumers (DistServe OSDI'24 / Mooncake-shaped):

  * **prefill/decode disaggregation**: a ``role: prefill`` replica ships
    each finished prompt's pages to a decode peer and answers the client
    with a retriable "migrated" 503 and an ``X-Kfx-Migrated`` peer hint;
    the re-dispatched body lands on the peer, which resumes from the
    adopted pages instead of recomputing.
  * **live decode migration**: drain, scale-in and rebalancing export an
    in-flight request's pages mid-decode (or mid-prefill-cursor) and the
    receiver resumes where the donor stopped: sampling knobs, the
    pending-logits row and the cursor position ride the stream.
  * **host-RAM offload**: cold prefix-cache pages demote into a
    ``HostOffloadTier`` at LRU eviction instead of vanishing, and promote
    back through one page scatter on the next chain-hash match.

The wire is the reference's byte for byte, so a payload exported by
either package imports into the other's engine.

Wire format (version 1)::

    magic    b"KFX-KV1\\n"
    u32      header length (big-endian)
    bytes    header JSON (utf-8): request state (prompt, generated
             tokens, sampling knobs, RNG stash, QoS/tenant/adapter,
             deadline headroom), the block-table layout, per-leaf
             geometry descriptors (shape/dtype of every cache-tree
             leaf — int8 entries, scale planes and cached position
             ids all included), the decode slot state or the
             prefill-cursor state, and per-frame byte sizes
    frames   one frame per page (+ one optional AUX frame carrying
             the slot's pending logits row), each ``size`` payload
             bytes followed by a 32-byte chain digest:
             digest_i = SHA256(digest_{i-1} || payload_i), seeded
             with SHA256(magic || header) — prefix.payload_chain,
             the page-chain discipline applied to wire frames

Verification is per PAGE, not per stream: a severed or corrupted
transfer fails at the first bad frame and the receiver discards the
partial import whole (no page it scattered survives), leaving the
donor's copy authoritative — the ``kv.transfer`` chaos point forces
exactly that path. The engine hands the codec opaque frame bytes; the
module needs no tensor library.
"""

from __future__ import annotations

import hashlib
import json
import struct
import threading
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple
from urllib import error as urlerror
from urllib import parse as urlparse
from urllib import request as urlrequest

from .prefix import payload_chain

__all__ = [
    "MAGIC", "TransferError", "TransferCorrupt", "encode", "decode",
    "peek", "resume_key", "HostOffloadTier", "post_pages",
]

MAGIC = b"KFX-KV1\n"
_DIGEST_BYTES = 32
_LEN = struct.Struct(">I")


class TransferError(RuntimeError):
    """A KV transfer failed for a non-content reason: peer unreachable
    or refusing (no slot, no pages, draining), or a geometry mismatch
    (the receiver's cache tree is not leaf-for-leaf identical). The
    donor keeps its copy — the request keeps running where it is."""


class TransferCorrupt(TransferError):
    """The page stream's chain digest broke mid-transfer (severed
    connection, bit flip, or the ``kv.transfer`` chaos point). The
    receiver discards the partial import whole."""


def _seed_digest(header_bytes: bytes) -> bytes:
    return payload_chain(MAGIC, header_bytes)


def encode(header: Dict, frames: Sequence[bytes]) -> bytes:
    """Serialize one transfer: ``header`` (JSON-safe dict; this call
    stamps the per-frame sizes into ``header["frames"]``) plus the raw
    page/aux frames, each chained behind the previous one's digest."""
    header = dict(header)
    header["frames"] = [len(f) for f in frames]
    hb = json.dumps(header, separators=(",", ":"),
                    sort_keys=True).encode()
    out = [MAGIC, _LEN.pack(len(hb)), hb]
    digest = _seed_digest(hb)
    for f in frames:
        digest = payload_chain(digest, f)
        out.append(f)
        out.append(digest)
    return b"".join(out)


def peek(raw: bytes) -> Dict:
    """Parse and return ONLY the header (no frame verification) — for
    routing decisions (resume key, model name, page count) that must
    not pay for a full chain walk twice."""
    if raw[:len(MAGIC)] != MAGIC:
        raise TransferError("bad magic: not a kfx KV transfer")
    off = len(MAGIC)
    if len(raw) < off + _LEN.size:
        raise TransferCorrupt("truncated header length")
    (hlen,) = _LEN.unpack_from(raw, off)
    off += _LEN.size
    if len(raw) < off + hlen:
        raise TransferCorrupt("truncated header")
    try:
        return json.loads(raw[off:off + hlen].decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise TransferCorrupt(f"unparseable header: {e}") from e


def decode(raw: bytes) -> Tuple[Dict, List[bytes]]:
    """Parse and VERIFY one transfer: returns (header, frames) or
    raises TransferCorrupt at the first frame whose chain digest does
    not fold from its predecessor's — the receiver must import nothing
    from a stream that fails here."""
    header = peek(raw)
    # The digest chain is seeded with the header bytes AS SENT (sliced
    # by the declared length), never a re-serialization — key order
    # must not matter for verification.
    (hlen,) = _LEN.unpack_from(raw, len(MAGIC))
    off = len(MAGIC) + _LEN.size + hlen
    digest = _seed_digest(raw[len(MAGIC) + _LEN.size:off])
    sizes = header.get("frames")
    if not isinstance(sizes, list):
        raise TransferCorrupt("header missing frame sizes")
    frames: List[bytes] = []
    for i, size in enumerate(sizes):
        size = int(size)
        end = off + size + _DIGEST_BYTES
        if end > len(raw):
            raise TransferCorrupt(
                f"severed page stream: frame {i} truncated "
                f"({len(raw) - off} of {size + _DIGEST_BYTES} bytes)")
        payload = raw[off:off + size]
        digest = payload_chain(digest, payload)
        if digest != raw[off + size:end]:
            raise TransferCorrupt(
                f"chain digest mismatch at frame {i}: the page "
                "stream was corrupted in transit")
        frames.append(payload)
        off = end
    if off != len(raw):
        raise TransferCorrupt(
            f"{len(raw) - off} trailing bytes past the last frame")
    return header, frames


def resume_key(prompt: Sequence[int], max_new: int, temperature: float,
               top_k: int, seed: int, stop: int, adapter: str) -> str:
    """Content-derived identity of a generation: the hex SHA-256 of
    the prompt ids plus every knob that shapes the output stream.
    BOTH ends derive it independently — the donor stamps it into the
    transfer header, and the receiver keys its adopted requests by it,
    so when the router re-dispatches the original ``:generate`` body
    (its seeded recovery) the receiver recognizes the request
    from the body alone and attaches it to the migrated in-flight
    generation instead of recomputing. No donor->router->receiver
    side channel exists to drift: a transfer that never arrived
    simply has no adoption entry, and the same re-dispatched body
    degrades to the plain seeded recompute."""
    h = hashlib.sha256()
    h.update(json.dumps(
        [[int(t) for t in prompt], int(max_new), float(temperature),
         int(top_k), int(seed), int(stop), str(adapter or "")],
        separators=(",", ":")).encode())
    return h.hexdigest()


class HostOffloadTier:
    """Host-RAM page store behind the same chain-hash page interface
    as the device prefix cache: demoted pages keyed by the SAME chain
    key ``PrefixCache`` evicted them under, LRU-bounded at
    ``capacity_pages``. ``get`` refreshes recency; ``put`` of a key
    already present refreshes in place (same content by construction
    — the key IS the content hash chain). A lock makes the tier safe
    for the engine loop + gauge scrapes; the payloads themselves are
    immutable bytes."""

    def __init__(self, capacity_pages: int):
        if capacity_pages < 1:
            raise ValueError("capacity_pages must be >= 1")
        self.capacity = int(capacity_pages)
        self._pages: "OrderedDict[bytes, bytes]" = OrderedDict()
        self._lock = threading.Lock()
        self.demoted = 0   # pages ever put (spill traffic)
        self.promoted = 0  # pages ever pulled back to HBM

    def __len__(self) -> int:
        with self._lock:
            return len(self._pages)

    def put(self, key: bytes, payload: bytes) -> None:
        with self._lock:
            if key in self._pages:
                self._pages.move_to_end(key)
                return
            self._pages[key] = payload
            self.demoted += 1
            while len(self._pages) > self.capacity:
                self._pages.popitem(last=False)

    def get(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            payload = self._pages.get(key)
            if payload is not None:
                self._pages.move_to_end(key)
            return payload

    def pop(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            payload = self._pages.pop(key, None)
            if payload is not None:
                self.promoted += 1
            return payload

    def clear(self) -> None:
        with self._lock:
            self._pages.clear()


def post_pages(base_url: str, model: str, payload: bytes,
               timeout: float = 10.0) -> str:
    """Ship one encoded transfer to a peer replica's
    ``:kvimport`` route. Returns the peer's netloc (the
    ``X-Kfx-Migrated`` re-dispatch hint) on HTTP 200; any other
    outcome raises TransferError — the donor's copy stays
    authoritative and the request keeps running where it is."""
    base = base_url if "://" in base_url else f"http://{base_url}"
    url = f"{base.rstrip('/')}/v1/models/{urlparse.quote(model)}:kvimport"
    req = urlrequest.Request(
        url, data=payload, method="POST",
        headers={"Content-Type": "application/octet-stream"})
    try:
        with urlrequest.urlopen(req, timeout=timeout) as resp:
            if resp.status != 200:
                raise TransferError(
                    f"peer {base_url} refused the import: "
                    f"HTTP {resp.status}")
    except urlerror.HTTPError as e:
        raise TransferError(
            f"peer {base_url} refused the import: HTTP {e.code} "
            f"{e.read(200)!r}") from e
    except (urlerror.URLError, OSError, TimeoutError) as e:
        raise TransferError(
            f"transfer to {base_url} severed: {e}") from e
    return urlparse.urlsplit(base).netloc


def round_robin_sender(peers: Sequence[str], model: str,
                       timeout: float = 10.0
                       ) -> Callable[[bytes], str]:
    """A ``kv_peer_send`` callable over a static peer list: each send
    starts at the next peer (round-robin) and falls through the rest,
    raising the LAST TransferError only when every peer refused."""
    peers = [p for p in peers if p]
    if not peers:
        raise ValueError("round_robin_sender needs at least one peer")
    state = {"i": 0}
    lock = threading.Lock()

    def send(payload: bytes) -> str:
        with lock:
            start = state["i"]
            state["i"] = (start + 1) % len(peers)
        last: Optional[TransferError] = None
        for off in range(len(peers)):
            peer = peers[(start + off) % len(peers)]
            try:
                return post_pages(peer, model, payload, timeout=timeout)
            except TransferError as e:
                last = e
        assert last is not None
        raise last

    return send
