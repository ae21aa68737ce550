"""The port's KV transfer plane (kubeflow_tpu_torch/serving/kvtransfer.py,
the DecodeEngine's export/import/hand-off/offload, the server's
``:kvimport``, ``:migrate`` and ``:kvpeers``) against the reference's
(kubeflow_tpu/serving/kvtransfer.py, engine.py, server.py) on the CPU, on
the reference's tiny fixture (vocab 64, d 32, L 2) with wide-gap weights
(the argmax gap asserted where greedy tokens cross frameworks):

  * the codec: the port's ``encode`` bytes equal the reference's, each
    package decodes the other's, per-frame verification, resume keys and
    the offload tier, as tests/test_kvtransfer.py holds them;
  * the wire geometry: the port's leaf descriptors equal the JAX engine's
    for f32, bf16 and int8 KV;
  * live migration between two port engines: greedy and seeded streams
    equal the unmigrated run, a severed transfer loses nothing, a
    corrupt import leaks no page, a mid-prefill cursor resumes;
  * across frameworks: a JAX engine's mid-decode payload continues on a
    port engine to the JAX engine's greedy tokens, and the reverse, in
    f32, bf16 and int8 KV; the refusals (geometry, a pending speculative
    token, a degraded adapter, no free slot) keep the donor's copy;
  * the prefill role hands off to a decode peer and degrades to local
    decode without one; the host tier demotes and promotes byte for
    byte;
  * the fleet: the reference's JAX-free Router in front of two port
    servers, a migration under an open SSE stream, the client's stream
    equal to an uninterrupted run."""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from kubeflow_tpu import chaos as ref_chaos  # noqa: E402
from kubeflow_tpu.models import transformer as ref  # noqa: E402
from kubeflow_tpu.serving import engine as ref_engine  # noqa: E402
from kubeflow_tpu.serving import kvtransfer as ref_kv  # noqa: E402
from kubeflow_tpu.serving import lm_server as ref_lm  # noqa: E402
from kubeflow_tpu.serving import prefix as ref_prefix  # noqa: E402
from kubeflow_tpu_torch import chaos  # noqa: E402
from kubeflow_tpu_torch.models import transformer as port  # noqa: E402
from kubeflow_tpu_torch.models.generate import LMGenerator  # noqa: E402
from kubeflow_tpu_torch.serving import kvtransfer  # noqa: E402
from kubeflow_tpu_torch.serving import lm_server  # noqa: E402
from kubeflow_tpu_torch.serving import prefix  # noqa: E402
from kubeflow_tpu_torch.serving import server as port_server  # noqa: E402
from kubeflow_tpu_torch.serving.engine import (  # noqa: E402
    DecodeEngine, EngineOverloaded, RequestMigrated)

from test_torch_generate import MIN_GAP, TINY, recompute, wide_gap  # noqa: E402,E501

PROMPT = [5, 9, 11, 3, 7]


def _ref_params(dtype):
    cfg_r = ref.TransformerConfig(**TINY, dtype=getattr(jnp, dtype))
    params = ref.TransformerLM(cfg_r).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return cfg_r, wide_gap(jax.tree_util.tree_map(np.asarray, params))


@pytest.fixture(scope="module")
def tiny():
    """(reference config, port config, wide-gap reference param tree),
    f32."""
    cfg_r, params = _ref_params("float32")
    return cfg_r, port.TransformerConfig(**TINY, dtype="float32"), params


def _engine(tiny, name, **kw):
    _, cfg_p, params = tiny
    kw.setdefault("n_slots", 2)
    kw.setdefault("chunk_tokens", 4)
    kw.setdefault("kv_page_size", 16)
    return DecodeEngine(cfg_p, params, name=name, device="cpu", **kw)


# -- wire codec -----------------------------------------------------------------

class TestWireCodec:
    HEADER = {"format": 1, "model": "m", "resume": "abc", "blocks": [0, 2]}
    FRAMES = [b"A" * 100, b"B" * 7, b""]

    def test_encode_is_the_references_and_each_decodes_the_other(self):
        raw = kvtransfer.encode(self.HEADER, self.FRAMES)
        assert raw == ref_kv.encode(self.HEADER, self.FRAMES)
        assert kvtransfer.MAGIC == ref_kv.MAGIC
        hdr = kvtransfer.peek(raw)
        assert hdr["frames"] == [100, 7, 0]
        assert hdr["model"] == "m" and hdr["blocks"] == [0, 2]
        for dec in (kvtransfer.decode, ref_kv.decode):
            hdr2, frames = dec(raw)
            assert hdr2 == hdr and frames == self.FRAMES
        for parent, payload in ((b"", b""), (b"x" * 32, b"\0" * 1000)):
            assert prefix.payload_chain(parent, payload) == \
                ref_prefix.payload_chain(parent, payload)

    def test_verification_is_per_page(self):
        raw = kvtransfer.encode(self.HEADER, self.FRAMES)
        flipped = bytearray(raw)
        flipped[raw.index(b"A" * 100) + 5] ^= 0x40
        with pytest.raises(kvtransfer.TransferCorrupt, match="chain digest"):
            kvtransfer.decode(bytes(flipped))
        with pytest.raises(kvtransfer.TransferCorrupt,
                           match="severed|truncated"):
            kvtransfer.decode(raw[:-3])
        with pytest.raises(kvtransfer.TransferCorrupt, match="trailing"):
            kvtransfer.decode(raw + b"zz")
        with pytest.raises(kvtransfer.TransferError, match="magic"):
            kvtransfer.decode(b"HTTP/1.1 200 OK\r\n\r\n")

    def test_resume_key_covers_every_knob(self):
        base = ([1, 2, 3], 8, 0.5, 4, 7, -1, "")
        key = kvtransfer.resume_key(*base)
        assert key == ref_kv.resume_key(*base)
        for i, changed in enumerate([
                ([1, 2, 9], 8, 0.5, 4, 7, -1, ""),
                ([1, 2, 3], 9, 0.5, 4, 7, -1, ""),
                ([1, 2, 3], 8, 0.6, 4, 7, -1, ""),
                ([1, 2, 3], 8, 0.5, 5, 7, -1, ""),
                ([1, 2, 3], 8, 0.5, 4, 8, -1, ""),
                ([1, 2, 3], 8, 0.5, 4, 7, 0, ""),
                ([1, 2, 3], 8, 0.5, 4, 7, -1, "tuned")]):
            assert kvtransfer.resume_key(*changed) != key, i
            assert kvtransfer.resume_key(*changed) == \
                ref_kv.resume_key(*changed), i

    def test_offload_tier_lru_bound_and_counters(self):
        for mod in (kvtransfer, ref_kv):
            tier = mod.HostOffloadTier(2)
            tier.put(b"k1", b"p1")
            tier.put(b"k2", b"p2")
            tier.put(b"k1", b"p1")  # refresh, not duplicate
            assert len(tier) == 2 and tier.demoted == 2
            tier.put(b"k3", b"p3")  # k2 (LRU) falls out
            assert tier.get(b"k2") is None
            assert tier.get(b"k1") == b"p1"
            assert tier.pop(b"k3") == b"p3" and tier.promoted == 1
            assert tier.pop(b"k3") is None and tier.promoted == 1
            tier.clear()
            assert len(tier) == 0
            with pytest.raises(ValueError):
                mod.HostOffloadTier(0)


# -- geometry -------------------------------------------------------------------

@pytest.mark.parametrize("dtype,kv", [("float32", ""), ("bfloat16", ""),
                                      ("float32", "int8")])
def test_leaf_descriptors_are_the_references(dtype, kv):
    """The wire descriptors (path, per-page shape, dtype name, flatten
    order) of the port's stacked pool equal the JAX engine's cache tree's,
    and one page frame is as many bytes."""
    cfg_r, params = _ref_params(dtype)
    je = ref_engine.DecodeEngine(cfg_r, params, n_slots=1, chunk_tokens=4,
                                 kv_page_size=16, kv_quant=kv,
                                 name=f"geo-r-{dtype}{kv}")
    pe = DecodeEngine(port.TransformerConfig(**TINY, dtype=dtype), params,
                      n_slots=1, chunk_tokens=4, kv_page_size=16,
                      kv_quant=kv, device="cpu", name=f"geo-p-{dtype}{kv}")
    try:
        assert pe._leaf_descriptors() == je._leaf_descriptors()
        assert pe.page_bytes == len(je._page_payload(0))
    finally:
        je.close()
        pe.close()


# -- live migration between port engines ----------------------------------------

@pytest.fixture(scope="module")
def pair(tiny):
    donor = _engine(tiny, "kv-donor")
    recv = _engine(tiny, "kv-recv")
    yield donor, recv
    donor.close()
    recv.close()


def _submit_throttled(eng, prompt=PROMPT, **kw):
    """A 50 ms per-token brake (on_token runs on the loop thread), so a
    migration catches the request mid-decode: ~1 s of decode is left when
    it holds 2 tokens, on a loaded machine too."""
    return eng.submit(prompt, max_new_tokens=24,
                      on_token=lambda t: time.sleep(0.05), **kw)


def _wait_tokens(req, n, timeout=30.0):
    deadline = time.monotonic() + timeout
    while len(req.tokens) < n:
        assert time.monotonic() < deadline, \
            f"only {len(req.tokens)} tokens after {timeout}s"
        time.sleep(0.002)


def _capture(store):
    """A ``send`` that keeps the payload and refuses it: the donor keeps
    its copy, and the test holds the bytes."""
    def send(payload):
        store.append(payload)
        raise kvtransfer.TransferError("captured, not sent")
    return send


def _free_plus_cached(eng):
    st = eng.page_stats()
    return st["free"] + st["cached"]


class TestLiveMigration:
    def _migrate(self, donor, recv, **kw):
        adopted = []
        req = _submit_throttled(donor, **kw)
        _wait_tokens(req, 2)
        stats = donor.migrate_out(
            reason="drain",
            send=lambda p: (adopted.append(recv.kv_import(p)),
                            "recv-local")[1])
        assert stats["moved"] == 1 and stats["pages"] >= 1, stats
        with pytest.raises(RequestMigrated) as ei:
            req.result(timeout=30)
        assert ei.value.peer == "recv-local"
        assert len(req.tokens) >= 2  # the donor really was mid-decode
        return adopted[0].result(timeout=60)

    def test_mid_decode_greedy_equals_unmigrated(self, pair, tiny):
        donor, recv = pair
        want = donor.generate([PROMPT], max_new_tokens=24)[0]
        _, cfg_p, params = tiny
        assert recompute(cfg_p, params, PROMPT, 24)[1] > MIN_GAP
        assert want == LMGenerator(cfg_p, params, device="cpu").generate(
            [PROMPT], max_new_tokens=24)[0]
        assert self._migrate(donor, recv) == want
        # Pages balance on both ends once nothing is in flight.
        for e in pair:
            assert _free_plus_cached(e) == e.n_pages

    def test_mid_decode_seeded_equals_unmigrated(self, pair):
        """The port's streams are a function of (seed, token index): a
        migrated seeded stream is the unmigrated one with no RNG stash."""
        donor, recv = pair
        kw = dict(temperature=0.8, top_k=8, seed=7)
        want = donor.generate([PROMPT], max_new_tokens=24, **kw)[0]
        out = self._migrate(donor, recv, **kw)
        assert out == want and len(out) == 24

    def test_migration_families_and_ledger(self, pair):
        """The donor counts the migration and the pages, the receiver the
        adopted pages. The ledger follows the reference: the receiver
        bills only what it generates past the exported tokens, and the
        donor what it decoded until the peer's acknowledgement."""
        donor, recv = pair

        def value(eng, family, **labels):
            return sum(v for lab, v in eng._reg().counter(family).samples()
                       if lab == dict(model=eng.name, **labels))

        d0 = value(donor, "kfx_lm_kv_migrations_total", reason="drain")
        p0 = value(recv, "kfx_lm_kv_pages_transferred_total")
        adopted = []
        req = _submit_throttled(donor, tenant="mig")
        _wait_tokens(req, 2)
        donor.migrate_out(reason="drain", send=lambda p: (
            adopted.append(recv.kv_import(p)), "recv-local")[1])
        with pytest.raises(RequestMigrated):
            req.result(timeout=30)
        assert len(adopted[0].result(timeout=60)) == 24
        assert value(donor, "kfx_lm_kv_migrations_total",
                     reason="drain") == d0 + 1
        assert value(recv, "kfx_lm_kv_pages_transferred_total") > p0
        billed = {e.name: sum(r["generatedTokens"]
                              for r in e.usage.snapshot()
                              if r["tenant"] == "mig") for e in pair}
        assert billed == {donor.name: len(req.tokens),
                          recv.name: 24 - adopted[0].meter_skip}

    def test_severed_transfer_loses_nothing(self, pair):
        donor, _ = pair
        want = donor.generate([PROMPT], max_new_tokens=24)[0]
        req = _submit_throttled(donor)
        _wait_tokens(req, 2)
        chaos.install(chaos.parse_spec("kv.transfer:count=1"))
        try:
            stats = donor.migrate_out(
                reason="drain",
                send=lambda p: pytest.fail("chaos must sever the send"))
        finally:
            chaos.reset()
        assert stats == {"moved": 0, "failed": 1, "pages": 0}
        assert req.result(timeout=60) == want  # zero lost

    def test_corrupt_import_discards_whole_and_leaks_no_pages(self, pair):
        donor, recv = pair
        want = donor.generate([PROMPT], max_new_tokens=24)[0]
        grabbed = []
        req = _submit_throttled(donor)
        _wait_tokens(req, 2)
        stats = donor.migrate_out(reason="drain", send=_capture(grabbed))
        assert stats["failed"] == 1 and grabbed
        assert req.result(timeout=60) == want  # the donor kept its copy
        free_before = recv._mgr.n_free
        corrupt = bytearray(grabbed[0])
        corrupt[-40] ^= 0x01  # inside the last frame's payload
        with pytest.raises(kvtransfer.TransferCorrupt):
            recv.kv_import(bytes(corrupt))
        assert recv._mgr.n_free == free_before
        # A frame of the wrong size past a valid chain (a geometry lie)
        # is refused before any page is taken.
        hdr, frames = kvtransfer.decode(grabbed[0])
        hdr.pop("frames")
        lie = kvtransfer.encode(hdr, [frames[0][:-8]] + frames[1:])
        with pytest.raises(kvtransfer.TransferError, match="size"):
            recv.kv_import(lie)
        assert recv._mgr.n_free == free_before
        assert all(r is None for r in recv._slots)
        # The pristine payload still imports and resumes.
        assert recv.kv_import(grabbed[0]).result(timeout=60) == want

    def test_no_free_slot_keeps_the_donor_copy(self, tiny, pair):
        donor, _ = pair
        full = _engine(tiny, "kv-full", n_slots=1)
        try:
            want = donor.generate([PROMPT], max_new_tokens=24)[0]
            hog = full.submit([1, 2, 3], max_new_tokens=60,
                              on_token=lambda t: time.sleep(0.02))
            _wait_tokens(hog, 1)
            req = _submit_throttled(donor)
            _wait_tokens(req, 2)
            grabbed = []

            def send(payload):
                grabbed.append(payload)
                return full.kv_import(payload)

            stats = donor.migrate_out(reason="drain", send=send)
            assert stats["failed"] == 1
            with pytest.raises(EngineOverloaded, match="no free slot"):
                full.kv_import(grabbed[0])
            assert req.result(timeout=60) == want
            hog.result(timeout=120)
            # The refused imports took no page: all come back.
            assert _free_plus_cached(full) == full.n_pages
        finally:
            full.close()


def test_mid_prefill_cursor_resumes(tiny):
    """A request migrated while still chunking its prompt ships the
    cursor; the receiver resumes at ``next`` and the stream equals the
    receiver's own run."""
    prompt = [(3 * i + 5) % 60 for i in range(40)]
    donor = _engine(tiny, "kv-cur-donor", prefill_chunk_tokens=8)
    recv = _engine(tiny, "kv-cur-recv", prefill_chunk_tokens=8)
    try:
        want = recv.generate([prompt], max_new_tokens=12)[0]
        grabbed, adopted = [], []

        def send(payload):
            grabbed.append(payload)
            adopted.append(recv.kv_import(payload))
            return "recv-local"

        # 50 ms an iteration on the donor only: 5 prefill chunks take
        # >= 250 ms, so the export lands mid-cursor.
        chaos.install(chaos.parse_spec(
            "engine.wedge:count=500,delay=0.05,match=kv-cur-donor"))
        try:
            req = donor.submit(prompt, max_new_tokens=12)
            stats = None
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                if donor._prefilling:
                    stats = donor.migrate_out(reason="rebalance", send=send)
                    break
                time.sleep(0.002)
        finally:
            chaos.reset()
        assert stats is not None, "prefill window never opened"
        assert stats["moved"] == 1, stats
        hdr = kvtransfer.peek(grabbed[0])
        assert hdr["phase"] == "prefill"
        assert 0 < hdr["cursor"]["next"] < len(prompt)
        with pytest.raises(RequestMigrated):
            req.result(timeout=30)
        assert adopted[0].result(timeout=60) == want
        for e in (donor, recv):
            assert _free_plus_cached(e) == e.n_pages
    finally:
        donor.close()
        recv.close()


# -- across frameworks ------------------------------------------------------------

@pytest.mark.parametrize("dtype,kv", [("float32", ""), ("bfloat16", ""),
                                      ("bfloat16", "int8")])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_cross_framework_mid_decode_continues_greedy(dtype, kv, direction):
    """A mid-decode payload from one package's engine imports into the
    other's on the same weights and continues to the donor's own greedy
    tokens (wide-gap weights, the gap asserted on the port's f32 path)."""
    cfg_r, params = _ref_params(dtype)
    cfg_p = port.TransformerConfig(**TINY, dtype=dtype)
    assert recompute(port.TransformerConfig(**TINY, dtype="float32"),
                     params, PROMPT, 24)[1] > MIN_GAP
    je = ref_engine.DecodeEngine(cfg_r, params, n_slots=2, chunk_tokens=4,
                                 kv_page_size=16, kv_quant=kv,
                                 name=f"x-r-{dtype}{kv}{direction}")
    pe = DecodeEngine(cfg_p, params, n_slots=2, chunk_tokens=4,
                      kv_page_size=16, kv_quant=kv, device="cpu",
                      name=f"x-p-{dtype}{kv}{direction}")
    donor, recv = (je, pe) if direction == "jax_to_port" else (pe, je)
    try:
        want = donor.generate([PROMPT], max_new_tokens=24)[0]
        assert recv.generate([PROMPT], max_new_tokens=24)[0] == want
        adopted = []
        req = _submit_throttled(donor)
        _wait_tokens(req, 2)
        stats = donor.migrate_out(
            reason="drain",
            send=lambda p: (adopted.append(recv.kv_import(p)), "peer")[1])
        assert stats["moved"] == 1, stats
        assert 2 <= len(req.tokens) < 24
        assert adopted[0].result(timeout=60) == want
        assert _free_plus_cached(pe) == pe.n_pages
    finally:
        je.close()
        pe.close()


def test_cross_framework_mid_prefill_cursor(tiny):
    """A JAX engine's mid-prefill cursor resumes chunking on the port."""
    cfg_r, cfg_p, params = tiny
    prompt = [(3 * i + 5) % 60 for i in range(40)]
    je = ref_engine.DecodeEngine(cfg_r, params, n_slots=2, chunk_tokens=4,
                                 kv_page_size=16, prefill_chunk_tokens=8,
                                 name="x-cur-r")
    pe = _engine(tiny, "x-cur-p", prefill_chunk_tokens=8)
    try:
        want = pe.generate([prompt], max_new_tokens=12)[0]
        assert recompute(cfg_p, params, prompt, 12)[1] > MIN_GAP
        adopted = []
        ref_chaos.install(ref_chaos.parse_spec(
            "engine.wedge:count=500,delay=0.05,match=x-cur-r"))
        try:
            req = je.submit(prompt, max_new_tokens=12)
            stats = None
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                if je._prefilling:
                    stats = je.migrate_out(
                        reason="rebalance",
                        send=lambda p: (adopted.append(pe.kv_import(p)),
                                        "peer")[1])
                    break
                time.sleep(0.002)
        finally:
            ref_chaos.install(None)
        assert stats is not None and stats["moved"] == 1, stats
        with pytest.raises(ref_engine.RequestMigrated):
            req.result(timeout=30)
        assert adopted[0].result(timeout=60) == want
    finally:
        je.close()
        pe.close()


def test_refusals_keep_the_donor_copy(tiny):
    """The reference's refusals, each a TransferError before any page is
    taken: an f32 pool into an int8 receiver and the reverse (geometry),
    a pending speculative token into a plain receiver, and adapter KV into
    an engine where that adapter degraded to base."""
    f32 = _engine(tiny, "ref-f32")
    kv8 = _engine(tiny, "ref-kv8", kv_quant="int8")
    spec = _engine(tiny, "ref-spec", draft_layers=1)
    try:
        grabbed = {}
        for tag, eng in (("f32", f32), ("kv8", kv8), ("spec", spec)):
            req = _submit_throttled(eng)
            _wait_tokens(req, 6)
            store = []
            eng.migrate_out(send=_capture(store))
            grabbed[tag] = store[0]
            req.result(timeout=60)
        for payload, recv, match in ((grabbed["f32"], kv8, "geometry"),
                                     (grabbed["kv8"], f32, "geometry"),
                                     (grabbed["spec"], f32, "speculative")):
            free = recv._mgr.n_free
            assert kvtransfer.peek(payload)["slot_state"]["pending"] >= 0 \
                or match == "geometry"
            with pytest.raises(kvtransfer.TransferError, match=match):
                recv.kv_import(payload)
            assert recv._mgr.n_free == free
        # Greedy: the speculating donor's payload imports into another
        # speculating engine (the slot decodes without its draft).
        want = f32.generate([PROMPT], max_new_tokens=24)[0]
        assert spec.kv_import(grabbed["spec"]).result(60) == want
    finally:
        for e in (f32, kv8, spec):
            e.close()


def test_adapter_kv_refused_where_the_adapter_degrades(tiny, tmp_path):
    from kubeflow_tpu_torch.serving.adapters import random_lora_flat
    from kubeflow_tpu_torch.serving.export import export_adapter

    _, cfg_p, _ = tiny
    src = {"a": "file://" + export_adapter(
        str(tmp_path / "a"), "a", cfg_p, random_lora_flat(cfg_p, 2, seed=3),
        2, 4.0)}
    donor = _engine(tiny, "ad-donor", adapters=src, adapter_slots=1)
    recv = _engine(tiny, "ad-recv", adapters=src, adapter_slots=1,
                   adapter_fallback="base")
    try:
        grabbed = []
        req = _submit_throttled(donor, adapter="a")
        _wait_tokens(req, 2)
        donor.migrate_out(send=_capture(grabbed))
        want = req.result(timeout=60)
        free = recv._mgr.n_free
        chaos.install(chaos.parse_spec("engine.adapter_load:count=1"))
        try:
            with pytest.raises(kvtransfer.TransferError, match="degraded"):
                recv.kv_import(grabbed[0])
        finally:
            chaos.reset()
        assert recv._mgr.n_free == free
        assert recv.adapter_stats()["free"] == 1
        # Healed: the same payload imports and continues.
        assert recv.kv_import(grabbed[0]).result(timeout=60) == want
    finally:
        donor.close()
        recv.close()


# -- disaggregation and the offload tier ------------------------------------------

class TestDisaggHandoff:
    def test_prefill_role_ships_to_decode_peer(self, tiny, pair):
        _, recv = pair
        want = recv.generate([PROMPT], max_new_tokens=24)[0]
        adopted = []
        donor = _engine(tiny, "kv-pf-tier", role="prefill",
                        kv_peer_send=lambda p: (
                            adopted.append(recv.kv_import(p)),
                            "recv-local")[1])
        try:
            req = donor.submit(PROMPT, max_new_tokens=24)
            with pytest.raises(RequestMigrated):
                req.result(timeout=60)
            assert adopted and adopted[0].result(timeout=60) == want
            assert sum(v for lab, v in donor._reg().counter(
                "kfx_lm_kv_migrations_total").samples()
                if lab == {"model": "kv-pf-tier", "reason": "disagg"}) >= 1
        finally:
            donor.close()

    def test_no_peer_degrades_to_local_decode(self, tiny):
        def no_peers(payload):
            raise kvtransfer.TransferError("no decode peers configured")

        donor = _engine(tiny, "kv-pf-alone", role="prefill",
                        kv_peer_send=no_peers)
        mixed = _engine(tiny, "kv-mixed")
        try:
            got = donor.generate([[9, 2, 44]], max_new_tokens=8)[0]
            assert got == mixed.generate([[9, 2, 44]], max_new_tokens=8)[0]
        finally:
            donor.close()
            mixed.close()


def test_offload_demote_then_promote_byte_identical(tiny):
    """Cold prefix pages demote to host RAM at eviction and promote back
    on the next chain-hash match: the promoted page's bytes equal the
    demoted ones, the re-served output is unchanged and counts a prefix
    hit; ``kv.offload`` drops a demotion without hurting service."""
    eng = _engine(tiny, "kv-off", n_slots=1, kv_offload_pages=16)
    try:
        prompts = [[(7 * i + j + 2) % 60 for j in range(32)]
                   for i in range(4)]
        firsts = [eng.generate([p], max_new_tokens=8)[0] for p in prompts]
        tier = eng._offload
        assert tier.demoted >= 1
        key = prefix.chain_hash(b"", prompts[0][:16])
        demoted = tier.get(key)
        assert demoted is not None and len(demoted) == eng.page_bytes
        hits = eng.prefix_stats()["hits"]
        again = eng.generate([prompts[0]], max_new_tokens=8)[0]
        assert again == firsts[0]
        assert tier.promoted >= 1 and eng.prefix_stats()["hits"] > hits
        page = eng._prefix.full[key].page
        assert eng._run_on_loop(lambda: eng._page_payload(page)) == demoted
        chaos.install(chaos.parse_spec("kv.offload:count=1"))
        try:
            assert eng.generate([prompts[1]], max_new_tokens=8)[0] == \
                firsts[1]
        finally:
            chaos.reset()
        assert _free_plus_cached(eng) == eng.n_pages
    finally:
        eng.close()


# -- the server -------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm_export(tiny, tmp_path_factory):
    cfg_r, _, params = tiny
    return ref_lm.export_lm(str(tmp_path_factory.mktemp("kv-lm")), cfg_r,
                            params)


def _servers(lm_export, n, monkeypatch, env=()):
    monkeypatch.setenv("KFX_LM_ENGINE", "1")
    monkeypatch.setenv("KFX_LM_SPEC", "0")
    monkeypatch.setenv("KFX_LM_KV_PAGE_SIZE", "16")
    monkeypatch.setenv("KFX_LM_ENGINE_CHUNK", "4")
    servers, preds = [], []
    for i in range(n):
        for k, v in (env[i] if env else {}).items():
            monkeypatch.setenv(k, v)
        p = lm_server.LMPredictor(lm_export, name="kvfleet",
                                  warm_buckets=[8], device="cpu")
        p.load()
        srv = port_server.ModelServer(port=0)
        srv.register(p)
        srv.start()
        preds.append(p)
        servers.append(srv)
    return servers, preds


def _post(url, body, raw=False, timeout=60):
    data = body if raw else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/octet-stream" if raw
        else "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read() or b"{}")


def test_server_verbs_and_prefill_role_over_http(lm_export, monkeypatch):
    """``:kvpeers`` replaces the peer set, a garbage ``:kvimport`` is a
    400, ``:migrate`` needs a peer; then a KFX_LM_ROLE=prefill server with
    KFX_LM_KV_PEERS at a decode server answers 503 + X-Kfx-Migrated, and
    the same body re-dispatched to that peer claims the adopted generation:
    tokens equal a mixed server's."""
    servers, preds = _servers(lm_export, 2, monkeypatch)
    try:
        base = f"http://127.0.0.1:{servers[0].port}/v1/models/kvfleet"
        for peers in (["http://127.0.0.1:9"], []):
            code, _, out = _post(f"{base}:kvpeers", peers)
            assert code == 200 and out["peers"] == len(peers)
            assert preds[0].kv_peers == peers
        code, _, out = _post(f"{base}:kvpeers", {"not": "a list"})
        assert code == 400
        code, _, out = _post(f"{base}:kvimport", b"not a transfer", raw=True)
        assert code == 400
        code, _, out = _post(f"{base}:migrate", {})
        assert code == 400 and "peer" in out["error"]
        code, _, out = _post(f"{base}:migrate?peer=http://127.0.0.1:9", {})
        assert code == 200 and out == {"moved": 0, "failed": 0, "pages": 0}
        body = {"prompt_tokens": [PROMPT], "max_new_tokens": 16}
        code, _, out = _post(f"{base}:generate", body)
        want = out["generated_tokens"][0]
        decode_url = f"http://127.0.0.1:{servers[1].port}"
        monkeypatch.setenv("KFX_LM_ROLE", "prefill")
        monkeypatch.setenv("KFX_LM_KV_PEERS", json.dumps([decode_url]))
        pf_srv, pf = _servers(lm_export, 1, monkeypatch)
        try:
            assert pf[0].engine.role == "prefill"
            pf_url = (f"http://127.0.0.1:{pf_srv[0].port}"
                      "/v1/models/kvfleet:generate")
            code, headers, out = _post(pf_url, body)
            assert code == 503, out
            assert headers["X-Kfx-Migrated"] == f"127.0.0.1:{servers[1].port}"
            assert float(headers["Retry-After"]) <= 0.1
            code, _, out = _post(
                f"http://{headers['X-Kfx-Migrated']}/v1/models/kvfleet"
                ":generate", body)
            assert code == 200 and out["generated_tokens"][0] == want
            assert sum(v for lab, v in preds[1].metrics.counter(
                "kfx_lm_kv_migrations_total").samples()
                if lab.get("reason") == "adopted") >= 1
        finally:
            pf_srv[0].stop()
    finally:
        for s in servers:
            s.stop()


def test_migration_under_open_sse_stream(lm_export, monkeypatch):
    """The reference's fleet e2e with its JAX-free Router in front of two
    port servers: a live migration fired while the SSE stream is open.
    The donor severs the stream, the router re-dispatches with
    ``stream_skip``, the receiver attaches the body to the adopted
    generation, and the client's stream equals an uninterrupted run."""
    import http.client

    from kubeflow_tpu.obs.metrics import MetricsRegistry
    from kubeflow_tpu.serving.router import Router

    servers, preds = _servers(lm_export, 2, monkeypatch)
    router = None
    try:
        reg = MetricsRegistry()
        router = Router(metrics=reg, name="kvfleet", namespace="ns").start()
        router.default.set_endpoints(
            [f"127.0.0.1:{s.port}" for s in servers])
        url = f"http://127.0.0.1:{router.port}"
        body = {"prompt_tokens": [PROMPT], "max_new_tokens": 40, "seed": 0}
        code, _, out = _post(f"{url}/v1/models/kvfleet:generate", body)
        want = out["generated_tokens"][0]
        assert len(want) == 40
        # 40 ms an iteration on both engines keeps the stream open long
        # enough to migrate under it.
        chaos.install(chaos.parse_spec("engine.wedge:count=2000,delay=0.04"))
        events, lines, stats = [], [], None
        conn = http.client.HTTPConnection("127.0.0.1", router.port,
                                          timeout=120)
        try:
            conn.request("POST", "/v1/models/kvfleet:generate",
                         body=json.dumps(dict(body, stream=True)).encode(),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            assert resp.status == 200
            while True:
                line = resp.readline()
                if not line:
                    break
                lines.append(line)
                if line not in (b"\n", b"\r\n"):
                    continue
                for ln in b"".join(lines).splitlines():
                    if ln.startswith(b"data: "):
                        events.append(json.loads(ln[6:]))
                lines = []
                # Read on past the done event to the stream's terminal
                # chunk: the router settles its counters before sending it.
                if stats is None and any("token" in e for e in events):
                    donor = next(i for i, p in enumerate(preds)
                                 if any(r is not None
                                        for r in p.engine._slots))
                    peer = f"http://127.0.0.1:{servers[1 - donor].port}"
                    stats = preds[donor].migrate_to(peer,
                                                    reason="rebalance")
                    assert stats["moved"] == 1, stats
        finally:
            chaos.reset()
            conn.close()
        assert stats is not None, "no token event reached the client"
        tokens = [e["token"] for e in events if "token" in e]
        assert [e["index"] for e in events if "token" in e] == \
            list(range(40)), events
        assert events[-1].get("done") and events[-1]["n_tokens"] == 40
        assert tokens == want
        assert sum(int(v) for lab, v in reg.counter(
            "kfx_router_recoveries_total").samples()
            if lab.get("mode") == "mid_stream") >= 1
    finally:
        if router is not None:
            router.stop()
        for s in servers:
            s.stop()
