"""The port's LM export, msgpack codec, metrics copy, LMPredictor and
V1 model server (kubeflow_tpu_torch/serving, obs, utils/prom.py)
against the reference's: exports read bitwise in both directions
(chunked leaves included), the reference's TestLMServing HTTP contract
rerun on the port on the CPU, and the port's HTTP greedy tokens equal
to the reference's one-shot server (KFX_LM_ENGINE=0) on the same
export, on wide-gap weights with the argmax gap asserted."""

import io
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import msgpack  # noqa: E402
import torch  # noqa: E402
from flax import serialization  # noqa: E402

from kubeflow_tpu.models import transformer as ref  # noqa: E402
from kubeflow_tpu.obs import metrics as ref_metrics  # noqa: E402
from kubeflow_tpu.serving import lm_server as ref_lm  # noqa: E402
from kubeflow_tpu.serving import server as ref_server  # noqa: E402
from kubeflow_tpu_torch.obs import metrics as port_metrics  # noqa: E402
from kubeflow_tpu_torch.runners import lm_runner  # noqa: E402
from kubeflow_tpu_torch.serving import _msgpack  # noqa: E402
from kubeflow_tpu_torch.serving import lm_server  # noqa: E402
from kubeflow_tpu_torch.serving import server as port_server  # noqa: E402

from test_torch_generate import MIN_GAP, TINY, recompute, wide_gap  # noqa: E402,E501

ENGINE_KNOBS = ("KFX_CHAOS", "KFX_LM_ADAPTERS", "KFX_LM_MODELS",
                "KFX_LM_MODEL_DEFAULT", "KFX_LM_WEIGHT_SLOTS",
                "KFX_LM_WEIGHT_IDLE_S",
                "KFX_LM_QUANT", "KFX_LM_KV_QUANT", "KFX_LM_QUANT_DRAFT",
                "KFX_LM_ROLE", "KFX_LM_KV_PEERS", "KFX_LM_KV_OFFLOAD_PAGES",
                "KFX_LM_QOS_DEFAULT", "KFX_LM_DEADLINE_MS",
                "KFX_LM_RATE_LIMITS")


def _leaves(tree):
    return sorted((jax.tree_util.keystr(p), np.asarray(x)) for p, x in
                  jax.tree_util.tree_leaves_with_path(tree))


def _assert_trees_bitwise(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, p
        assert x.tobytes() == y.tobytes(), p


def _packb(tree) -> bytes:
    buf = io.BytesIO()
    _msgpack.dump(tree, buf)
    return buf.getvalue()


def _assert_configs_equal(cfg_p, cfg_r):
    for f in ("vocab_size", "d_model", "n_heads", "head_dim", "n_layers",
              "d_ff", "max_seq_len", "attn_impl", "remat", "loss_chunk",
              "decode", "quant", "kv_quant", "lora_rank", "flash_min_seq",
              "flash_max_seq", "remat_policy", "lora_alpha"):
        assert getattr(cfg_p, f) == getattr(cfg_r, f), f
    for f in ("dtype", "param_dtype"):
        assert str(getattr(cfg_p, f)).replace("torch.", "") == \
            jnp.dtype(getattr(cfg_r, f)).name, f


@pytest.fixture(scope="module")
def tiny_export(tmp_path_factory):
    """The reference's tiny LM (f32) on wide-gap weights, exported by the
    reference's export_lm."""
    cfg = ref.TransformerConfig(**TINY, dtype=jnp.float32)
    params = ref.TransformerLM(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    params = wide_gap(jax.tree_util.tree_map(np.asarray, params))
    d = str(tmp_path_factory.mktemp("lm") / "export")
    ref_lm.export_lm(d, cfg, params)
    return d, cfg, params


# -- exports -----------------------------------------------------------------

@pytest.mark.parametrize("chunk", [None, 4096], ids=["whole", "chunked"])
def test_reference_export_loads_bitwise_in_port(tiny_export, tmp_path,
                                                monkeypatch, chunk):
    d, cfg, params = tiny_export
    if chunk:
        # Every layer leaf above 4 KB is written as chunks by flax.
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk)
        d = str(tmp_path / "chunked")
        ref_lm.export_lm(d, cfg, params)
        raw = open(os.path.join(d, "params.msgpack"), "rb").read()
        assert b"__msgpack_chunked_array__" in raw
    cfg_p, params_p = lm_server.load_lm(d)
    _assert_configs_equal(cfg_p, cfg)
    _assert_trees_bitwise(params_p, params)


@pytest.mark.parametrize("chunk", [None, 4096], ids=["whole", "chunked"])
def test_port_export_loads_bitwise_in_reference(tiny_export, tmp_path,
                                                monkeypatch, chunk):
    """Port export -> reference load_lm; the params file is the
    reference's own export byte for byte."""
    _, cfg, params = tiny_export
    if chunk:
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk)
        monkeypatch.setattr(_msgpack, "MAX_CHUNK_SIZE", chunk)
    cfg_p, _ = lm_server.load_lm(tiny_export[0])
    lm_server.export_lm(str(tmp_path / "port"), cfg_p, params)
    ref_lm.export_lm(str(tmp_path / "ref"), cfg, params)
    cfg_r, params_r = ref_lm.load_lm(str(tmp_path / "port"))
    _assert_configs_equal(cfg_p, cfg_r)
    _assert_trees_bitwise(params_r, params)
    files = [open(str(tmp_path / w / "params.msgpack"), "rb").read()
             for w in ("port", "ref")]
    assert files[0] == files[1]
    metas = [json.load(open(str(tmp_path / w / "lm_config.json")))
             for w in ("port", "ref")]
    assert metas[0] == metas[1]


def test_v1_export_loads_and_int8_export_is_refused(tiny_export, tmp_path):
    """A v1 export (no format_version, no quant knobs) loads with the
    defaults; an int8 export, refused before the port served int8, now
    loads as quant="int8" and serves :generate."""
    d, cfg, params = tiny_export
    v1 = str(tmp_path / "v1")
    ref_lm.export_lm(v1, cfg, params)
    meta = json.load(open(os.path.join(v1, "lm_config.json")))
    del meta["format_version"]
    for k in ("dtype", "param_dtype", "quant", "kv_quant"):
        meta["config"].pop(k)
    json.dump(meta, open(os.path.join(v1, "lm_config.json"), "w"))
    cfg_p, _ = lm_server.load_lm(v1)
    assert cfg_p.dtype == torch.bfloat16 and cfg_p.quant == ""
    q8 = str(tmp_path / "q8")
    ref_lm.export_lm(q8, cfg, params, quantize="int8")
    cfg_q, qp = lm_server.load_lm(q8)
    assert cfg_q.quant == "int8"
    assert np.asarray(qp["lm_head"]["kernel"]).dtype == np.int8
    p = lm_server.LMPredictor(q8, name="q8", device="cpu",
                              warm_buckets=[8])
    p.load()
    try:
        assert p.engine.cfg.quant == "int8"
        out = p.generate({"prompt_tokens": [[5, 9, 11]],
                          "max_new_tokens": 4})["generated_tokens"]
        assert len(out[0]) == 4
    finally:
        p.close()
    lm_server.export_lm(str(tmp_path / "x"), cfg_p, params,
                        quantize="int8")
    assert json.load(open(str(tmp_path / "x" / "lm_config.json")))[
        "quant"] == {"weights": "int8", "scheme": "per_channel_symmetric"}


def test_remat_and_loss_chunk_exports_load(tiny_export, tmp_path):
    """A config trained with remat or chunked CE serves: decode uses
    neither."""
    _, cfg, params = tiny_export
    import dataclasses

    d = str(tmp_path / "remat")
    ref_lm.export_lm(d, dataclasses.replace(cfg, remat=True, loss_chunk=16),
                     params)
    cfg_p, _ = lm_server.load_lm(d)
    assert cfg_p.remat and cfg_p.loss_chunk == 16


def test_runner_export_is_read_by_reference(tmp_path, capsys):
    d = str(tmp_path / "runner")
    rc = lm_runner.main(["--preset", "tiny", "--steps", "2",
                         "--batch-size", "2", "--seq-len", "64",
                         "--device", "cpu", "--export-dir", d])
    out = capsys.readouterr().out
    assert rc == 0 and f"exported_lm dir={d}" in out
    cfg_r, params_r = ref_lm.load_lm(d)
    assert (cfg_r.d_model, cfg_r.max_seq_len) == (128, 64)
    _, params_p = lm_server.load_lm(d)
    _assert_trees_bitwise(params_p, params_r)


# -- the msgpack codec -------------------------------------------------------

WIDTHS = {
    "ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
             2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
             -2 ** 31, -2 ** 31 - 1, -2 ** 63],
    "scalars": [True, False, None, 1.5, -0.0, 1e300],
    "strs": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "e" * 65535,
             "f" * 65536, "ü"],
    "arrays": [list(range(15)), list(range(16)), list(range(65536))],
    "maps": [{str(i): i for i in range(n)} for n in (15, 16, 65536)],
}


@pytest.mark.parametrize("kind", sorted(WIDTHS))
def test_codec_matches_msgpack_at_every_header_width(kind):
    tree = {kind: WIDTHS[kind]}
    packed = msgpack.packb(tree, use_bin_type=True)
    assert _packb(tree) == packed
    assert _msgpack.unpackb(bytearray(packed)) == tree


@pytest.mark.parametrize("n", [0, 1, 255, 256, 65535, 65536])
def test_codec_reads_bin_and_float32(n):
    packed = msgpack.packb({"b": b"x" * n, "f": 0.5},
                           use_bin_type=True, use_single_float=True)
    out = _msgpack.unpackb(bytearray(packed))
    assert bytes(out["b"]) == b"x" * n and out["f"] == 0.5


@pytest.mark.parametrize("nbytes", [0, 5, 100, 300, 70000])
@pytest.mark.parametrize("dtype", ["uint8", "float32", "int32"])
def test_codec_arrays_match_flax(nbytes, dtype):
    """Array leaves at every ext width flax emits (fixext16 at a 16-byte
    payload, ext8/16/32) and numpy scalars (ext type 3)."""
    n = nbytes // np.dtype(dtype).itemsize
    tree = {"a": np.arange(n, dtype=dtype).reshape(n, 1),
            "i": np.int64(-3), "s": np.float32(2.5)}  # flax sorts keys
    packed = serialization.msgpack_serialize(tree)
    assert _packb(tree) == packed
    out = _msgpack.unpackb(bytearray(packed))
    _assert_trees_bitwise(out, tree)
    assert isinstance(out["s"], np.float32)


def test_codec_reads_bfloat16_as_torch():
    x = jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3) / 3
    packed = serialization.msgpack_serialize({"w": np.asarray(x)})
    w = _msgpack.unpackb(bytearray(packed))["w"]
    assert w.dtype == torch.bfloat16 and w.shape == (2, 3)
    assert np.array_equal(w.view(torch.uint16).numpy(),
                          np.asarray(x).view(np.uint16))


def test_codec_errors_name_the_offset():
    with pytest.raises(ValueError, match="0xc1 at offset 2"):
        _msgpack.unpackb(bytearray(b"\x81\xa0\xc1"))
    with pytest.raises(ValueError, match="truncated at offset 1"):
        _msgpack.unpackb(bytearray(b"\xa5ab"))
    packed = msgpack.packb({"c": msgpack.ExtType(2, b"\x00" * 4)})
    with pytest.raises(ValueError, match="ext type 2 at offset 3 \\(c\\)"):
        _msgpack.unpackb(bytearray(packed))
    bad = serialization.msgpack_serialize({"w": np.zeros(2, np.float32)})
    bad = bad.replace(b"float32", b"float99")
    with pytest.raises(ValueError, match="float99.*w"):
        _msgpack.unpackb(bytearray(bad))


# -- metrics -----------------------------------------------------------------

def test_metrics_render_same_text_as_reference():
    regs = [ref_metrics.MetricsRegistry(), port_metrics.MetricsRegistry()]
    for reg in regs:
        reg.counter("kfx_c_total", "A counter.").inc(3, model='m"1')
        reg.counter("kfx_c_total").inc(2, model="m\n2", verb="x")
        reg.gauge("kfx_g", "A gauge.\\ok").set(0.25)
        h = reg.histogram("kfx_h_seconds", "A histogram.",
                          buckets=(0.1, 1.0))
        for v in (0.05, 0.5, 7.0):
            h.observe(v, model="a")
        h.observe(0.2, n=3, model="b")
        reg.histogram("kfx_default_seconds", "Defaults.").observe(0.003)
        reg.add_collector(lambda r: r.gauge("kfx_collected").set(7))
    assert regs[1].render() == regs[0].render()
    for reg in regs[1:]:
        assert reg.histogram("kfx_h_seconds").percentile(0.5) == \
            regs[0].histogram("kfx_h_seconds").percentile(0.5)


# -- the HTTP contract -------------------------------------------------------

def _post(url, payload, timeout=60, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.load(r), dict(r.headers)


def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        body = r.read().decode()
        return (json.loads(body) if r.headers["Content-Type"]
                == "application/json" else body)


def _code(url, payload):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, payload)
    return e.value.code, json.loads(e.value.read() or b"{}"), e.value.headers


def _sse(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode())
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.headers["Content-Type"] == "text/event-stream"
        raw = r.read().decode()
    return [json.loads(line[len("data: "):]) for line in raw.splitlines()
            if line.startswith("data: ")]


@pytest.fixture(scope="module")
def server(tiny_export):
    p = lm_server.LMPredictor(tiny_export[0], name="lm", device="cpu")
    p.load()
    srv = port_server.ModelServer(port=0)
    srv.register(p)
    srv.start()
    yield f"http://127.0.0.1:{srv.port}", srv
    srv.stop()


def test_generate_and_error_contract(server):
    url, _ = server
    body, _ = _post(f"{url}/v1/models/lm:generate",
                    {"prompt_tokens": [[5, 9, 11]], "max_new_tokens": 6})
    assert len(body["generated_tokens"][0]) == 6
    assert body["tokens_per_second"] > 0
    # :predict on an LM model is a clean 500/400, not a crash
    code, _, _ = _code(f"{url}/v1/models/lm:predict", {"instances": [[0]]})
    assert code in (400, 500)
    gen = f"{url}/v1/models/lm:generate"
    # The default server runs the engine: stop_token is legal there, and
    # the batch limit is the engine's bounded queue (4 x 8 slots).
    one = {"prompt_tokens": [[5, 9, 11, 3, 7]], "max_new_tokens": 12}
    want = _post(gen, one)[0]["generated_tokens"][0]
    # A stop token whose first occurrence is past index 1: the engine
    # stops at the first hit and never emits the stop token itself.
    cut = next(j for j in range(2, len(want)) if want[j] not in want[:j])
    got = _post(gen, dict(one, stop_token=want[cut]))[0]
    assert got["generated_tokens"][0] == want[:cut]
    for payload, msg in (
            ({"prompt_tokens": [[999]]}, "token ids"),
            ({"prompt_tokens": []}, "prompt_tokens"),
            ({"prompt_tokens": [[1]], "stop_token": "x"}, "invalid literal"),
            ({"prompt_tokens": [[1]], "adapter": "a"}, "adapter"),
            ({"prompt_tokens": [[1]], "adapter": 3}, "adapter"),
            ({"prompt_tokens": [[1]], "model": "m"}, "model"),
            ({"prompt_tokens": [[1]], "max_new_tokens": 0}, "max_new"),
            ({"prompt_tokens": [[1]] * 33}, "queue capacity"),
            ({"prompt_tokens": [[1] * 60], "max_new_tokens": 32},
             "cache capacity"),
            ({"prompt_tokens": [[1]], "deadline_ms": -1}, "deadline_ms")):
        code, err, _ = _code(gen, payload)
        assert code == 400 and msg in err["error"], (payload, err)
    for verb in ("generate", "predict"):
        code, _, _ = _code(f"{url}/v1/models/nope:{verb}",
                           {"prompt_tokens": [[1]]})
        assert code == 404
    # :evict is the weight pool's verb: a host without a pool answers
    # 400, as the reference's server does.
    code, err, _ = _code(f"{url}/v1/models/lm:evict", {})
    assert code == 400 and "weight pool" in err["error"]


def test_oneshot_error_contract(tiny_export, monkeypatch):
    """KFX_LM_ENGINE=0 keeps the one-shot path's contract: stop_token is
    a 400 (as on the reference's one-shot path), the batch limit is
    max_batch_size, and the JSON metrics carry no engine block."""
    monkeypatch.setenv("KFX_LM_ENGINE", "0")
    p = lm_server.LMPredictor(tiny_export[0], name="lm", device="cpu")
    p.load()
    assert p.engine is None
    srv = port_server.ModelServer(port=0)
    srv.register(p)
    srv.start()
    url = f"http://127.0.0.1:{srv.port}"
    try:
        gen = f"{url}/v1/models/lm:generate"
        for payload, msg in (
                ({"prompt_tokens": [[1]], "stop_token": 2}, "stop_token"),
                ({"prompt_tokens": [[1]], "adapter": "a"}, "adapter"),
                ({"prompt_tokens": [[1]], "model": "m"}, "model"),
                ({"prompt_tokens": [[1]] * 9}, "max_batch_size")):
            code, err, _ = _code(gen, payload)
            assert code == 400 and msg in err["error"], (payload, err)
        _post(gen, {"prompt_tokens": [[1, 2]], "max_new_tokens": 3})
        assert _get(f"{url}/metrics?format=json")["engine"] == {}
        assert _get(f"{url}/healthz") == {"status": "alive"}
    finally:
        srv.stop()


def test_probes_and_metrics(server):
    url, _ = server
    _post(f"{url}/v1/models/lm:generate", {"prompt_tokens": [1, 2],
                                           "max_new_tokens": 3})
    assert _get(f"{url}/healthz") == {"status": "alive"}
    assert _get(f"{url}/v1/models") == {"models": ["lm"]}
    assert _get(f"{url}/v1/models/lm") == {"name": "lm", "ready": True}
    text = _get(f"{url}/metrics")
    for fam in ("kfx_lm_generated_tokens_total", "kfx_serving_requests_total",
                "kfx_serving_request_seconds_bucket", "kfx_lm_warm_buckets",
                "kfx_lm_tokens_per_second", "kfx_serving_models_ready 1"):
        assert fam in text, fam
    js = _get(f"{url}/metrics?format=json")
    assert js["models"] == ["lm"] and js["request_count"] >= 1
    assert js["latency_ms"]["lm"]["p50"] > 0
    blk = js["engine"]["lm"]
    assert blk["slots"] == 8 and blk["queue_depth"] == 0
    assert blk["kv_pages"] == blk["kv_pages_free"] + blk.get("cached", 0) \
        or blk["kv_pages_free"] <= blk["kv_pages"]
    assert blk["quant"] == "f32"


def test_trace_headers_are_echoed(server):
    url, _ = server
    _, headers = _post(f"{url}/v1/models/lm:generate",
                       {"prompt_tokens": [[3]], "max_new_tokens": 2},
                       headers={"X-Kfx-Trace-Id": "00ab" * 4,
                                "X-Kfx-Span-Id": "12" * 8})
    assert headers["X-Kfx-Trace-Id"] == "00ab" * 4
    assert len(headers["X-Kfx-Span-Id"]) == 16


def test_sse_replays_buffered_tokens(server):
    url, _ = server
    gen = f"{url}/v1/models/lm:generate"
    req = {"prompt_tokens": [[7, 8, 9]], "max_new_tokens": 5}
    want = _post(gen, req)[0]["generated_tokens"][0]
    events = _sse(gen, dict(req, stream=True))
    assert [e["token"] for e in events[:-1]] == want
    assert [e["index"] for e in events[:-1]] == list(range(5))
    assert events[-1]["done"] and events[-1]["n_tokens"] == 5
    skipped = _sse(gen, dict(req, stream=True, stream_skip=2))
    assert [e["index"] for e in skipped[:-1]] == [2, 3, 4]
    code, err, _ = _code(gen, {"prompt_tokens": [[1], [2]], "stream": True})
    assert code == 400 and "one prompt" in err["error"]


def test_concurrent_requests_equal_sequential(server):
    url, _ = server
    gen = f"{url}/v1/models/lm:generate"
    reqs = [{"prompt_tokens": [[1, 2, 3], [4]], "max_new_tokens": 7},
            {"prompt_tokens": [[9] * 20], "max_new_tokens": 5,
             "temperature": 0.8, "top_k": 5, "seed": 4}]
    seq = [_post(gen, r)[0]["generated_tokens"] for r in reqs]
    got = [None] * len(reqs)

    def call(i):
        got[i] = _post(gen, reqs[i])[0]["generated_tokens"]

    threads = [threading.Thread(target=call, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert got == seq


def test_drain_sheds_with_retry_after(tiny_export):
    p = lm_server.LMPredictor(tiny_export[0], name="lm", device="cpu")
    p.load()
    srv = port_server.ModelServer(port=0).start()
    srv.register(p)
    url = f"http://127.0.0.1:{srv.port}"
    try:
        assert _post(f"{url}/drain?wait_s=1", {})[0] == {
            "draining": True, "drained": True}
        assert _get(f"{url}/v1/models/lm")["ready"] is False
        assert _get(f"{url}/healthz") == {"status": "draining"}
        code, err, headers = _code(f"{url}/v1/models/lm:generate",
                                   {"prompt_tokens": [[1]]})
        assert code == 503 and headers["Retry-After"] == "1"
        code, _, _ = _code(f"{url}/drain?wait_s=x", {})
        assert code == 400
    finally:
        srv.stop()


def test_http_greedy_equals_reference_oneshot_server(tiny_export,
                                                     server, monkeypatch):
    """Serving parity: the port's HTTP greedy tokens equal the reference
    LMPredictor's with KFX_LM_ENGINE=0 (its one-shot oracle) on the same
    export, after asserting the argmax gaps on the path."""
    d, _, params = tiny_export
    url, _ = server
    cfg_p, _ = lm_server.load_lm(d)
    assert cfg_p.dtype == torch.float32
    prompts = [[5, 9, 11, 3, 7], [2, 30], [40, 41, 42, 43, 44, 45, 46]]
    for p in prompts:
        assert recompute(cfg_p, params, p, 8)[1] > MIN_GAP
    monkeypatch.setenv("KFX_LM_ENGINE", "0")
    rp = ref_lm.LMPredictor(d, name="lm")
    rp.load()
    rsrv = ref_server.ModelServer(port=0)
    rsrv.register(rp)
    rsrv.start()
    try:
        req = {"prompt_tokens": prompts, "max_new_tokens": 8}
        want = _post(f"http://127.0.0.1:{rsrv.port}/v1/models/lm:generate",
                     req)[0]["generated_tokens"]
    finally:
        rsrv.stop()
    got = _post(f"{url}/v1/models/lm:generate", req)[0]["generated_tokens"]
    assert got == want


@pytest.mark.parametrize("knob,value", [
    ("KFX_LM_MODELS", '{"m0": "{d}", "m1": "file://{d}"}'),
    ("KFX_LM_MODEL_DEFAULT", "m1"),
    ("KFX_LM_WEIGHT_SLOTS", "1"),
    ("KFX_LM_WEIGHT_IDLE_S", "0.5")])
def test_pool_knobs_take_effect(tiny_export, monkeypatch, knob, value):
    """The weight pool's knobs (Queue A 1), once refused, load and reach
    the engine as the reference's do: KFX_LM_MODELS gives it the pool
    (speculation off), KFX_LM_MODEL_DEFAULT the resident model,
    KFX_LM_WEIGHT_SLOTS the slot count and KFX_LM_WEIGHT_IDLE_S the idle
    window. The one-shot path (KFX_LM_ENGINE=0) takes them too and has
    no engine to give them to, as in the reference."""
    assert knob in ENGINE_KNOBS
    d = tiny_export[0]
    base = {"KFX_LM_MODELS": '{"m0": "{d}", "m1": "{d}"}',
            "KFX_LM_MODEL_DEFAULT": "m0"}
    base[knob] = value
    for k, v in base.items():
        monkeypatch.setenv(k, v.replace("{d}", d))
    for engine in ("1", "0"):
        monkeypatch.setenv("KFX_LM_ENGINE", engine)
        p = lm_server.LMPredictor(d, device="cpu", warm_buckets=[8])
        p.load()
        try:
            if engine == "0":
                assert p.engine is None and p.pooled_models() == {}
                continue
            eng = p.engine
            assert not eng.spec
            default = base["KFX_LM_MODEL_DEFAULT"]
            assert eng.model_default == default
            assert p.pooled_models() == {"m0": default == "m0",
                                         "m1": default == "m1"}
            stats = p.weight_stats()
            assert stats["slots"] == (1 if knob == "KFX_LM_WEIGHT_SLOTS"
                                      else 2)
            assert eng.model_idle_s == (0.5 if knob == "KFX_LM_WEIGHT_IDLE_S"
                                        else 0.0)
        finally:
            p.close()


@pytest.mark.parametrize("knob,value,attr,want", [
    ("KFX_LM_QOS_DEFAULT", "batch", "qos_default", "batch"),
    ("KFX_LM_DEADLINE_MS", "500", "deadline_default_s", 0.5),
    ("KFX_LM_RATE_LIMITS", '{"": 10}', "rate_limits", {"": 10.0}),
    ("KFX_LM_ROLE", "prefill", "role", "prefill"),
    ("KFX_LM_KV_PEERS", '["http://127.0.0.1:1"]', "_peer_send", True),
    ("KFX_LM_KV_OFFLOAD_PAGES", "4", "_offload", 4)])
def test_request_and_kv_knobs_take_effect(tiny_export, monkeypatch, knob,
                                          value, attr, want):
    """The knobs of the request plane (Queue A 5b.7) and of the KV
    transfer plane (the first half of 5b.8), once refused, load and reach
    the engine as the reference's do: the class default, the default
    deadline, the rate budgets, the role, a peer sender, and the host
    tier's capacity. The one-shot path (KFX_LM_ENGINE=0) takes them too
    and has no engine to give them to, as in the reference."""
    assert knob in ENGINE_KNOBS
    monkeypatch.setenv(knob, value)
    for engine in ("1", "0"):
        monkeypatch.setenv("KFX_LM_ENGINE", engine)
        p = lm_server.LMPredictor(tiny_export[0], device="cpu",
                                  warm_buckets=[8])
        p.load()
        try:
            if engine == "0":
                assert p.engine is None
                continue
            got = getattr(p.engine, attr)
            if knob == "KFX_LM_KV_PEERS":
                got = got is not None
            elif knob == "KFX_LM_KV_OFFLOAD_PAGES":
                got = got.capacity
            assert got == want
        finally:
            p.close()


@pytest.mark.parametrize("knob,value", [
    ("KFX_CHAOS", "engine.admit:count=1"), ("KFX_LM_QUANT", "int8"),
    ("KFX_LM_KV_QUANT", "int8"), ("KFX_LM_QUANT_DRAFT", "int8"),
    ("KFX_LM_ADAPTERS", '{"a": "file://{artifact}"}')])
def test_ported_engine_knobs_take_effect(tiny_export, monkeypatch, knob,
                                         value, tmp_path):
    """The knobs of ported extensions (Queue A 5b.4, 5b.5, 5b.6) load and
    take effect, with the engine on and, where the reference reads them
    there (KFX_CHAOS, KFX_LM_QUANT), off: the chaos plan is installed from
    the environment, the quant knobs change the engine's quant_mode (the
    one-shot path has no paged pool and no draft, so KV and draft quant
    leave it full precision, as in the reference), and KFX_LM_ADAPTERS
    (an artifact exported here) gives the engine its adapter pool."""
    from kubeflow_tpu_torch import chaos
    from kubeflow_tpu_torch.serving.adapters import random_lora_flat
    from kubeflow_tpu_torch.serving.export import export_adapter

    assert knob in ENGINE_KNOBS
    if knob == "KFX_LM_ADAPTERS":
        cfg = lm_server.load_lm(tiny_export[0])[0]
        value = value.replace("{artifact}", export_adapter(
            str(tmp_path / "a"), "a", cfg, random_lora_flat(cfg, 2), 2,
            4.0))
    monkeypatch.setenv(knob, value)
    want = {"KFX_CHAOS": "f32", "KFX_LM_QUANT": "w8",
            "KFX_LM_KV_QUANT": "kv8", "KFX_LM_QUANT_DRAFT": "d8",
            "KFX_LM_ADAPTERS": "f32"}[knob]
    chaos.reset()
    try:
        for engine in ("1", "0"):
            monkeypatch.setenv("KFX_LM_ENGINE", engine)
            p = lm_server.LMPredictor(tiny_export[0], device="cpu",
                                      warm_buckets=[8])
            p.load()
            try:
                if engine == "1":
                    assert p.engine.quant_mode == want
                    model = p.engine.model
                else:
                    model = p._gen.model
                quant = knob == "KFX_LM_QUANT"
                assert (model.lm_head.kernel.dtype == torch.int8) == quant
                if engine == "1":
                    pooled = knob == "KFX_LM_ADAPTERS"
                    assert (p.engine.adapter_stats()["slots"] == 8) == pooled
                if knob == "KFX_CHAOS":
                    plan = chaos.active_plan()
                    assert set(plan.rules) == {"engine.admit"}
            finally:
                p.close()
    finally:
        chaos.reset()


def test_oneshot_knob_values_are_accepted(tiny_export, monkeypatch):
    """Knob values that select what the port runs load: the engine (the
    default, KFX_LM_ENGINE unset or 1) with KFX_LM_SPEC=0 and the
    extension knobs at their off values, and the one-shot oracle with
    KFX_LM_ENGINE=0."""
    for knob, value in (("KFX_LM_QUANT", "0"), ("KFX_LM_ROLE", "mixed"),
                        ("KFX_LM_SPEC", "0"), ("KFX_LM_KV_QUANT", "0"),
                        ("KFX_LM_QUANT_DRAFT", "0"), ("KFX_CHAOS", ""),
                        ("KFX_LM_QOS_DEFAULT", "interactive"),
                        ("KFX_LM_DEADLINE_MS", "0"),
                        ("KFX_LM_ADAPTERS", "{}")):
        monkeypatch.setenv(knob, value)
    for engine, on in ((None, True), ("1", True), ("0", False)):
        if engine is None:
            monkeypatch.delenv("KFX_LM_ENGINE", raising=False)
        else:
            monkeypatch.setenv("KFX_LM_ENGINE", engine)
        p = lm_server.LMPredictor(tiny_export[0], device="cpu")
        p.load()
        try:
            assert p.ready and p.device == "cpu"
            assert (p.engine is not None) == on
            assert p.engine is None or not p.engine.spec
        finally:
            p.close()


def test_predictor_defaults_to_cuda(tiny_export):
    p = lm_server.LMPredictor(tiny_export[0], device="auto")
    assert p.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            p.load()
        assert not p.ready


def test_server_main_refuses_non_lm_exports(tmp_path, capsys):
    # A directory with no export of any framework (classifier exports
    # serve since the classifier path landed, the other frameworks' since
    # their predictors did: tests/test_torch_classifier_server.py).
    assert port_server.main(["--model-dir", str(tmp_path)]) == 2
    assert "holds no export" in capsys.readouterr().err
    assert port_server.main(["--model-dir", str(tmp_path),
                             "--framework", "jax"]) == 2
    assert port_server.main(["--model-dir", str(tmp_path),
                             "--framework", "pytorch"]) == 2
    assert "holds no export for --framework pytorch" in \
        capsys.readouterr().err
