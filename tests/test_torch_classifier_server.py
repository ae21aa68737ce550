"""Classifier serving in the port: the export format read across the two
packages in both directions, the JaxPredictor and MicroBatcher behind the
V1 ModelServer (the port's counterparts of tests/test_serving.py's
TestModelServer and TestMicroBatcher), and the server's ``main``.

Tolerances: the f32 export is the reference's byte for byte; int8 codes
and scales equal the reference's quantizer's; served probabilities agree
with the reference's predictor to 3e-2 (bf16 compute in both) and its
predictions on at least 95% of the eval images (a bf16 near-tie may flip);
the batcher's predictions equal the predictor's on the same stacked
batch exactly."""

import json
import os
import re
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from kubeflow_tpu.serving import export as ref_export  # noqa: E402
from kubeflow_tpu.serving.server import JaxPredictor as RefPredictor  # noqa: E402,E501
from kubeflow_tpu_torch.data import get_dataset  # noqa: E402
from kubeflow_tpu_torch.models import get_model  # noqa: E402
from kubeflow_tpu_torch.models.convert import (  # noqa: E402
    classifier_params_from_jax, classifier_params_to_jax)
from kubeflow_tpu_torch.serving import export as port_export  # noqa: E402
from kubeflow_tpu_torch.serving import server as port_server  # noqa: E402
from kubeflow_tpu_torch.serving.server import (  # noqa: E402
    JaxPredictor, MicroBatcher, ModelServer, Predictor)
from kubeflow_tpu_torch.training import TrainLoop  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _post(url, payload, timeout=30):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.load(resp)


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, json.load(resp)


def _code(url, payload):
    try:
        return _post(url, payload)[0]
    except urllib.error.HTTPError as e:
        return e.code


@pytest.fixture(scope="module")
def trained():
    """The port's mlp trained 20 steps on mnist (the reference's fixture)."""
    ds = get_dataset("mnist")
    loop = TrainLoop(get_model("mlp", num_classes=ds.num_classes,
                               input_shape=ds.shape), device="cpu")
    state = loop.init_state(ds.shape)
    for images, labels in ds.batches(128, steps=20):
        state, *_ = loop.train_step(state, images, labels)
    return ds, state


@pytest.fixture(scope="module")
def export_dir(trained, tmp_path_factory):
    ds, state = trained
    out = str(tmp_path_factory.mktemp("export"))
    port_export.export_params(out, "mlp", ds.shape, ds.num_classes, state)
    return out


@pytest.fixture(scope="module")
def server(export_dir):
    predictor = JaxPredictor(export_dir, name="mnist", max_batch_size=16,
                             device="cpu")
    predictor.load()
    srv = ModelServer(port=0)
    srv.register(predictor)
    srv.start()
    yield srv
    srv.stop()


# -- the export format across the packages ---------------------------------

def test_port_export_is_the_reference_format(trained, export_dir, tmp_path):
    ds, state = trained
    params, stats = classifier_params_to_jax(
        "mlp", {**state.params, **state.batch_stats})
    ref_dir = str(tmp_path / "ref")
    ref_export.export_params(ref_dir, "mlp", ds.shape, ds.num_classes,
                             types.SimpleNamespace(params=params,
                                                   batch_stats=stats))
    for f in ("params.msgpack", "config.json"):
        with open(os.path.join(ref_dir, f), "rb") as a, \
                open(os.path.join(export_dir, f), "rb") as b:
            assert a.read() == b.read(), f
    config, payload = ref_export.load_exported(export_dir)
    assert config["format_version"] == 2
    assert port_server.load_export_meta(export_dir) == ((28, 28, 1), 10)
    assert port_server.load_export_meta(str(tmp_path)) == (None, None)
    assert port_export.export_format_version(config) == 2
    assert port_export.export_format_version({}) == 1


def test_reference_predictor_serves_port_export(export_dir):
    images, _ = get_dataset("mnist", "eval").eval_arrays(64)
    ref = RefPredictor(export_dir, name="m", max_batch_size=64)
    ref.load()
    port = JaxPredictor(export_dir, name="m", max_batch_size=64,
                        device="cpu")
    port.load()
    want = ref.predict(images, probabilities=True)
    got = port.predict(images, probabilities=True)
    agree = np.mean(np.asarray(want["predictions"])
                    == np.asarray(got["predictions"]))
    assert agree >= 0.95
    assert np.abs(np.asarray(want["probabilities"])
                  - np.asarray(got["probabilities"])).max() <= 3e-2


def _ref_weights(ref, shape, seed=0):
    """Seeded values in the reference model's tree (shapes from
    ``jax.eval_shape``); running var in [0.5, 1.5]."""
    abstract = jax.eval_shape(lambda: ref.init(
        jax.random.PRNGKey(0), jnp.zeros((1,) + shape), train=False))
    rng = np.random.default_rng(seed)

    def fill(path, a):
        leaf = path[-1].key
        if leaf == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if leaf in ("scale",):
            return (1 + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
        if leaf in ("bias", "mean"):
            return (0.1 * rng.normal(size=a.shape)).astype(np.float32)
        fan_in = int(np.prod(a.shape[:-1])) or 1
        return (rng.normal(size=a.shape) / np.sqrt(fan_in)).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(fill, abstract)


def test_port_predictor_serves_reference_export(tmp_path):
    """A reference export of resnet18 (BatchNorm running stats in the
    payload) served by the port equals the reference model's forward."""
    from kubeflow_tpu.models import get_model as ref_get_model

    shape = (32, 32, 3)
    ref = ref_get_model("resnet18", num_classes=10)
    v = _ref_weights(ref, shape)
    out = str(tmp_path / "ref-resnet18")
    ref_export.export_params(out, "resnet18", shape, 10,
                             types.SimpleNamespace(**v))
    x = np.random.default_rng(1).uniform(0, 1, (3,) + shape).astype(
        np.float32)
    logits = np.asarray(jax.jit(ref.apply)(v, x))
    p = JaxPredictor(out, max_batch_size=2, device="cpu")
    p.load()
    got = p.predict(x, probabilities=True)
    want = np.asarray(jax.nn.softmax(logits, -1))
    assert np.abs(np.asarray(got["probabilities"]) - want).max() <= 3e-2
    top2 = np.sort(logits, -1)
    clear = top2[:, -1] - top2[:, -2] > 0.05 * np.abs(logits).max()
    assert np.array_equal(np.asarray(got["predictions"])[clear],
                          logits.argmax(-1)[clear])


def test_int8_export(trained, export_dir, tmp_path):
    ds, state = trained
    out = str(tmp_path / "int8")
    port_export.export_params(out, "mlp", ds.shape, ds.num_classes, state,
                              quantize="int8")
    config, _ = ref_export.load_exported(out)
    assert config["quant"] == {"weights": "int8",
                               "scheme": "per_channel_symmetric"}
    # The codes and scales are the reference quantizer's.
    from kubeflow_tpu_torch.serving import _msgpack

    raw = _msgpack.load(os.path.join(out, "params.msgpack"))["params"]
    params, _ = classifier_params_to_jax(
        "mlp", {**state.params, **state.batch_stats})
    want = ref_export.quantize_tree_int8(params)
    assert jax.tree_util.tree_structure(raw) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree.leaves(raw), jax.tree.leaves(want)):
        assert a.dtype == np.asarray(b).dtype
        assert np.array_equal(a, np.asarray(b))
    # Both loaders dequantize to the same f32 params.
    _, ref_payload = ref_export.load_exported(out)
    _, port_payload = port_export.load_exported("file://" + out)
    for a, b in zip(jax.tree.leaves(ref_payload),
                    jax.tree.leaves(port_payload)):
        assert np.array_equal(np.asarray(a), b)
    images, _ = get_dataset("mnist", "eval").eval_arrays(64)
    preds = {}
    for tag, d in (("f32", export_dir), ("int8", out)):
        p = JaxPredictor(d, max_batch_size=64, device="cpu")
        p.load()
        preds[tag] = np.asarray(p.predict(images)["predictions"])
    assert np.mean(preds["f32"] == preds["int8"]) >= 0.9
    with pytest.raises(ValueError, match="quantize"):
        port_export.export_params(out, "mlp", ds.shape, 10, state,
                                  quantize="fp8")


# -- TestModelServer (tests/test_serving.py) -------------------------------

def test_v1_protocol_surface(server):
    base = f"http://127.0.0.1:{server.port}"
    assert _get(f"{base}/healthz")[0] == 200
    status, body = _get(f"{base}/v1/models")
    assert status == 200 and body["models"] == ["mnist"]
    status, body = _get(f"{base}/v1/models/mnist")
    assert status == 200 and body["ready"] is True


def test_predict_correctness(server):
    ds = get_dataset("mnist", split="eval")
    images, labels = ds.eval_arrays(32)
    base = f"http://127.0.0.1:{server.port}"
    status, body = _post(f"{base}/v1/models/mnist:predict",
                         {"instances": images.tolist()})
    assert status == 200
    preds = np.asarray(body["predictions"])
    assert preds.shape == (32,)
    assert (preds == labels).mean() > 0.5       # trained: beats chance
    assert "probabilities" not in body           # opt-in
    status, body = _post(f"{base}/v1/models/mnist:predict",
                         {"instances": images.tolist(),
                          "probabilities": True})
    assert status == 200
    assert len(body["probabilities"][0]) == ds.num_classes
    assert np.allclose(np.sum(body["probabilities"], -1), 1, atol=1e-5)


def test_bucket_padding_and_oversized_requests(server):
    base = f"http://127.0.0.1:{server.port}"
    p = server.predictors["mnist"]
    assert p._buckets == [1, 2, 4, 8, 16]
    assert p.placement == {b: "cpu" for b in p._buckets}
    assert set(p.probe_ms) == {"cpu"}
    images, _ = get_dataset("mnist", split="eval").eval_arrays(37)
    for n in (3, 37):   # padded to a bucket; split by max_batch_size
        status, body = _post(f"{base}/v1/models/mnist:predict",
                             {"instances": images[:n].tolist()})
        assert status == 200 and len(body["predictions"]) == n
    whole = p.predict(images)["predictions"]
    assert whole[:3] == p.predict(images[:3])["predictions"]


def test_errors(server):
    base = f"http://127.0.0.1:{server.port}"
    assert _code(f"{base}/v1/models/nope:predict",
                 {"instances": [[0.0]]}) == 404
    assert _code(f"{base}/v1/models/mnist:predict", {"wrong": 1}) == 400
    assert _code(f"{base}/v1/models/mnist:predict",
                 {"instances": [[0.0], [0.0, 1.0]]}) == 400
    assert _code(f"{base}/v1/models/mnist:predict",
                 {"instances": np.zeros((1, 7, 7, 1)).tolist()}) == 500
    assert server.errors_total.samples()


def test_vit_exports_and_serves(tmp_path):
    ds = get_dataset("mnist")
    loop = TrainLoop(get_model("vit", num_classes=ds.num_classes,
                               input_shape=ds.shape), device="cpu")
    state = loop.init_state(ds.shape)
    for images, labels in ds.batches(16, steps=2):
        state, *_ = loop.train_step(state, images, labels)
    out = str(tmp_path / "vit-export")
    port_export.export_params(out, "vit", ds.shape, ds.num_classes, state)
    p = JaxPredictor(out, name="vit", max_batch_size=4, device="cpu")
    p.load()
    xe, _ = get_dataset("mnist", split="eval").eval_arrays(16)
    preds = np.asarray(p.predict(xe)["predictions"])
    with torch.no_grad():
        direct = state.model(torch.from_numpy(xe)).argmax(-1).numpy()
    assert np.array_equal(preds, direct)


def test_metrics_prometheus_and_json(server):
    base = f"http://127.0.0.1:{server.port}"
    with urllib.request.urlopen(f"{base}/metrics", timeout=10) as r:
        text = r.read().decode()
        assert r.headers["Content-Type"].startswith("text/plain")
    assert "# TYPE kfx_serving_requests_total counter" in text
    assert "kfx_serving_models 1" in text
    assert "kfx_serving_models_ready 1" in text
    status, body = _get(f"{base}/metrics?format=json")
    assert status == 200 and body["models"] == ["mnist"]


# -- TestMicroBatcher (tests/test_serving.py) ------------------------------

@pytest.fixture
def predictor(export_dir):
    p = JaxPredictor(export_dir, name="m", max_batch_size=32, device="cpu")
    p.load()
    return p


def _threads(fn, n):
    ts = [threading.Thread(target=fn, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)


def test_concurrent_requests_batched(predictor):
    calls = []
    orig = predictor.predict

    def spy(instances, probabilities=False):
        calls.append(instances.shape[0])
        return orig(instances, probabilities=probabilities)

    predictor.predict = spy
    batcher = MicroBatcher(predictor, max_batch_size=32, max_latency_ms=50.0)
    images, _ = get_dataset("mnist", split="eval").eval_arrays(8)
    results = [None] * 8

    def hit(i):
        results[i] = batcher.predict(images[i:i + 1], probabilities=i % 2)

    _threads(hit, 8)
    batcher.close()
    assert len(calls) < 8 and sum(calls) == 8   # fewer dispatches
    want = orig(images, probabilities=True)
    for i, r in enumerate(results):
        assert r["predictions"] == want["predictions"][i:i + 1]
        assert ("probabilities" in r) == bool(i % 2)


def test_bad_shape_does_not_kill_batcher(predictor):
    batcher = MicroBatcher(predictor, max_batch_size=8, max_latency_ms=1.0,
                           reply_timeout_s=10.0)
    try:
        with pytest.raises(ValueError):
            batcher.predict(np.zeros((1, 7, 7, 1), np.float32))
        out = batcher.predict(np.zeros((2, 28, 28, 1), np.float32))
        assert len(out["predictions"]) == 2
    finally:
        batcher.close()


def test_pipelined_workers_serve_all_requests(predictor):
    batcher = MicroBatcher(predictor, max_batch_size=8, max_latency_ms=2.0,
                           workers=2)
    results = [None] * 24

    def hit(i):
        n = 1 + (i % 3)
        results[i] = (n, batcher.predict(
            np.zeros((n, 28, 28, 1), np.float32)))

    _threads(hit, 24)
    batcher.close()
    assert all(r is not None and len(r[1]["predictions"]) == r[0]
               for r in results), results


def test_close_joins_workers_and_drains_queue():
    class Slow(Predictor):
        name = "slow"
        ready = True

        def load(self):
            pass

        def predict(self, instances, probabilities=False):
            time.sleep(0.3)
            return {"predictions": [0] * instances.shape[0]}

    batcher = MicroBatcher(Slow(), max_batch_size=1, max_latency_ms=1.0,
                           reply_timeout_s=60.0)
    outcomes = {}

    def hit(tag):
        try:
            outcomes[tag] = batcher.predict(np.zeros((1, 2), np.float32))
        except Exception as e:
            outcomes[tag] = e

    t1 = threading.Thread(target=hit, args=("inflight",))
    t1.start()
    time.sleep(0.1)   # the worker is inside the slow predict
    t2 = threading.Thread(target=hit, args=("queued",))
    t2.start()
    time.sleep(0.1)   # the second request waits on the queue
    t0 = time.monotonic()
    batcher.close()
    t1.join(timeout=10)
    t2.join(timeout=10)
    assert not t1.is_alive() and not t2.is_alive()
    assert time.monotonic() - t0 < 10
    assert outcomes["inflight"] == {"predictions": [0]}
    assert isinstance(outcomes["queued"], RuntimeError)
    with pytest.raises(RuntimeError):
        batcher.predict(np.zeros((1, 2), np.float32))


def test_non_pow2_max_batch_is_a_bucket(export_dir):
    p = JaxPredictor(export_dir, name="m", max_batch_size=48, device="cpu")
    p.load()
    assert p._buckets == [1, 2, 4, 8, 16, 32, 48]
    out = p.predict(np.zeros((48, 28, 28, 1), np.float32))
    assert len(out["predictions"]) == 48


def test_server_with_batcher(export_dir):
    """register(predictor, batcher): concurrent single-image :predict
    requests are batched and answer what the predictor answers for the
    stacked batch."""
    p = JaxPredictor(export_dir, name="mnist", max_batch_size=16,
                     device="cpu")
    p.load()
    srv = ModelServer(port=0)
    srv.register(p, {"maxBatchSize": 16, "maxLatencyMs": 20.0})
    srv.start()
    try:
        images, _ = get_dataset("mnist", split="eval").eval_arrays(12)
        url = f"http://127.0.0.1:{srv.port}/v1/models/mnist:predict"
        got = [None] * 12

        def hit(i):
            got[i] = _post(url, {"instances": images[i:i + 1].tolist()})

        _threads(hit, 12)
        want = p.predict(images)["predictions"]
        assert [g[1]["predictions"][0] for g in got] == want
        assert all(g[0] == 200 for g in got)
    finally:
        srv.stop()
    assert all(not t.is_alive() for t in srv.batchers["mnist"]._threads)


def test_predictor_defaults_to_cuda(export_dir):
    p = JaxPredictor(export_dir, device="auto")
    assert p.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            p.load()
        assert not p.ready


# -- main ------------------------------------------------------------------

def _serve(model_dir, *extra):
    """Start ``python -m kubeflow_tpu_torch.serving.server`` on the CPU;
    returns (process, its server_ready line)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.serving.server",
         "--model-dir", model_dir, "--port", "0", "--device", "cpu",
         *extra], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env, cwd=REPO)
    deadline = time.monotonic() + 120
    line = ""
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if line.startswith("server_ready") or not line:
            break
    return proc, line


def _fields(line):
    """key=value fields of a server_ready line (JSON values may hold
    spaces, as the reference prints them)."""
    return dict(re.findall(r"(\w+)=(\{[^}]*\}|\S+)", line))


def test_main_serves_a_classifier_export(export_dir):
    proc, line = _serve(export_dir, "--batcher-max-latency-ms", "5")
    try:
        assert line.startswith("server_ready"), proc.stderr.read()
        f = _fields(line)
        assert f["framework"] == "jax" and f["device"] == "cpu"
        assert json.loads(f["placement"]) == {
            str(b): "cpu" for b in (1, 2, 4, 8, 16, 32, 64)}
        assert set(json.loads(f["probe_ms"])) == {"cpu"}
        x = np.zeros((2, 28, 28, 1)).tolist()
        status, body = _post(
            f"http://127.0.0.1:{f['port']}/v1/models/model:predict",
            {"instances": x})
        assert status == 200 and len(body["predictions"]) == 2
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_main_serves_an_lm_export(tmp_path):
    from kubeflow_tpu_torch.models.convert import params_to_jax
    from kubeflow_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM)
    from kubeflow_tpu_torch.serving.lm_server import export_lm

    cfg = TransformerConfig(vocab_size=64, d_model=32, n_heads=2,
                            head_dim=16, n_layers=1, d_ff=64,
                            max_seq_len=64, dtype="float32")
    model = TransformerLM(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    out = str(tmp_path / "lm")
    export_lm(out, cfg, params_to_jax(model.state_dict()))
    proc, line = _serve(out)
    try:
        assert line.startswith("server_ready"), proc.stderr.read()
        f = _fields(line)
        assert f["framework"] == "lm" and f["engine"] == "on"
        status, body = _post(
            f"http://127.0.0.1:{f['port']}/v1/models/model:generate",
            {"prompt_tokens": [[5, 9, 11]], "max_new_tokens": 4})
        assert status == 200 and len(body["generated_tokens"][0]) == 4
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_main_refuses_unported_frameworks(export_dir, tmp_path, capsys):
    for fw in ("pytorch", "tensorflow", "sklearn"):
        assert port_server.main(["--model-dir", export_dir,
                                 "--framework", fw]) == 2
        assert "Queue A 9" in capsys.readouterr().err
    assert port_server.main(["--model-dir", str(tmp_path)]) == 2
    assert "holds no export" in capsys.readouterr().err
