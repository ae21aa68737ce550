"""The port's other framework predictors (kubeflow_tpu_torch/serving:
torch_server, sklearn_server, tf_server) against the reference's
(tests/test_serving.py TestTorchServing, TestSKLearnServing,
TestTFServing; tests/test_storage.py's framework cases), and the port
server's ``--framework auto`` sniffing over HTTP.

Tolerances: the two TorchPredictors run the same TorchScript module with
the same torch ops on the same host, so predictions are equal and
probabilities agree within 1e-6; a traced port classifier served by
TorchPredictor equals the classifier's own forward on the same host within
1e-6. scikit-learn and TensorFlow run on the host in both packages, and
the port's predictors are the reference's code, so their answers are
equal."""

import functools
import http.server
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from kubeflow_tpu.serving import sklearn_server as ref_sk  # noqa: E402
from kubeflow_tpu.serving import torch_server as ref_pt  # noqa: E402
from kubeflow_tpu_torch.serving import sklearn_server as port_sk  # noqa: E402
from kubeflow_tpu_torch.serving import tf_server as port_tf  # noqa: E402
from kubeflow_tpu_torch.serving import torch_server as port_pt  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _seq():
    """tests/test_serving.py's TorchScript module."""
    torch.manual_seed(0)
    return torch.nn.Sequential(
        torch.nn.Flatten(), torch.nn.Linear(16, 8), torch.nn.ReLU(),
        torch.nn.Linear(8, 3))


@pytest.fixture(scope="module")
def torch_exports(tmp_path_factory):
    """The same module exported by each package's export_torchscript."""
    module = _seq()
    out = {}
    for name, mod in (("ref", ref_pt), ("port", port_pt)):
        d = str(tmp_path_factory.mktemp(f"torch-{name}"))
        mod.export_torchscript(d, module, input_shape=(4, 4), num_classes=3)
        out[name] = d
    return out


@pytest.mark.parametrize("exporter", ["ref", "port"])
def test_torch_predictors_agree(torch_exports, exporter):
    path = torch_exports[exporter]
    assert port_pt.is_torch_export(path) and ref_pt.is_torch_export(path)
    ref = ref_pt.TorchPredictor(path, name="t")
    port = port_pt.TorchPredictor(path, name="t", device="cpu",
                                  max_batch_size=4)
    ref.load()
    port.load()
    assert port.ready and port.input_shape == ref.input_shape == (4, 4)
    assert port.num_classes == 3 and port.device == "cpu"
    x = np.random.default_rng(0).normal(size=(10, 4, 4)).astype(np.float32)
    want = ref.predict(x, probabilities=True)
    got = port.predict(x, probabilities=True)
    assert got["predictions"] == want["predictions"]
    assert np.abs(np.asarray(got["probabilities"])
                  - np.asarray(want["probabilities"])).max() <= 1e-6
    assert port.predict(x) == {"predictions": want["predictions"]}


def test_torch_predictor_defaults_to_cuda(torch_exports):
    p = port_pt.TorchPredictor(torch_exports["port"], device="auto")
    assert p.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            p.load()
        assert not p.ready


def test_traced_classifier_serves_its_forward(tmp_path):
    """The (o1) path at test width: a port classifier traced on one batch
    size (export_torchscript with example_inputs) serves other batch
    sizes with the classifier's own eval forward."""
    from kubeflow_tpu_torch.models import get_model

    model = get_model("resnet18", input_shape=(32, 32, 3),
                      dtype=torch.float32, seed=3).eval()
    x = np.random.default_rng(1).uniform(0, 1, (7, 32, 32, 3)).astype(
        np.float32)
    with torch.no_grad():
        port_pt.export_torchscript(str(tmp_path), model,
                                   input_shape=(32, 32, 3), num_classes=10,
                                   example_inputs=torch.zeros(1, 32, 32, 3))
        logits = model(torch.from_numpy(x))
    p = port_pt.TorchPredictor(str(tmp_path), device="cpu", max_batch_size=4)
    p.load()
    got = p.predict(x, probabilities=True)
    assert got["predictions"] == logits.argmax(-1).tolist()
    assert np.abs(np.asarray(got["probabilities"])
                  - torch.softmax(logits, -1).numpy()).max() <= 1e-6


@pytest.fixture(scope="module")
def sklearn_export(tmp_path_factory):
    from sklearn.linear_model import LogisticRegression

    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 2, 3))
    y = (x.reshape(64, -1).sum(-1) > 0).astype(int) + (x[:, 0, 0] > 1)
    est = LogisticRegression(max_iter=200).fit(x.reshape(64, -1), y)
    d = str(tmp_path_factory.mktemp("sk"))
    port_sk.export_sklearn(d, est, input_shape=(2, 3), num_classes=3)
    return d


def test_sklearn_predictors_agree(sklearn_export):
    ref = ref_sk.SKLearnPredictor(sklearn_export, max_batch_size=8)
    port = port_sk.SKLearnPredictor(sklearn_export, max_batch_size=8)
    ref.load()
    port.load()
    assert port.ready and port.input_shape == ref.input_shape == (2, 3)
    assert port.device == "cpu"
    x = np.random.default_rng(1).normal(size=(20, 2, 3))
    assert port.predict(x, probabilities=True) == ref.predict(
        x, probabilities=True)
    assert port.predict(x) == ref.predict(x)
    empty = np.zeros((0, 2, 3))
    assert port.predict(empty, probabilities=True) == ref.predict(
        empty, probabilities=True) == {"predictions": [],
                                       "probabilities": []}


def test_sklearn_without_predict_proba_raises(tmp_path):
    from sklearn.svm import LinearSVC

    rng = np.random.default_rng(0)
    est = LinearSVC().fit(rng.normal(size=(16, 4)), np.array([0, 1] * 8))
    port_sk.export_sklearn(str(tmp_path), est, input_shape=(4,),
                           num_classes=2)
    for mod in (ref_sk, port_sk):
        p = mod.SKLearnPredictor(str(tmp_path))
        p.load()
        x = rng.normal(size=(3, 4))
        assert len(p.predict(x)["predictions"]) == 3
        with pytest.raises(ValueError, match="no predict_proba"):
            p.predict(x, probabilities=True)


@pytest.fixture(scope="module")
def tf_export(tmp_path_factory):
    """The reference's export_savedmodel of a JAX mlp trained 10 steps
    (tests/test_serving.py TestTFServing)."""
    pytest.importorskip("tensorflow")
    from kubeflow_tpu.data import get_dataset
    from kubeflow_tpu.models import get_model
    from kubeflow_tpu.serving.tf_server import export_savedmodel
    from kubeflow_tpu.training import TrainLoop

    ds = get_dataset("mnist")
    model = get_model("mlp", num_classes=ds.num_classes)
    loop = TrainLoop(model)
    state = loop.init_state(ds.shape)
    for images, labels in ds.batches(128, steps=10):
        state, *_ = loop.train_step(state, images, labels)
    out = str(tmp_path_factory.mktemp("tf-export"))
    export_savedmodel(out, "mlp", ds.shape, ds.num_classes, state)
    return out, state, model


def test_tf_predictors_agree_and_match_jax(tf_export):
    from kubeflow_tpu.serving.tf_server import TFPredictor as RefTF

    path, state, model = tf_export
    assert port_tf.is_tf_export(path)
    ref = RefTF(path, name="tfm")
    port = port_tf.TFPredictor(path, name="tfm")
    ref.load()
    port.load()
    assert port.ready and port.input_shape == ref.input_shape == (28, 28, 1)
    assert port.device == "cpu"
    x = np.random.default_rng(0).normal(size=(5, 28, 28, 1)).astype(
        np.float32)
    got = port.predict(x, probabilities=True)
    assert got == ref.predict(x, probabilities=True)
    jax_logits = model.apply({"params": state.params}, jnp.asarray(x),
                             train=False)
    assert got["predictions"] == np.asarray(jax_logits).argmax(-1).tolist()


def test_port_export_savedmodel_names_its_queue_item(tmp_path):
    with pytest.raises(NotImplementedError, match="Queue A 9b"):
        port_tf.export_savedmodel(str(tmp_path), "mlp", (28, 28, 1), 10,
                                  None)


# -- the server's --framework auto, over HTTP --------------------------------

def _post(url, payload, timeout=60):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.load(resp)


def serve(model_dir, *extra):
    """Start ``python -m kubeflow_tpu_torch.serving.server`` on the CPU;
    returns (process, its server_ready line, the key=value fields)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.serving.server",
         "--model-dir", model_dir, "--port", "0", "--device", "cpu",
         *extra], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env, cwd=REPO)
    deadline = time.monotonic() + 180
    line = ""
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if line.startswith("server_ready") or not line:
            break
    return proc, line, dict(re.findall(r"(\w+)=(\{[^}]*\}|\S+)", line))


@pytest.mark.parametrize("fw", ["pytorch", "tensorflow", "sklearn"])
def test_server_auto_sniffs_and_predicts(fw, torch_exports, sklearn_export,
                                         request):
    path, shape = {
        "pytorch": lambda: (torch_exports["port"], (4, 4)),
        "tensorflow": lambda: (request.getfixturevalue("tf_export")[0],
                               (28, 28, 1)),
        "sklearn": lambda: (sklearn_export, (2, 3)),
    }[fw]()
    proc, line, f = serve(path)
    try:
        assert line.startswith("server_ready"), proc.stderr.read()
        assert f["framework"] == fw and f["device"] == "cpu"
        x = np.random.default_rng(2).normal(size=(3,) + shape)
        status, body = _post(
            f"http://127.0.0.1:{f['port']}/v1/models/model:predict",
            {"instances": x.tolist(), "probabilities": True})
        assert status == 200 and len(body["predictions"]) == 3
        assert np.allclose(np.sum(body["probabilities"], -1), 1.0,
                           atol=1e-5)
    finally:
        proc.terminate()
        proc.wait(timeout=30)


# -- the storage initializer over HTTP (tests/test_storage.py) ---------------

@pytest.fixture()
def web(tmp_path):
    class Handler(http.server.SimpleHTTPRequestHandler):
        def log_message(self, *a):
            pass

    root = tmp_path / "web"
    root.mkdir()
    srv = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0), functools.partial(Handler, directory=str(root)))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield root, f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def test_port_torch_export_over_http(web, tmp_path):
    from kubeflow_tpu_torch.serving.storage import initialize

    root, base = web
    port_pt.export_torchscript(str(root / "torchy"), _seq(),
                               input_shape=(4, 4), num_classes=3)
    local = initialize(f"{base}/torchy", str(tmp_path / "cache"))
    assert port_pt.is_torch_export(local)
    assert sorted(os.listdir(local)) == ["config.json", "model.pt"]
    p = port_pt.TorchPredictor(local, device="cpu")
    p.load()
    assert p.input_shape == (4, 4)


def test_port_sklearn_export_over_http(web, tmp_path, sklearn_export):
    import shutil

    from kubeflow_tpu_torch.serving.storage import initialize

    root, base = web
    shutil.copytree(sklearn_export, root / "sk")
    local = initialize(f"{base}/sk", str(tmp_path / "cache"))
    assert port_sk.is_sklearn_export(local)
    assert sorted(os.listdir(local)) == ["config.json", "model.joblib"]
    p = port_sk.SKLearnPredictor(local)
    p.load()
    assert p.input_shape == (2, 3)
