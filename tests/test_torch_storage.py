"""The port's storage initializer (kubeflow_tpu_torch/serving/storage.py)
against the reference's (kubeflow_tpu/serving/storage.py):
tests/test_storage.py's TestStorageInitializer rerun with both modules on
the same URI, each case asserting that the port resolves what the
reference resolves (the same local path, the same cache layout, so each
package reuses the other's downloads), over a local HTTP server; and an
LM export fetched over HTTP, loaded by both packages' ``load_lm``."""

import functools
import http.server
import os
import shutil
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.serving import storage as ref  # noqa: E402
from kubeflow_tpu_torch.serving import storage as port  # noqa: E402


@pytest.fixture(scope="module")
def export_dir(tmp_path_factory):
    """A minimal (untrained) classifier export, as tests/test_storage.py
    makes it."""
    from kubeflow_tpu.data import get_dataset
    from kubeflow_tpu.models import get_model
    from kubeflow_tpu.serving.export import export_params
    from kubeflow_tpu.training import TrainLoop

    out = tmp_path_factory.mktemp("export")
    ds = get_dataset("mnist")
    model = get_model("mlp", num_classes=ds.num_classes)
    state = TrainLoop(model).init_state(ds.shape)
    export_params(str(out), "mlp", ds.shape, ds.num_classes, state)
    return str(out)


def _serve(root):
    """A local HTTP server over ``root``: (server, base URL, request
    log)."""
    requests = []

    class Handler(http.server.SimpleHTTPRequestHandler):
        def log_message(self, fmt, *args):
            requests.append(self.path)

    srv = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0), functools.partial(Handler, directory=str(root)))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}", requests


@pytest.fixture()
def http_root(export_dir, tmp_path):
    """<root>/models/mnist/ == the export over local HTTP; yields (base
    URL, request log)."""
    dest = tmp_path / "webroot" / "models" / "mnist"
    dest.parent.mkdir(parents=True)
    shutil.copytree(export_dir, dest)
    srv, base, requests = _serve(tmp_path / "webroot")
    yield base, requests
    srv.shutdown()


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


class TestStorageInitializer:
    def test_local_passthrough(self, tmp_path):
        cache = str(tmp_path / "cache")
        for uri in ("/some/dir", "file:///some/dir"):
            assert port.initialize(uri, cache) == ref.initialize(
                uri, cache) == "/some/dir"
        assert port.supported_schemes() == ref.supported_schemes()
        assert port.EXPORT_FORMATS == ref.EXPORT_FORMATS

    def test_pvc_root(self, tmp_path, monkeypatch):
        monkeypatch.setenv("KFX_PVC_ROOT", str(tmp_path / "vols"))
        uri, cache = "pvc://models/mnist/v3", str(tmp_path / "c")
        got = port.initialize(uri, cache)
        assert got == ref.initialize(uri, cache) == str(
            tmp_path / "vols" / "models" / "mnist" / "v3")

    def test_unknown_scheme(self, tmp_path):
        msgs = []
        for mod in (ref, port):
            with pytest.raises(ValueError,
                               match="unsupported storageUri") as e:
                mod.initialize("ftp://host/model", str(tmp_path))
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]

    def test_http_download_and_cache(self, http_root, tmp_path):
        """The port downloads the export once into the reference's cache
        layout (same digest directory, same bytes); the reference's
        initialize on the port's cache, and the port's second call, hit
        it without a request."""
        from kubeflow_tpu.serving.export import load_exported as ref_load
        from kubeflow_tpu_torch.serving.export import load_exported

        base, requests = http_root
        uri = f"{base}/models/mnist"
        local = port.initialize(uri, str(tmp_path / "cache"))
        want = ref.initialize(uri, str(tmp_path / "ref_cache"))
        assert os.path.relpath(local, str(tmp_path / "cache")) == \
            os.path.relpath(want, str(tmp_path / "ref_cache"))
        assert sorted(os.listdir(local)) == ["config.json",
                                             "params.msgpack"]
        assert _files(local) == _files(want)
        config, payload = load_exported(local)
        assert config == ref_load(want)[0] and "params" in payload
        for fname in ("config.json", "params.msgpack"):
            assert requests.count(f"/models/mnist/{fname}") == 2
        n = len(requests)
        assert port.initialize(uri, str(tmp_path / "cache")) == local
        assert ref.initialize(uri, str(tmp_path / "cache")) == local
        assert len(requests) == n

    def test_http_partial_download_not_cached(self, http_root, tmp_path):
        base, _ = http_root
        for mod, name in ((ref, "ref"), (port, "port")):
            cache = str(tmp_path / name)
            with pytest.raises(Exception) as e:
                mod.initialize(f"{base}/models/ghost", cache)  # 404
            assert "no known export format" in str(e.value)
            visible = [d for d in os.listdir(cache)
                       if not d.startswith(".")] \
                if os.path.isdir(cache) else []
            assert visible == []

    def test_s3_endpoint_override(self, http_root, tmp_path, monkeypatch):
        base, _ = http_root
        monkeypatch.setenv("KFX_S3_ENDPOINT", base)
        got = port.initialize("s3://models/mnist", str(tmp_path / "c"))
        want = ref.initialize("s3://models/mnist", str(tmp_path / "r"))
        assert os.path.basename(got) == os.path.basename(want)
        assert _files(got) == _files(want)

    def test_gs_url_construction(self, monkeypatch, tmp_path):
        seen = {}
        for mod, name in ((ref, "ref"), (port, "port")):
            monkeypatch.setattr(
                mod, "_http", lambda uri, cache, n=name:
                seen.setdefault(n, uri) or "/x")
            mod.initialize("gs://my-bucket/models/resnet", str(tmp_path))
        assert seen["port"] == seen["ref"] == \
            "https://storage.googleapis.com/my-bucket/models/resnet"


def test_lm_export_over_http(tmp_path):
    """An LM export (the reference's tiny preset, written by its
    export_lm) fetched over HTTP by the port's initializer: the port's
    load_lm of the download equals the reference's load_lm of it, leaf
    for leaf and byte for byte."""
    from kubeflow_tpu.models.transformer import TransformerLM, preset_config
    from kubeflow_tpu.serving.lm_server import export_lm
    from kubeflow_tpu.serving.lm_server import load_lm as ref_load_lm
    from kubeflow_tpu_torch.serving.lm_server import is_lm_export, load_lm

    cfg = preset_config("tiny", max_seq_len=64)
    params = TransformerLM(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    root = tmp_path / "web" / "lm"
    root.mkdir(parents=True)
    export_lm(str(root), cfg, params)
    srv, base, _ = _serve(tmp_path / "web")
    try:
        local = port.initialize(f"{base}/lm", str(tmp_path / "cache"))
    finally:
        srv.shutdown()
    assert is_lm_export(local)
    assert sorted(os.listdir(local)) == ["lm_config.json", "params.msgpack"]
    cfg_p, got = load_lm(local)
    cfg_r, want = ref_load_lm(local)
    assert (cfg_p.d_model, cfg_p.n_layers, cfg_p.vocab_size) == \
        (cfg_r.d_model, cfg_r.n_layers, cfg_r.vocab_size)
    flat_p = jax.tree_util.tree_leaves_with_path(got)
    flat_r = jax.tree_util.tree_leaves_with_path(want)
    assert [jax.tree_util.keystr(p) for p, _ in flat_p] == \
        [jax.tree_util.keystr(p) for p, _ in flat_r]
    for (path, a), (_, b) in zip(flat_p, flat_r):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), path
