"""The port's apiserver (kubeflow_tpu_torch/apiserver.py) and the CLI's
client mode against the reference's.

The reference's own tests run against the port through ``_torch_ported``:
tests/test_apiserver.py (the REST API, the ``KFX_SERVER`` client, the
notebook spawner, kfam, authz, the dashboard and the owned-home routing)
and tests/test_obs.py TestApiServerMetrics (``/metrics`` through
scripts/scrape_metrics.py). Their planes pin the workers to the CPU
(``worker_platform="cpu"``), as the reference's fixtures do.

Beside them, one request sequence goes to the reference's ``ApiServer``
and to the port's, each over its own plane and home: ``/healthz``,
``/apis``, an apply, list, get, events and logs of a job that runs to
Succeeded, the error cases of ``test_errors``, the kfam bindings of an
admin-applied Profile, a 403 and a 503 (a ``store.read`` chaos fault).
The status codes must be equal, and the JSON bodies equal once uids,
timestamps, trace and span IDs, minted tokens and the home are
normalized. ``parse_label_selector`` is held to the reference's on a
numpy-seeded set of selectors.
"""

import json
import os
import re
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

pytest.importorskip("jax")

from _torch_ported import ported  # noqa: E402

from kubeflow_tpu import apiserver as ref_api  # noqa: E402
from kubeflow_tpu import chaos as ref_chaos  # noqa: E402
from kubeflow_tpu import controlplane as ref_cp  # noqa: E402
from kubeflow_tpu_torch import apiserver as port_api  # noqa: E402
from kubeflow_tpu_torch import chaos as port_chaos  # noqa: E402
from kubeflow_tpu_torch import controlplane as port_cp  # noqa: E402

_ref_tests = ported("test_apiserver.py")
_obs = ported("test_obs.py")
server = _ref_tests.server

PY = sys.executable


class TestRestApi(_ref_tests.TestRestApi):
    pass


class TestClientMode(_ref_tests.TestClientMode):
    pass


class TestNotebookSpawner(_ref_tests.TestNotebookSpawner):
    pass


class TestKfam(_ref_tests.TestKfam):
    pass


class TestAuthz(_ref_tests.TestAuthz):
    pass


class TestDashboard(_ref_tests.TestDashboard):
    pass


class TestOwnedHomeRouting(_ref_tests.TestOwnedHomeRouting):
    pass


class TestApiServerMetrics(_obs.TestApiServerMetrics):
    def test_train_mfu_bridged_and_require_scrapeable(self, server):
        """The reference's case on the port's LMTrainLoop (its signature:
        cfg, hp, device): kfx_train_step_seconds{job,config} is recorded
        live into the process registry, bridged onto the plane's
        /metrics and pinned by `scrape_metrics --require`. kfx_train_mfu
        is registered there too, but holds a sample only on a CUDA device:
        the port computes no MFU on the CPU."""
        sys.path.insert(0, os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "scripts"))
        import scrape_metrics

        from kubeflow_tpu_torch.data.lm import LMDataset
        from kubeflow_tpu_torch.models.transformer import TransformerConfig
        from kubeflow_tpu_torch.parallel.lm_train import (
            LMHyperParams,
            LMTrainLoop,
        )
        from kubeflow_tpu_torch.utils.prom import validate_exposition

        cfg = TransformerConfig(vocab_size=64, d_model=16, n_heads=2,
                                head_dim=8, n_layers=1, d_ff=32,
                                max_seq_len=16)
        loop = LMTrainLoop(cfg, LMHyperParams(total_steps=4,
                                              warmup_steps=1), "cpu")
        loop.init_state()
        it = LMDataset(vocab_size=64, seq_len=16).batches(4)
        loop.train_many([next(it)])  # the warm-up call, not timed
        loop.train_many([next(it)])  # the recorded call

        assert scrape_metrics.main(
            [f"{server.url}/metrics",
             "--require", "kfx_train_step_seconds"]) == 0
        with urllib.request.urlopen(f"{server.url}/metrics",
                                    timeout=10) as r:
            text = r.read().decode()
        assert validate_exposition(text) == []
        assert "kfx_train_step_seconds_bucket{" in text
        assert 'job="local"' in text
        assert 'config="pp1/dp1/cp1/tp1-d16L1"' in text
        assert "# TYPE kfx_train_mfu gauge" in text
        assert "kfx_train_mfu{" not in text


JOB = f"""
apiVersion: kubeflow.org/v1
kind: JAXJob
metadata:
  name: side-job
spec:
  jaxReplicaSpecs:
    Worker:
      replicas: 1
      restartPolicy: Never
      template:
        spec:
          containers:
          - name: main
            command: ["{PY}", "-c", "print('side by side')"]
"""

PROFILE = """
apiVersion: kubeflow.org/v1
kind: Profile
metadata:
  name: team-s
spec:
  owner:
    kind: User
    name: alice@example.com
"""

IN_PROFILE = """
apiVersion: kubeflow.org/v1
kind: JAXJob
metadata:
  name: blocked
  namespace: team-s
spec:
  runPolicy: {suspend: true}
  jaxReplicaSpecs:
    Worker:
      replicas: 1
      template:
        spec:
          containers:
          - name: main
            command: ["true"]
"""

# Values that differ between any two runs of one package.
_VOLATILE = {"uid", "creationTimestamp", "timestamp", "lastTransitionTime",
             "lastUpdateTime", "startTime", "completionTime", "traceId",
             "spanId", "token", "kubeflow.org/trace-id",
             "kubeflow.org/span-id"}


def _normalize(x, home):
    if isinstance(x, dict):
        return {k: (f"<{k}>" if k in _VOLATILE
                    else {u: "<token>" for u in v} if k == "issuedTokens"
                    else _normalize(v, home)) for k, v in x.items()}
    if isinstance(x, list):
        return [_normalize(v, home) for v in x]
    if isinstance(x, str):
        # A log's attempt header stamps its time and trace ID.
        x = re.sub(r"\d{4}-\d\d-\d\dT[0-9:.]+Z?", "<time>", x)
        return re.sub(r"trace=[0-9a-f]+", "trace=<id>",
                      x.replace(home, "<home>"))
    return x


def _call(url, data=None, method="GET", headers=None):
    req = urllib.request.Request(url, data=data, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read().decode(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), dict(e.headers)


def _poll(fn, what, timeout=60):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = fn()
        if out:
            return out
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


def _sequence(api, cp_mod, chaos, home):
    """The request sequence against one package's server; (code, body)
    pairs, the bodies parsed where they are JSON and normalized."""
    out = []
    with cp_mod.ControlPlane(home=home, worker_platform="cpu") as cp:
        with api.ApiServer(cp, port=0) as srv:
            u = srv.url
            real = os.path.realpath(cp.home)
            admin = {api.ADMIN_HEADER: srv.admin_token}

            def rec(code, body, headers=None, keep=()):
                try:
                    body = json.loads(body)
                except ValueError:
                    pass
                extra = {k: (headers or {}).get(k) for k in keep}
                out.append((code, _normalize(body, real),
                            _normalize(extra, real)))
                return body

            rec(*_call(f"{u}/healthz"), keep=("X-Kfx-Home",))
            rec(*_call(f"{u}/version")[:2])
            rec(*_call(f"{u}/apis")[:2])
            rec(*_call(f"{u}/apis", JOB.encode(), "POST")[:2])

            def succeeded():
                code, body, _ = _call(f"{u}/apis/jaxjob/default/side-job")
                conds = {c["type"]: c["status"] for c in
                         json.loads(body).get("status", {}).get(
                             "conditions", [])}
                return conds.get("Succeeded") == "True"

            _poll(succeeded, "side-job Succeeded")
            # The gang's last status write may trail the condition.
            time.sleep(0.5)
            rec(*_call(f"{u}/apis/jaxjobs?namespace=default")[:2])
            rec(*_call(f"{u}/apis/jaxjob/default/side-job")[:2])
            rec(*_call(f"{u}/apis/jaxjob/default/side-job/events")[:2])
            rec(*_call(f"{u}/apis/jaxjob/default/side-job/logs")[:2])
            # test_errors' cases: unknown kind, absent object, no route,
            # a bad and a negative offset, an invalid manifest.
            rec(*_call(f"{u}/apis/nosuchkind")[:2])
            rec(*_call(f"{u}/apis/jaxjob/default/ghost")[:2])
            rec(*_call(f"{u}/nope")[:2])
            rec(*_call(f"{u}/apis/jaxjob/default/side-job/logs?offset=xyz")
                [:2])
            rec(*_call(f"{u}/apis/jaxjob/default/side-job/logs?offset=-5")
                [:2])
            rec(*_call(f"{u}/apis", b"apiVersion: v1\nkind: JAXJob\n",
                       "POST")[:2])
            # kfam: the admin-applied Profile mints its owner's token; the
            # owner binds bob.
            applied = rec(*_call(f"{u}/apis", PROFILE.encode(), "POST",
                                 admin)[:2])
            alice = {api.USER_HEADER: "alice@example.com",
                     api.USER_TOKEN_HEADER:
                         applied["issuedTokens"]["alice@example.com"]}
            _poll(lambda: json.loads(_call(
                f"{u}/kfam/v1/bindings?namespace=team-s")[1])["bindings"],
                "the owner's binding")
            rec(*_call(f"{u}/kfam/v1/bindings?namespace=team-s")[:2])
            rec(*_call(f"{u}/kfam/v1/bindings", json.dumps(
                {"namespace": "team-s", "user": "bob@example.com",
                 "role": "edit"}).encode(), "POST", alice)[:2])
            _poll(lambda: len(json.loads(_call(
                f"{u}/kfam/v1/bindings?namespace=team-s")[1])[
                    "bindings"]) == 2, "bob's binding")
            rec(*_call(f"{u}/kfam/v1/bindings?namespace=team-s")[:2])
            # 403: an anonymous write into the profile's namespace.
            rec(*_call(f"{u}/apis", IN_PROFILE.encode(), "POST")[:2])
            # 503: one storage fault, then the retry the header promised.
            chaos.install(chaos.parse_spec("store.read:count=1"))
            try:
                rec(*_call(f"{u}/apis/jaxjob"), keep=("Retry-After",))
            finally:
                chaos.reset()
            rec(*_call(f"{u}/apis/jaxjob/default/side-job", method="DELETE")
                [:2])
            rec(*_call(f"{u}/apis/jaxjob/default/side-job")[:2])
    return out


class TestBothPackages:
    def test_same_requests_same_answers(self, tmp_path):
        want = _sequence(ref_api, ref_cp, ref_chaos, str(tmp_path / "ref"))
        got = _sequence(port_api, port_cp, port_chaos,
                        str(tmp_path / "port"))
        codes = [c for c, _, _ in want]
        assert codes == [200, 200, 200, 200, 200, 200, 200, 200, 404, 404,
                         404, 400, 400, 400, 200, 200, 200, 200, 403, 503,
                         200, 404]
        assert [c for c, _, _ in got] == codes
        for i, (g, w) in enumerate(zip(got, want)):
            assert g == w, i
        assert want[0][2] == {"X-Kfx-Home": "<home>"}
        assert want[19][2] == {"Retry-After": "1"}

    def test_parse_label_selector_equal(self):
        rng = np.random.default_rng(19)
        alphabet = list("ab=, k1v") + ["", "==", " = "]
        for _ in range(400):
            text = "".join(rng.choice(alphabet, size=int(rng.integers(
                0, 12))))
            try:
                want = ref_api.parse_label_selector(text)
            except ValueError as e:
                with pytest.raises(ValueError) as got:
                    port_api.parse_label_selector(text)
                assert str(got.value) == str(e)
            else:
                assert port_api.parse_label_selector(text) == want
