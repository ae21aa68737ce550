"""The port's kfctl (kubeflow_tpu_torch/kfctl.py) and the CLI verbs over it
(`kfx init`, `generate`, `run`/`delete -f` of a KfDef) against the
reference's.

The reference's own tests (tests/test_kfctl.py TestRender and
TestKfxVerbs) run against the port through ``_torch_ported``; their JAXJob
is a plain ``python -c`` worker, so it runs here with the plane's default
device pin. Beside them, one KfDef with applications by ``path`` and by
``resource``, parameters, a patch and ``commonLabels`` goes through both
packages: ``render_kfdef``, ``expand_manifest_text``, ``generate`` (the
names and bytes of the files) and ``init_scaffold`` must be equal, exactly.
"""

import os

import pytest
import yaml

pytest.importorskip("jax")

from _torch_ported import ported  # noqa: E402

from kubeflow_tpu import kfctl as ref  # noqa: E402
from kubeflow_tpu_torch import kfctl as port  # noqa: E402

_ref_tests = ported("test_kfctl.py")
kfdef_dir = _ref_tests.kfdef_dir


class TestRender(_ref_tests.TestRender):
    pass


class TestKfxVerbs(_ref_tests.TestKfxVerbs):
    pass


KFDEF = """
apiVersion: kfdef.apps.kubeflow.org/v1
kind: KfDef
metadata:
  name: team-p
spec:
  namespace: team-p
  commonLabels: {team: p, app.kubernetes.io/part-of: team-p}
  applications:
  - name: training
    path: apps/job.yaml
    parameters: {steps: 40, model: mlp}
    patch:
      spec:
        runPolicy: {backoffLimit: 2}
  - name: notebooks
    resource:
      apiVersion: kubeflow.org/v1
      kind: Notebook
      metadata: {name: "nb-${param.who}", labels: {team: override}}
      spec: {idleSeconds: 100, template: {spec: {containers: [
        {name: nb, command: [python, -m, http.server]}]}}}
    parameters: {who: alice}
    patch: {spec: {idleSeconds: 600}}
  - name: defaults
    resource:
      apiVersion: kubeflow.org/v1alpha1
      kind: PodDefault
      metadata: {name: env, namespace: elsewhere}
      spec: {selector: {matchLabels: {team: p}}, env: [{name: TEAM, value: p}]}
"""

JOB = """
apiVersion: kubeflow.org/v1
kind: JAXJob
metadata:
  name: job-${param.model}
spec:
  jaxReplicaSpecs:
    Worker:
      replicas: 1
      template:
        spec:
          containers:
          - name: main
            command: [python, -m, runner, "--model=${param.model}",
                      "--steps=${param.steps}"]
---
apiVersion: kubeflow.org/v1
kind: Profile
metadata: {name: extra}
spec: {owner: {kind: User, name: bob}}
"""


@pytest.fixture()
def platform(tmp_path):
    (tmp_path / "apps").mkdir()
    (tmp_path / "apps" / "job.yaml").write_text(JOB)
    path = tmp_path / "kfdef.yaml"
    path.write_text(KFDEF)
    return path


class TestBothPackages:
    def test_render_and_expand_equal(self, platform):
        doc = yaml.safe_load(KFDEF)
        base = str(platform.parent)
        want = ref.render_kfdef(doc, base)
        assert port.render_kfdef(doc, base) == want
        # Profiles first (the KfDef's namespace, then the app's own), then
        # the PodDefault, then the workloads in application order.
        assert [(d["kind"], d["metadata"]["name"]) for d in want] == [
            ("Profile", "team-p"), ("Profile", "extra"),
            ("PodDefault", "env"), ("JAXJob", "job-mlp"),
            ("Notebook", "nb-alice")]
        text = platform.read_text() + "---\n" + JOB.split("---")[0]
        assert port.expand_manifest_text(text, base) == \
            ref.expand_manifest_text(text, base)
        assert port.expand_manifest_file(str(platform)) == \
            ref.expand_manifest_file(str(platform))

    def test_generate_writes_equal_files(self, platform, tmp_path):
        got = port.generate(str(platform), str(tmp_path / "port"))
        want = ref.generate(str(platform), str(tmp_path / "ref"))
        assert [os.path.basename(p) for p in got] == \
            [os.path.basename(p) for p in want]
        assert [os.path.basename(p) for p in got] == [
            "00-profile-team-p.yaml", "01-profile-extra.yaml",
            "02-poddefault-env.yaml", "03-jaxjob-job-mlp.yaml",
            "04-notebook-nb-alice.yaml"]
        for a, b in zip(got, want):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read()

    @pytest.mark.parametrize("name,namespace", [
        ("plat", None), ("plat", "team-x")])
    def test_init_scaffold_equal(self, name, namespace):
        assert port.init_scaffold(name, namespace) == \
            ref.init_scaffold(name, namespace)

    def test_errors_equal(self, tmp_path):
        for doc in ({"kind": "KfDef", "metadata": {}},
                    {"kind": "KfDef", "metadata": {"name": "p"},
                     "spec": {"applications": [{"name": "a"}]}},
                    {"kind": "KfDef", "metadata": {"name": "p"},
                     "spec": {"applications": [{"name": "a", "resource": {
                         "kind": "JAXJob",
                         "metadata": {"name": "${param.x}"}}}]}}):
            with pytest.raises(ref.ValidationError) as want:
                ref.render_kfdef(doc, str(tmp_path))
            with pytest.raises(port.ValidationError) as got:
                port.render_kfdef(doc, str(tmp_path))
            assert str(got.value) == str(want.value)
