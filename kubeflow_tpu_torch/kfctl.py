"""kfctl parity: whole-platform configuration via a ``KfDef`` file; the
port's copy of ``kubeflow_tpu/kfctl.py``.

The reference's `kfctl {init,generate,apply}` renders a platform from a
KfDef + kustomize overlays and applies it in dependency order (SURVEY.md
§2.1 kfctl row, §3 CS5). The TPU-native equivalent keeps the shape but
swaps kustomize for a small, explicit renderer:

    apiVersion: kfdef.apps.kubeflow.org/v1
    kind: KfDef
    metadata: {name: team-a-platform}
    spec:
      namespace: team-a          # rendered as a Profile + stamped on apps
      profile: true              # emit the Profile resource (default)
      commonLabels: {team: a}    # merged into every resource's labels
      applications:
      - name: notebooks
        path: notebook.yaml      # manifests relative to the KfDef file
        parameters: {image: "jupyter:latest"}   # ${param.image} substitution
        patch: {spec: {idleSeconds: 600}}       # deep merge onto each doc
      - name: inline-job
        resource: {apiVersion: ..., kind: JAXJob, ...}

`kfx init` scaffolds a KfDef, `kfx generate` writes the rendered
manifests, and `kfx apply -f kfdef.yaml` expands it in-line (the CLI does
the rendering — like the reference, KfDef is a client-side config, not a
stored resource). Rendering order: Profile → PodDefault → everything
else, so namespaces and admission defaults exist before workloads."""

from __future__ import annotations

import copy
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import yaml

from .api.base import ValidationError

KFDEF_KIND = "KfDef"
_ORDER_FIRST = ("Profile", "PodDefault")


def is_kfdef(doc: Dict[str, Any]) -> bool:
    return isinstance(doc, dict) and doc.get("kind") == KFDEF_KIND


def _deep_merge(base: Dict[str, Any], patch: Dict[str, Any]
                ) -> Dict[str, Any]:
    out = dict(base)
    for k, v in patch.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


_PARAM_RE = re.compile(r"\$\{param\.([A-Za-z0-9_-]+)\}")


def _substitute(node: Any, params: Dict[str, str], app: str) -> Any:
    from .utils.template import substitute_refs

    def resolve(key: str) -> str:
        if key not in params:
            raise ValidationError(f"applications[{app}]",
                                  f"undefined parameter ${{param.{key}}}")
        return str(params[key])

    return substitute_refs(node, _PARAM_RE, resolve)


def render_kfdef(doc: Dict[str, Any], base_dir: str
                 ) -> List[Dict[str, Any]]:
    """Expand a KfDef document into an ordered list of manifest dicts."""
    spec = doc.get("spec") or {}
    meta = doc.get("metadata") or {}
    if not meta.get("name"):
        raise ValidationError("metadata.name", "required")
    namespace = spec.get("namespace", "")
    common_labels = spec.get("commonLabels") or {}

    docs: List[Dict[str, Any]] = []
    if namespace and spec.get("profile", True):
        docs.append({
            "apiVersion": "kubeflow.org/v1",
            "kind": "Profile",
            "metadata": {"name": namespace},
            "spec": {"owner": {"kind": "User",
                               "name": f"{meta['name']}@kfdef"}},
        })

    for i, app in enumerate(spec.get("applications") or []):
        name = str(app.get("name") or f"app-{i}")
        loaded: List[Dict[str, Any]] = []
        if "resource" in app:
            loaded.append(copy.deepcopy(app["resource"]))
        if "path" in app:
            path = app["path"]
            if not os.path.isabs(path):
                path = os.path.join(base_dir, path)
            with open(path) as f:
                loaded.extend(d for d in yaml.safe_load_all(f) if d)
        if not loaded:
            raise ValidationError(
                f"applications[{name}]", "needs 'path' or 'resource'")
        params = {str(k): str(v)
                  for k, v in (app.get("parameters") or {}).items()}
        patch = app.get("patch") or {}
        for d in loaded:
            d = _substitute(d, params, name)
            if patch:
                d = _deep_merge(d, patch)
            md = d.setdefault("metadata", {})
            if namespace and not md.get("namespace") \
                    and d.get("kind") != "Profile":
                md["namespace"] = namespace
            if common_labels:
                md["labels"] = {**common_labels, **(md.get("labels") or {})}
            docs.append(d)

    # Profiles/PodDefaults before workloads (namespaces + admission first).
    docs.sort(key=lambda d: (_ORDER_FIRST.index(d.get("kind"))
                             if d.get("kind") in _ORDER_FIRST
                             else len(_ORDER_FIRST)))
    return docs


def expand_manifest_text(text: str, base_dir: str) -> List[Dict[str, Any]]:
    """All documents in ``text``, with any KfDef expanded in place."""
    out: List[Dict[str, Any]] = []
    for i, doc in enumerate(yaml.safe_load_all(text)):
        if not doc:
            continue
        if not isinstance(doc, dict):
            raise ValidationError(f"document[{i}]",
                                  "manifest must be a mapping")
        if is_kfdef(doc):
            out.extend(render_kfdef(doc, base_dir))
        else:
            out.append(doc)
    return out


def expand_manifest_file(path: str) -> List[Dict[str, Any]]:
    with open(path) as f:
        return expand_manifest_text(f.read(),
                                    os.path.dirname(os.path.abspath(path)))


def generate(path: str, out_dir: str) -> List[str]:
    """`kfctl generate` parity: write the rendered manifests to files,
    one per resource, prefixed by apply order. Returns the paths."""
    docs = expand_manifest_file(path)
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for i, d in enumerate(docs):
        kind = str(d.get("kind", "resource")).lower()
        name = str((d.get("metadata") or {}).get("name", i))
        p = os.path.join(out_dir, f"{i:02d}-{kind}-{name}.yaml")
        with open(p, "w") as f:
            yaml.safe_dump(d, f, sort_keys=False)
        written.append(p)
    return written


def init_scaffold(name: str, namespace: Optional[str] = None) -> str:
    """`kfctl init` parity: a starter KfDef."""
    ns = namespace or name
    return f"""\
apiVersion: kfdef.apps.kubeflow.org/v1
kind: KfDef
metadata:
  name: {name}
spec:
  namespace: {ns}
  profile: true
  commonLabels:
    app.kubernetes.io/part-of: {name}
  applications: []
  # - name: training
  #   path: lm-jaxjob.yaml
  #   parameters: {{preset: small}}
  # - name: serving
  #   resource:
  #     apiVersion: serving.kubeflow.org/v1beta1
  #     kind: InferenceService
  #     metadata: {{name: mnist}}
  #     spec: {{predictor: {{jax: {{storageUri: file:///tmp/export}}}}}}
"""
