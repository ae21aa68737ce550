"""Storage initializer: pull a model export to local disk before serving
— the port's own copy of ``kubeflow_tpu/serving/storage.py`` (JAX-free
there too; the port imports nothing of the reference package). The
weight pool (serving/weights.py) resolves each pooled model's URI here
at swap time.

Reference parity (SURVEY.md §2.1 KFServing controller row: an
initContainer downloads the model from GCS/S3/HTTP/PVC before the server
starts). Schemes:

  file:///path, /path      passthrough (no copy)
  pvc://volume/sub/path    resolved under KFX_PVC_ROOT (the mounted-volume
                           model of the reference, minus the kubelet)
  http://, https://        downloaded into the cache dir via stdlib urllib
                           (offline-testable against a local HTTP server)
  gs://bucket/obj          public GCS JSON/XML endpoint over https
  s3://bucket/obj          virtual-hosted s3 URL (KFX_S3_ENDPOINT to
                           point at minio etc.)

Remote exports are fetched into ``<cache>/<digest>/`` and re-used; a
partial download never becomes visible (tmp dir + atomic rename).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import tempfile
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, Dict, List

# Known export formats, probed in order by marker file. Remote schemes
# fetch the matching file set; local schemes just point at the
# directory. Order matters: the LM export also carries params.msgpack
# (but no config.json), and the TorchScript export also carries
# config.json — so their markers must be probed before the classifier's.
# TensorFlow SavedModels (saved_model.pb + a variables/ tree) are
# multi-file directories remote schemes cannot enumerate; serve those
# from file:// or pvc:// URIs.
EXPORT_FORMATS = (
    ("lm_config.json", ("lm_config.json", "params.msgpack")),
    ("model.pt", ("model.pt", "config.json")),
    ("model.joblib", ("model.joblib", "config.json")),
    ("config.json", ("config.json", "params.msgpack")),
)

ENV_PVC_ROOT = "KFX_PVC_ROOT"
ENV_S3_ENDPOINT = "KFX_S3_ENDPOINT"


def _pvc(uri: str, cache_dir: str) -> str:
    root = os.environ.get(ENV_PVC_ROOT, "/mnt/pvc")
    rest = uri[len("pvc://"):]
    return os.path.join(root, rest)


def _http(uri: str, cache_dir: str) -> str:
    digest = hashlib.sha256(uri.encode()).hexdigest()[:16]
    dest = os.path.join(cache_dir, digest)
    if os.path.isdir(dest):  # cached (atomic rename made it complete)
        return dest
    os.makedirs(cache_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=cache_dir, prefix=f".{digest}.")
    base = uri.rstrip("/")

    def fetch(fname: str) -> None:
        with urllib.request.urlopen(f"{base}/{fname}", timeout=60) as r, \
                open(os.path.join(tmp, fname), "wb") as f:
            shutil.copyfileobj(r, f)

    try:
        probe_errors = []
        for marker, files in EXPORT_FORMATS:
            try:
                fetch(marker)
            except urllib.error.HTTPError as e:
                if e.code != 404:  # 404 = probe miss; anything else is real
                    raise
                probe_errors.append(f"{marker}: {e}")
                continue
            for fname in files:
                if fname != marker:
                    fetch(fname)
            break
        else:
            raise ValueError(
                f"no known export format at {uri} — probed "
                + "; ".join(probe_errors)
                + " (note: tf SavedModel trees are not downloadable; "
                  "use file:// or pvc://)")
        try:
            os.replace(tmp, dest)
        except OSError:  # a concurrent initializer completed first
            shutil.rmtree(tmp, ignore_errors=True)
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return dest


def _gs(uri: str, cache_dir: str) -> str:
    bucket, _, obj = uri[len("gs://"):].partition("/")
    return _http(f"https://storage.googleapis.com/{bucket}/{obj}",
                 cache_dir)


def _s3(uri: str, cache_dir: str) -> str:
    bucket, _, obj = uri[len("s3://"):].partition("/")
    endpoint = os.environ.get(ENV_S3_ENDPOINT)
    if endpoint:
        return _http(f"{endpoint.rstrip('/')}/{bucket}/{obj}", cache_dir)
    return _http(f"https://{bucket}.s3.amazonaws.com/{obj}", cache_dir)


_SCHEMES: Dict[str, Callable[[str, str], str]] = {
    "pvc": _pvc,
    "http": _http,
    "https": _http,
    "gs": _gs,
    "s3": _s3,
}


def supported_schemes() -> List[str]:
    return ["file"] + sorted(_SCHEMES)


def fetch_file(uri: str, cache_dir: str) -> str:
    """Resolve a SINGLE-file URI (e.g. a transformer hook module) to a
    local path — unlike ``initialize``, which resolves export
    directories. Remote schemes download just that file, atomically, into
    the cache."""
    if uri.startswith("file://"):
        return uri[len("file://"):]
    if "://" not in uri:
        return uri
    scheme = urllib.parse.urlparse(uri).scheme
    if scheme == "pvc":
        return _pvc(uri, cache_dir)
    if scheme == "gs":
        bucket, _, obj = uri[len("gs://"):].partition("/")
        uri = f"https://storage.googleapis.com/{bucket}/{obj}"
    elif scheme == "s3":
        bucket, _, obj = uri[len("s3://"):].partition("/")
        endpoint = os.environ.get(ENV_S3_ENDPOINT)
        uri = (f"{endpoint.rstrip('/')}/{bucket}/{obj}" if endpoint
               else f"https://{bucket}.s3.amazonaws.com/{obj}")
    elif scheme not in ("http", "https"):
        raise ValueError(
            f"unsupported file URI scheme {scheme!r} (supported: "
            f"{', '.join(supported_schemes())})")
    digest = hashlib.sha256(uri.encode()).hexdigest()[:16]
    fname = os.path.basename(urllib.parse.urlparse(uri).path) or "file"
    dest = os.path.join(cache_dir, digest, fname)
    if os.path.exists(dest):
        return dest
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(dest), prefix=".dl.")
    try:
        with urllib.request.urlopen(uri, timeout=60) as r, \
                os.fdopen(fd, "wb") as f:
            shutil.copyfileobj(r, f)
        os.replace(tmp, dest)
    except Exception:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return dest


def initialize(uri: str, cache_dir: str) -> str:
    """Resolve ``uri`` to a local export directory, downloading if the
    scheme is remote. Raises ValueError for unknown schemes."""
    if uri.startswith("file://"):
        return uri[len("file://"):]
    if "://" not in uri:
        return uri
    scheme = urllib.parse.urlparse(uri).scheme
    handler = _SCHEMES.get(scheme)
    if handler is None:
        raise ValueError(
            f"unsupported storageUri scheme {scheme!r} (supported: "
            f"{', '.join(supported_schemes())})")
    return handler(uri, cache_dir)
