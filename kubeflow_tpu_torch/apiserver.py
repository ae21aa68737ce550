"""kfx apiserver + dashboard-lite — the platform's HTTP surface; the
port's copy of ``kubeflow_tpu/apiserver.py``.

Server mode (`kfx server`) hosts a persistent ControlPlane behind:

* a REST API (the k8s-apiserver seam of the reference stack, SURVEY.md §1
  L0): list/get/apply/delete resources, events, replica logs. Other kfx
  invocations can point at it with ``KFX_SERVER=http://host:port`` and
  become thin HTTP clients (the kubectl model).
* an HTML dashboard (the centraldashboard equivalent, SURVEY.md §2.2):
  every resource with state/conditions, per-resource pages with events
  and the chief log tail, and a notebook spawner page (the
  jupyter-web-app equivalent: create/delete Notebook resources from a
  form; the GPU/CPU pickers of the reference become the command line).
* the kfam access-management API (SURVEY.md §2.1 kfam row):
  GET/POST/DELETE /kfam/v1/bindings manage a Profile's contributors;
  the profile controller folds them into status.bindings.

Authorization (SURVEY.md §2.1 profile/kfam rows): the reference trusts
Istio to AUTHENTICATE callers and inject `kubeflow-userid`; self-hosted
there is no Istio, so the apiserver is both the authentication and the
enforcement point. `X-Kfx-User` alone is an unauthenticated,
client-asserted claim good only for read-side attribution. Writes into
a profile-owned namespace (profile name == namespace) require the
identity to be AUTHENTICATED with the per-user bearer token
(`X-Kfx-User-Token`) — issued only on admin-authenticated requests (an
admin-applied Profile returns the owner's token once; POST
/kfam/v1/tokens issues/rotates any user's), stored sha256-hashed in the
home's 0600 `user.tokens` — and to be the owner or a contributor;
binding and profile management additionally require owner or an
admin-role contributor. Namespaces without a Profile are unmanaged and
open. Possession of the home's 0600 `admin.token` (sent as
`X-Kfx-Admin-Token`) is cluster-admin — the kubectl-kubeconfig analogue
used by local kfx invocations on the server's own box.

The server process imports no torch: the plane it hosts spawns the
workers, and only they touch the card (``operators/training.py`` pins
them to ``cuda`` unless ``worker_platform``/``KFX_WORKER_PLATFORM`` says
``cpu``). ``kfx server`` stops on SIGINT or SIGTERM alike: it exits 0,
stops its plane (and with it the gangs) and removes its marker.

Routes:
  GET    /healthz                                 liveness
  GET    /version
  GET    /metrics[?format=json]                   registry render/snapshot
  GET    /query?family=&fn=&labels=&since=        telemetry window query
  GET    /alerts                                  alert-rule states
  GET    /slos                                    SLOs + generated rule states
  GET    /usage?tenant=&window=                   per-tenant usage summary
  GET    /apis                                    registered kinds
  GET    /apis/{kind}[?namespace=ns]              list (JSON)
  GET    /apis/{kind}/{ns}/{name}                 object (JSON)
  GET    /apis/{kind}/{ns}/{name}/events          events (JSON)
  GET    /apis/{kind}/{ns}/{name}/logs[?replica=] log text
  POST   /apis                                    apply YAML manifests
  DELETE /apis/{kind}/{ns}/{name}                 delete
  GET    /                                        dashboard (HTML)
  GET    /ui/notebooks                            notebook spawner (HTML)
  POST   /ui/notebooks                            create/delete from form
  GET    /ui/{kind}/{ns}/{name}                   resource page (HTML)
  GET    /kfam/v1/bindings[?namespace=ns]         list contributor bindings
  POST   /kfam/v1/bindings                        {namespace,user,role}
  DELETE /kfam/v1/bindings?namespace=&user=       remove a binding
"""

from __future__ import annotations

import html
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from .api.base import (
    ValidationError,
    display_state,
    registered_kinds,
    resource_class,
)
from .api.manifest import load_manifests
from .controlplane import ControlPlane
from .core.store import AlreadyExists, Conflict, NotFound, StoreFault


# Caller identity header — the kubeflow-userid analogue. The reference
# trusts Istio to AUTHENTICATE the user and inject the header; this
# self-hosted control plane has no Istio in front, so the header alone
# is an unauthenticated assertion any client can forge. Trust model:
#   * X-Kfx-User alone        -> read-only attribution (display, events);
#   * X-Kfx-User + X-Kfx-User-Token (verified against the hash stored at
#     bind time) -> authenticated identity; required for writes into
#     profile-owned namespaces;
#   * X-Kfx-Admin-Token (the home's 0600 admin.token) -> cluster admin.
# Tokens are minted only on ADMIN-authenticated requests (admin-applied
# Profile -> owner token in that response; POST /kfam/v1/tokens for
# everyone else), returned in plaintext exactly once, and stored hashed
# (sha256) in the home's 0600 user.tokens file. First-touch minting by
# arbitrary callers would let anyone harvest a not-yet-tokened user's
# credential by naming them as profile owner or binding them.
USER_HEADER = "X-Kfx-User"
USER_TOKEN_HEADER = "X-Kfx-User-Token"
ADMIN_HEADER = "X-Kfx-Admin-Token"
ADMIN_TOKEN_FILE = "admin.token"
USER_TOKENS_FILE = "user.tokens"


class Forbidden(Exception):
    """Caller identity lacks the required binding (HTTP 403)."""


def write_admin_token(home: str) -> str:
    """Mint (or reuse) the home's admin bearer token, mode 0600. Anyone
    who can read the home dir already owns the sqlite and the gangs, so
    file possession == cluster-admin; the token merely extends that
    fact across the HTTP boundary."""
    import secrets

    path = os.path.join(home, ADMIN_TOKEN_FILE)
    try:
        with open(path) as f:
            tok = f.read().strip()
        if tok:
            return tok
    except OSError:
        pass
    tok = secrets.token_hex(16)
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    with os.fdopen(fd, "w") as f:
        f.write(tok)
    return tok


def read_admin_token(home: str) -> Optional[str]:
    try:
        with open(os.path.join(home, ADMIN_TOKEN_FILE)) as f:
            return f.read().strip() or None
    except OSError:
        return None


class UserTokens:
    """Per-user bearer tokens, hashed at rest (sha256) in the home's
    0600 ``user.tokens`` JSON file. Plaintext exists only in the
    issuing HTTP response; possession of the file grants nothing but
    the ability to VERIFY (and whoever reads the home owns the cluster
    anyway — same argument as admin.token)."""

    def __init__(self, home: str):
        import threading

        self.path = os.path.join(home, USER_TOKENS_FILE)
        self._lock = threading.Lock()

    @staticmethod
    def _hash(token: str) -> str:
        import hashlib

        return hashlib.sha256(token.encode()).hexdigest()

    def _load(self) -> dict:
        try:
            with open(self.path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def _save(self, data: dict) -> None:
        tmp = self.path + ".tmp"
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "w") as f:
            json.dump(data, f)
        os.replace(tmp, self.path)

    def has(self, user: str) -> bool:
        with self._lock:
            return user in self._load()

    def issue(self, user: str, rotate: bool = False) -> Optional[str]:
        """Mint a token for ``user`` and store its hash; returns the
        plaintext ONCE. None if the user already has one (unless
        ``rotate``, which invalidates the old token)."""
        import secrets

        with self._lock:
            data = self._load()
            if user in data and not rotate:
                return None
            tok = secrets.token_hex(16)
            data[user] = self._hash(tok)
            self._save(data)
            return tok

    def verify(self, user: str, token: str) -> bool:
        import hmac

        with self._lock:
            ref = self._load().get(user, "")
        return bool(user and token and ref and
                    hmac.compare_digest(self._hash(token), ref))


def parse_label_selector(text: str) -> dict:
    """``k=v,k2=v2`` -> dict (the /query and `kfx query -l` label
    selector). Empty input -> {}. A clause without '=' raises."""
    out = {}
    for clause in (text or "").split(","):
        clause = clause.strip()
        if not clause:
            continue
        k, sep, v = clause.partition("=")
        if not sep or not k.strip():
            raise ValueError(f"bad label selector clause {clause!r} "
                             f"(want key=value)")
        out[k.strip()] = v.strip()
    return out


def metrics_json(snapshot: dict) -> dict:
    """Project the registry snapshot (the ONE metrics source — the
    exposition text renders the same state) into the legacy JSON shape
    of /metrics?format=json, plus per-kind reconcile-latency summaries
    derived from the histograms."""
    def samples(name):
        return snapshot.get(name, {}).get("samples", [])

    def scalar(name, default=0):
        s = samples(name)
        return s[0]["value"] if s else default

    controllers: dict = {}
    for stat in ("depth", "delayed", "processing", "retrying"):
        for s in samples(f"kfx_workqueue_{stat}"):
            controllers.setdefault(
                s["labels"]["controller"], {})[stat] = s["value"]
    reconcile: dict = {}
    for s in samples("kfx_reconcile_duration_seconds"):
        kind = s["labels"].get("kind", "")
        reconcile[kind] = {
            "count": s["count"],
            "p50_ms": _bucket_percentile_ms(s, 0.5),
            "p99_ms": _bucket_percentile_ms(s, 0.99),
        }
    return {
        "resources": {s["labels"]["kind"]: s["value"]
                      for s in samples("kfx_resources")},
        "controllers": controllers,
        "gangs": scalar("kfx_gangs"),
        "events": scalar("kfx_events_total"),
        "reconcile": reconcile,
        # Gang-scheduler capacity/queue state (sched/): what remote
        # `kfx top` / `kfx queue` render as the slice summary.
        "sched": {
            "capacity": scalar("kfx_sched_capacity_chips"),
            "reserved": scalar("kfx_sched_reserved_chips"),
            "queued": sum(s["value"]
                          for s in samples("kfx_sched_queue_depth")),
        },
    }


def _bucket_percentile_ms(sample: dict, q: float) -> Optional[float]:
    """Percentile (ms) from a snapshot histogram sample's cumulative
    [le, count] buckets (le serialized as strings, "+Inf" for the last)
    — delegates to the one interpolation in obs.metrics."""
    from .obs.metrics import percentile_from_buckets

    buckets = [(float("inf") if le == "+Inf" else float(le), cum)
               for le, cum in sample.get("buckets", [])]
    p = percentile_from_buckets(buckets, q)
    return round(p * 1000, 3) if p is not None else None


class _Handler(BaseHTTPRequestHandler):
    server_version = "kfx-apiserver"
    protocol_version = "HTTP/1.1"

    @property
    def cp(self) -> ControlPlane:
        return self.server.cp  # type: ignore[attr-defined]

    def log_message(self, fmt, *args):  # quiet by default
        pass

    # -- plumbing -----------------------------------------------------------
    def _drain(self) -> None:
        """Consume an unread request body so keep-alive connections stay
        in sync (an error response must not leave body bytes to be parsed
        as the next request line)."""
        if getattr(self, "_body_consumed", False):
            return
        self._body_consumed = True
        length = int(self.headers.get("Content-Length") or 0)
        while length > 0:
            chunk = self.rfile.read(min(length, 65536))
            if not chunk:
                break
            length -= len(chunk)

    def _send(self, code: int, body: bytes, ctype: str,
              headers: Optional[dict] = None) -> None:
        self._drain()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _json(self, code: int, payload) -> None:
        self._send(code, json.dumps(payload, indent=1).encode(),
                   "application/json")

    def _text(self, code: int, text: str) -> None:
        self._send(code, text.encode(), "text/plain; charset=utf-8")

    def _html(self, code: int, body: str) -> None:
        self._send(code, body.encode(), "text/html; charset=utf-8")

    def _error(self, code: int, msg: str) -> None:
        self._json(code, {"error": msg})

    def _unavailable(self, e: Exception) -> None:
        """A transient storage failure is the 503 contract (etcd
        unavailable), never a 500 stack trace: the client's correct
        move is to retry after a beat, so say exactly that."""
        self._send(503, json.dumps(
            {"error": f"storage temporarily unavailable: {e}"}).encode(),
            "application/json", {"Retry-After": "1"})

    # -- verbs --------------------------------------------------------------
    def do_GET(self):  # noqa: N802 (stdlib naming)
        url = urlparse(self.path)
        q = parse_qs(url.query)
        parts = [p for p in url.path.split("/") if p]
        try:
            if url.path == "/healthz":
                # X-Kfx-Home lets marker readers verify the responder
                # actually owns the home they found the marker in (a
                # stale marker + default-port reuse must not route one
                # home's mutations into another's store).
                return self._send(
                    200, b"ok", "text/plain; charset=utf-8",
                    {"X-Kfx-Home": os.path.realpath(self.cp.home)})
            if url.path == "/version":
                from . import __version__

                return self._json(200, {"version": __version__})
            if url.path == "/metrics":
                from .utils.prom import PROM_CTYPE

                # Both formats come off the registry — exposition text
                # via render(), JSON via the same snapshot — so there
                # is exactly one metric inventory.
                if (q.get("format") or [""])[0] == "json":
                    return self._json(
                        200, metrics_json(self.cp.metrics.snapshot()))
                return self._send(
                    200, self.cp.metrics.render().encode(), PROM_CTYPE)
            if url.path == "/query":
                return self._query(q)
            if url.path == "/alerts":
                return self._json(200, {"alerts": self.cp.alerts.states()})
            if url.path == "/slos":
                return self._json(200, {"slos": self._slos()})
            if url.path == "/usage":
                return self._usage(q)
            if not parts:  # dashboard root
                return self._html(200, self._dashboard())
            if parts == ["ui", "notebooks"]:
                return self._html(200, self._notebooks_page())
            if parts[0] == "ui" and len(parts) == 4:
                return self._html(200, self._resource_page(*parts[1:]))
            if parts[0] == "apis":
                return self._get_apis(parts[1:], q)
            if parts[:2] == ["kfam", "v1"] and parts[2:] == ["bindings"]:
                ns = (q.get("namespace") or [None])[0]
                return self._json(200, {"bindings": self._kfam_list(ns)})
            return self._error(404, f"no route {url.path}")
        except (NotFound, KeyError) as e:
            return self._error(404, str(e.args[0] if e.args else e))
        except StoreFault as e:
            return self._unavailable(e)
        except Exception as e:  # never abort the connection mid-response
            return self._error(500, f"{type(e).__name__}: {e}")

    def _query(self, q) -> None:
        """GET /query?family=&fn=rate|p99|max|...&labels=k=v,k2=v2&
        since=60 — the telemetry-store window query behind `kfx
        query`: the aggregate value plus the point series a sparkline
        renders (obs/tsdb.py QueryResult)."""
        family = (q.get("family") or [""])[0]
        if not family:
            return self._error(400, "family is required")
        fn = (q.get("fn") or ["latest"])[0]
        try:
            since = float((q.get("since") or ["60"])[0])
        except ValueError:
            return self._error(400, "since must be a number (seconds)")
        try:
            labels = parse_label_selector((q.get("labels") or [""])[0])
            res = self.cp.telemetry.query(family, fn, labels or None,
                                          since)
        except ValueError as e:
            return self._error(400, str(e))
        return self._json(200, res.to_dict())

    def _slos(self) -> List[dict]:
        """GET /slos — every SLO object's spec + evaluated status,
        joined with the live states of its generated burn rules (one
        payload so `kfx slo` renders budget AND alert state from a
        single snapshot, no torn read between two endpoints)."""
        from .obs.slo import slo_snapshot

        return slo_snapshot(self.cp.store, self.cp.alerts)

    def _usage(self, q) -> None:
        """GET /usage?tenant=&window=3600 — the fleet-aggregated
        per-tenant token/request summary (obs/slo.usage_summary)."""
        from .obs.slo import usage_summary

        tenant = (q.get("tenant") or [""])[0] or None
        try:
            window = float((q.get("window") or ["3600"])[0])
        except ValueError:
            return self._error(400, "window must be a number (seconds)")
        rows = usage_summary(self.cp.telemetry, window_s=window,
                             tenant=tenant)
        return self._json(200, {"usage": rows,
                                "windowSeconds": window})

    def _get_apis(self, parts: List[str], q) -> None:
        if not parts:
            return self._json(200, {"kinds": registered_kinds()})
        cls = resource_class(parts[0])
        if len(parts) == 1:
            ns = (q.get("namespace") or [None])[0]
            objs = self.cp.store.list(cls.KIND, ns)
            return self._json(200, {"kind": cls.KIND,
                                    "items": [o.to_dict() for o in objs]})
        if len(parts) == 3:
            ns, name = parts[1], parts[2]
            return self._json(
                200, self.cp.store.get(cls.KIND, name, ns).to_dict())
        if len(parts) == 4 and parts[3] == "events":
            ns, name = parts[1], parts[2]
            self.cp.store.get(cls.KIND, name, ns)  # 404 on absence
            evs = self.cp.store.events_for(cls.KIND, f"{ns}/{name}")
            return self._json(200, {"events": [
                {"timestamp": e.timestamp, "type": e.type,
                 "reason": e.reason, "message": e.message,
                 "traceId": e.trace_id, "spanId": e.span_id}
                for e in evs]})
        if len(parts) == 4 and parts[3] == "logs":
            ns, name = parts[1], parts[2]
            replica = (q.get("replica") or [""])[0]
            try:
                offset = int((q.get("offset") or ["0"])[0])
            except ValueError:
                return self._error(400, "offset must be an integer")
            if offset < 0:
                return self._error(400, "offset must be >= 0")
            # ?tail=N serves only the last N bytes (what remote `kfx
            # top` uses instead of downloading whole chief logs).
            if (q.get("tail") or [""])[0]:
                try:
                    tail = int(q["tail"][0])
                except ValueError:
                    return self._error(400, "tail must be an integer")
                if tail <= 0:
                    return self._error(400, "tail must be > 0")
                offset = -tail
            # job_logs_from returns ("", offset) before the gang has
            # written anything — pollers between apply and launch get an
            # empty 200, never an aborted connection.
            text, new_off = self.cp.job_logs_from(
                cls.KIND, name, ns, replica, offset)
            return self._send(200, text.encode(),
                              "text/plain; charset=utf-8",
                              {"X-Kfx-Log-Offset": str(new_off)})
        return self._error(404, f"no route /apis/{'/'.join(parts)}")

    def do_POST(self):  # noqa: N802
        url = urlparse(self.path)
        length = int(self.headers.get("Content-Length") or 0)
        text = self.rfile.read(length).decode()
        self._body_consumed = True
        try:
            if url.path == "/apis":
                from .obs import trace as obs_trace

                resources = load_manifests(text)
                self._authorize_apply(resources)
                # Admission mints (or adopts the caller's) trace ID;
                # echoing it per applied object lets clients follow the
                # submission through events, gang envs and logs.
                applied = self.cp.apply(
                    resources,
                    trace_id=self.headers.get(obs_trace.TRACE_HEADER)
                    or None)
                out = {"applied": [
                    {"kind": o.KIND, "name": o.name,
                     "namespace": o.namespace, "verb": verb,
                     "traceId": obs_trace.trace_of(o)}
                    for o, verb in applied]}
                # A Profile applied BY THE CLUSTER ADMIN mints its
                # owner's bearer token (plaintext returned exactly once,
                # here). Anonymous self-service profile creation must
                # NOT mint: X-Kfx-User is forgeable, so first-touch
                # minting would let anyone harvest any not-yet-tokened
                # user's credential by naming them as owner.
                tokens = getattr(self.server, "user_tokens", None)
                issued = {}
                if tokens is not None and self._is_admin():
                    for o, _verb in applied:
                        if o.KIND != "Profile":
                            continue
                        owner = o.owner().get("name", "")
                        minted = tokens.issue(owner) if owner else None
                        if minted:
                            issued[owner] = minted
                if issued:
                    out["issuedTokens"] = issued
                    out["tokenNote"] = (
                        f"send as {USER_TOKEN_HEADER} with {USER_HEADER};"
                        f" shown only once")
                return self._json(200, out)
            if url.path == "/ui/notebooks":
                form = parse_qs(text)
                self._authorize_write(
                    (form.get("namespace") or ["default"])[0])
                return self._notebooks_form(form)
            if url.path == "/kfam/v1/bindings":
                body = json.loads(text)
                ns = body.get("namespace") or body.get("referredNamespace")
                if ns:
                    self._authorize_admin(ns)
                return self._kfam_post(body)
            if url.path == "/kfam/v1/tokens":
                # Rotation/recovery is cluster-admin surface: a lost or
                # leaked user token is replaced here, invalidating the
                # old one.
                if not self._is_admin():
                    raise Forbidden("token rotation requires the admin "
                                    "token")
                body = json.loads(text)
                user = body.get("user", "")
                if not user:
                    return self._error(400, "user is required")
                tok = getattr(self.server, "user_tokens", None)
                if tok is None:
                    return self._error(503, "token store is not configured")
                minted = tok.issue(user, rotate=True)
                return self._json(200, {"user": user, "token": minted})
            return self._error(404, f"no route {url.path}")
        except Forbidden as e:
            return self._error(403, str(e))
        except NotFound as e:
            return self._error(404, str(e))
        except StoreFault as e:
            return self._unavailable(e)
        except (ValidationError, Conflict, AlreadyExists,
                KeyError, ValueError) as e:
            return self._error(400, str(e))
        except Exception as e:
            return self._error(500, f"{type(e).__name__}: {e}")

    def do_DELETE(self):  # noqa: N802
        url = urlparse(self.path)
        parts = [p for p in url.path.split("/") if p]
        try:
            if parts[:3] == ["kfam", "v1", "bindings"]:
                q = parse_qs(url.query)
                ns = (q.get("namespace") or [""])[0]
                user = (q.get("user") or [""])[0]
                if ns:
                    self._authorize_admin(ns)
                return self._kfam_delete(ns, user)
            if len(parts) != 4 or parts[0] != "apis":
                return self._error(404, f"no route {self.path}")
            cls = resource_class(parts[1])
            if cls.KIND == "Profile":
                self._authorize_admin(parts[3])
            else:
                self._authorize_write(parts[2])
            self.cp.store.delete(cls.KIND, parts[3], parts[2])
        except Forbidden as e:
            return self._error(403, str(e))
        except (NotFound, KeyError) as e:
            return self._error(404, str(e.args[0] if e.args else e))
        except StoreFault as e:
            return self._unavailable(e)
        except Exception as e:
            return self._error(500, f"{type(e).__name__}: {e}")
        return self._json(200, {"deleted": f"{parts[1]}/{parts[3]}"})

    # -- authorization ------------------------------------------------------
    def _caller(self) -> str:
        return self.headers.get(USER_HEADER, "")

    def _identity(self):
        """(user, authenticated). A present-but-wrong token is a hard
        403 — silently downgrading a failed authentication to an
        anonymous caller would mask credential problems."""
        user = self._caller()
        tok = self.headers.get(USER_TOKEN_HEADER, "")
        if not tok:
            return user, False
        tokens = getattr(self.server, "user_tokens", None)
        if tokens is None or not tokens.verify(user, tok):
            raise Forbidden(f"invalid token for user {user!r}")
        return user, True

    def _is_admin(self) -> bool:
        import hmac

        tok = self.headers.get(ADMIN_HEADER, "")
        ref = getattr(self.server, "admin_token", None)
        return bool(tok and ref and hmac.compare_digest(tok, ref))

    def _profile_for(self, namespace: str):
        """The Profile owning ``namespace`` (profile name == namespace),
        or None for an unmanaged namespace."""
        return self.cp.store.try_get("Profile", namespace)

    def _authorize(self, namespace: str, admin: bool = False) -> None:
        """Gate a write into ``namespace``. Unmanaged namespaces (no
        Profile; reference parity: no Istio AuthorizationPolicy was
        stamped) and admin-token callers pass. Otherwise the caller
        must present an AUTHENTICATED identity (X-Kfx-User-Token issued
        at bind time — the bare X-Kfx-User header is client-asserted
        and grants nothing for writes) that is the profile owner or a
        contributor — any role for plain writes, the ``admin`` role for
        access management (``admin=True``): edit-role contributors run
        workloads, they do not grant access."""
        prof = self._profile_for(namespace)
        if prof is None or self._is_admin():
            return
        user, authed = self._identity()
        is_member = (prof.owner().get("name") == user
                     or (user and any(
                         c.get("name") == user and
                         (not admin or c.get("role") == "admin")
                         for c in prof.contributors())))
        if is_member and authed:
            return
        who = f"user {user!r}" if user else "anonymous caller"
        if is_member:
            raise Forbidden(
                f"{who} matches a binding but is unauthenticated: writes "
                f"require the {USER_TOKEN_HEADER} header (issued when the "
                f"profile/binding was created; admins can rotate via "
                f"POST /kfam/v1/tokens)")
        if admin:
            raise Forbidden(f"{who} is not the owner or an admin of "
                            f"profile {namespace!r}")
        raise Forbidden(
            f"{who} is not the owner or a contributor of profile-owned "
            f"namespace {namespace!r} (bind via POST /kfam/v1/bindings)")

    def _authorize_write(self, namespace: str) -> None:
        self._authorize(namespace)

    def _authorize_admin(self, namespace: str) -> None:
        self._authorize(namespace, admin=True)

    def _authorize_apply(self, resources) -> None:
        for obj in resources:
            if obj.KIND == "Profile":
                # Creating a new profile is self-service registration —
                # but only over an EMPTY namespace: claiming one that
                # already holds other users' resources would lock them
                # out (namespace seizure). Mutating an existing profile
                # is access management.
                if self.cp.store.try_get("Profile", obj.name) is not None:
                    self._authorize_admin(obj.name)
                elif self._namespace_in_use(obj.name) and \
                        not self._is_admin():
                    raise Forbidden(
                        f"namespace {obj.name!r} already holds resources;"
                        f" claiming it as a profile requires the admin "
                        f"token")
            else:
                self._authorize_write(obj.namespace)

    def _namespace_in_use(self, namespace: str) -> bool:
        return any(self.cp.store.list(kind, namespace)
                   for kind in registered_kinds())

    # -- kfam (access management, SURVEY.md §2.1) ---------------------------
    def _kfam_list(self, namespace: Optional[str]) -> List[dict]:
        out = []
        for prof in self.cp.store.list("Profile"):
            if namespace and prof.name != namespace:
                continue
            for b in prof.status.get("bindings", []):
                out.append({"user": b.get("user"),
                            "role": b.get("role", "edit"),
                            "referredNamespace": prof.name})
        return out

    def _update_profile(self, ns: str, mutate) -> None:
        """Optimistic read-modify-write with retry: the profile controller
        folds bindings into status concurrently, bumping the version —
        an internal race must not surface as a client error."""
        for _ in range(20):
            prof = self.cp.store.get("Profile", ns)
            mutate(prof)
            try:
                self.cp.store.update(prof)
                return
            except Conflict:
                continue
        raise Conflict(f"profile {ns} kept changing; retry")

    def _kfam_post(self, body: dict) -> None:
        ns = body.get("namespace") or body.get("referredNamespace")
        user = body.get("user")
        role = body.get("role", "edit")
        if not ns or not user:
            return self._error(400, "namespace and user are required")

        def mutate(prof):
            contribs = [c for c in prof.contributors()
                        if c.get("name") != user]
            contribs.append({"name": user, "role": role})
            prof.spec["contributors"] = contribs

        self._update_profile(ns, mutate)
        out = {"bound": {"user": user, "role": role,
                         "referredNamespace": ns}}
        # Mint the new contributor's bearer token ONLY when the granter
        # is the cluster admin. Tokens are per-user across ALL profiles,
        # so returning a fresh user's plaintext to a mere profile
        # owner/admin-contributor would let any profile owner harvest a
        # credential that impersonates the victim everywhere (bind the
        # victim into a namespace you own, read the token). Profile
        # owners can still bind anyone; the bound user's token comes
        # from an admin (POST /kfam/v1/tokens) out-of-band.
        tok = getattr(self.server, "user_tokens", None)
        if tok is not None and self._is_admin():
            minted = tok.issue(user)
            if minted:
                out["token"] = minted
                out["tokenNote"] = (
                    f"send as {USER_TOKEN_HEADER} with {USER_HEADER}; "
                    f"shown only once")
        elif tok is not None and not tok.has(user):
            out["tokenNote"] = (f"user has no bearer token yet; an admin "
                                f"must issue one via POST /kfam/v1/tokens")
        return self._json(200, out)

    def _kfam_delete(self, ns: str, user: str) -> None:
        if not ns or not user:
            return self._error(400, "namespace and user are required")
        prof = self.cp.store.get("Profile", ns)
        if not any(c.get("name") == user for c in prof.contributors()):
            return self._error(404, f"no binding for {user} in {ns}")

        def mutate(p):
            p.spec["contributors"] = [c for c in p.contributors()
                                      if c.get("name") != user]

        self._update_profile(ns, mutate)
        return self._json(200, {"unbound": {"user": user,
                                            "referredNamespace": ns}})

    # -- dashboard ----------------------------------------------------------
    _STYLE = """
    body{font-family:system-ui,sans-serif;margin:2em;color:#1a1a2e}
    h1{font-size:1.4em} h2{font-size:1.1em;margin-top:1.4em}
    table{border-collapse:collapse;min-width:40em}
    th,td{text-align:left;padding:.3em .8em;border-bottom:1px solid #ddd}
    th{background:#f4f4f8} a{color:#2149b0;text-decoration:none}
    .Succeeded,.Ready{color:#137a23}.Failed{color:#b01313}
    .Running{color:#2149b0} pre{background:#f7f7f9;padding:1em;
    overflow-x:auto;border:1px solid #e2e2ea}
    """

    def _page(self, title: str, body: str) -> str:
        return (f"<!doctype html><html><head><meta charset='utf-8'>"
                f"<title>{html.escape(title)}</title>"
                f"<style>{self._STYLE}</style></head><body>"
                f"<h1><a href='/'>kfx</a> — {html.escape(title)}</h1>"
                f"{body}</body></html>")

    def _dashboard(self) -> str:
        out = []
        for kind in registered_kinds():
            objs = self.cp.store.list(kind)
            if not objs:
                continue
            rows = []
            for o in objs:
                st = display_state(o.conditions)
                url = f"/ui/{kind.lower()}/{o.namespace}/{o.name}"
                rows.append(
                    f"<tr><td><a href='{url}'>{html.escape(o.name)}</a></td>"
                    f"<td>{html.escape(o.namespace)}</td>"
                    f"<td class='{st}'>{st}</td>"
                    f"<td>{o.status.get('restartCount', 0)}</td></tr>")
            out.append(
                f"<h2>{kind}</h2><table><tr><th>name</th><th>namespace"
                f"</th><th>state</th><th>restarts</th></tr>"
                + "".join(rows) + "</table>")
        if not out:
            out.append("<p>no resources — <code>kfx apply -f …</code> "
                       "to create some.</p>")
        out.append("<p><a href='/ui/notebooks'>notebook spawner</a></p>")
        return self._page("dashboard", "".join(out))

    # -- notebook spawner (jupyter-web-app equivalent) ----------------------
    def _notebooks_page(self, message: str = "") -> str:
        rows = []
        for nb in self.cp.store.list("Notebook"):
            st = display_state(nb.conditions)
            url = nb.status.get("url", "")
            link = (f"<a href='{html.escape(url)}'>{html.escape(url)}</a>"
                    if url else "—")
            rows.append(
                f"<tr><td><a href='/ui/notebook/{nb.namespace}/{nb.name}'>"
                f"{html.escape(nb.name)}</a></td>"
                f"<td>{html.escape(nb.namespace)}</td>"
                f"<td class='{st}'>{st}</td><td>{link}</td>"
                f"<td><form method='post' action='/ui/notebooks'>"
                f"<input type='hidden' name='action' value='delete'>"
                f"<input type='hidden' name='name' "
                f"value='{html.escape(nb.name)}'>"
                f"<input type='hidden' name='namespace' "
                f"value='{html.escape(nb.namespace)}'>"
                f"<button>delete</button></form></td></tr>")
        table = ("<table><tr><th>name</th><th>namespace</th><th>state</th>"
                 "<th>url</th><th></th></tr>" + "".join(rows) + "</table>"
                 if rows else "<p>no notebooks yet.</p>")
        pd_rows = []
        for pd in self.cp.store.list("PodDefault"):
            val = html.escape(f"{pd.namespace}/{pd.name}")
            desc = html.escape(pd.spec.get("desc") or pd.name)
            pd_rows.append(
                f"<label><input type='checkbox' name='poddefault' "
                f"value='{val}'> {desc} "
                f"<small>({html.escape(pd.namespace)})</small></label><br>")
        pd_section = ("".join(pd_rows)
                      if pd_rows else "<small>none defined</small>")
        form = f"""
        <h2>spawn a notebook</h2>
        <form method='post' action='/ui/notebooks'>
        <input type='hidden' name='action' value='create'>
        <table>
        <tr><td>name</td><td><input name='name' required></td></tr>
        <tr><td>namespace</td>
            <td><input name='namespace' value='default'></td></tr>
        <tr><td>command</td><td><input name='command' size='60'
            value='python -m http.server --bind 127.0.0.1 $(KFX_PORT)'>
            </td></tr>
        <tr><td>image label</td>
            <td><input name='image' value='kfx/notebook:latest'></td></tr>
        <tr><td>CPU request</td>
            <td><input name='cpu' value='1' size='8'></td></tr>
        <tr><td>memory request</td>
            <td><input name='memory' value='1Gi' size='8'></td></tr>
        <tr><td>accelerator chips</td>
            <td><input name='accelerator' value='0' size='8'></td></tr>
        <tr><td>workspace volume</td>
            <td><input name='workspace' placeholder='{{name}}-workspace'>
            </td></tr>
        <tr><td>data volumes</td>
            <td><input name='datavols' size='40'
                 placeholder='claim1, claim2'></td></tr>
        <tr><td>configurations</td><td>{pd_section}</td></tr>
        <tr><td>idle cull (s)</td>
            <td><input name='idle' value='0'></td></tr>
        </table>
        <button>create</button></form>"""
        msg = f"<p><b>{html.escape(message)}</b></p>" if message else ""
        return self._page("notebooks", msg + table + form)

    def _notebooks_form(self, form: dict) -> None:
        get = lambda k, d="": (form.get(k) or [d])[0]
        action = get("action", "create")
        name, ns = get("name"), get("namespace", "default")
        if action == "delete":
            self.cp.store.delete("Notebook", name, ns)
            return self._html(200, self._notebooks_page(
                f"deleted {ns}/{name}"))
        import shlex

        container = {
            "name": "notebook",
            "image": get("image", "kfx/notebook:latest"),
            "command": shlex.split(get("command")),
        }
        # Resource pickers (reference jupyter-web-app form): requests
        # feed the profile quota admission; the accelerator count is the
        # GPU-picker analogue (TPU chips).
        requests = {}
        if get("cpu"):
            requests["cpu"] = get("cpu")
        if get("memory"):
            requests["memory"] = get("memory")
        if get("accelerator") and get("accelerator") != "0":
            requests["kubeflow.org/tpu"] = get("accelerator")
        if requests:
            container["resources"] = {"requests": requests}
        # Volume pickers: workspace + data claims become pvc-backed
        # volumes the controller maps to durable per-claim directories.
        claims = []
        if get("workspace"):
            claims.append(get("workspace"))
        claims += [c.strip() for c in get("datavols").split(",")
                   if c.strip()]
        volumes, mounts = [], []
        for i, claim in enumerate(claims):
            vname = f"vol-{i}"
            volumes.append({"name": vname,
                            "persistentVolumeClaim": {"claimName": claim}})
            mounts.append({"name": vname, "mountPath": f"/mnt/{claim}"})
        if mounts:
            container["volumeMounts"] = mounts
        # Configuration (PodDefault) selection: adopt each chosen
        # PodDefault's selector labels so its admission match fires.
        labels = {}
        for ref in form.get("poddefault") or []:
            pd_ns, _, pd_name = ref.partition("/")
            if pd_ns != ns:
                # Silently dropping a selected configuration would
                # spawn without the credential the user asked for.
                return self._error(
                    400, f"PodDefault {ref!r} is in namespace "
                    f"{pd_ns!r}, not the notebook's {ns!r}")
            pd = self.cp.store.try_get("PodDefault", pd_name, pd_ns)
            if pd is None:
                # Deleted between form render and submit — spawning
                # without the selected configuration would silently
                # omit the credential the user asked for.
                return self._error(
                    400, f"PodDefault {ref!r} no longer exists")
            labels.update(pd.selector())
        manifest = {
            "apiVersion": "kubeflow.org/v1",
            "kind": "Notebook",
            "metadata": {
                "name": name, "namespace": ns,
                "labels": labels,
                "annotations": {"notebooks.kubeflow.org/idle-seconds":
                                get("idle", "0")},
            },
            "spec": {"template": {"spec": {
                "containers": [container],
                **({"volumes": volumes} if volumes else {}),
            }}},
        }
        from .api.base import from_manifest

        self.cp.apply([from_manifest(manifest)])
        return self._html(200, self._notebooks_page(
            f"created {ns}/{name}"))

    def _experiment_trials_section(self, ns: str, name: str) -> str:
        """Katib-UI analogue: the experiment's trials with assignments
        and objective values, on the experiment's dashboard page."""
        from .operators.hpo import EXPERIMENT_LABEL

        rows = []
        for t in self.cp.store.list("Trial", ns):
            if t.metadata.labels.get(EXPERIMENT_LABEL) != name:
                continue
            st = display_state(t.conditions)
            assigns = ", ".join(
                f"{a.get('name')}={a.get('value')}"
                for a in (t.spec.get("parameterAssignments") or []))
            val = ""
            for m in (t.status.get("observation") or {}).get("metrics", []):
                val = str(m.get("latest", ""))
                break
            rows.append(f"<tr><td>{html.escape(t.name)}</td>"
                        f"<td>{html.escape(assigns)}</td>"
                        f"<td>{html.escape(val)}</td>"
                        f"<td class='{st}'>{st}</td></tr>")
        if not rows:
            return "<h2>trials</h2><p>none yet.</p>"
        return ("<h2>trials</h2><table><tr><th>trial</th><th>assignments"
                "</th><th>objective</th><th>state</th></tr>"
                + "".join(rows) + "</table>")

    def _resource_page(self, kind: str, ns: str, name: str) -> str:
        cls = resource_class(kind)
        obj = self.cp.store.get(cls.KIND, name, ns)
        body = [f"<h2>conditions</h2><table><tr><th>type</th><th>status"
                f"</th><th>reason</th><th>message</th></tr>"]
        for c in obj.conditions:
            body.append(f"<tr><td>{html.escape(c.type)}</td>"
                        f"<td>{html.escape(c.status)}</td>"
                        f"<td>{html.escape(c.reason or '')}</td>"
                        f"<td>{html.escape(c.message or '')}</td></tr>")
        body.append("</table><h2>events</h2><table><tr><th>time</th>"
                    "<th>type</th><th>reason</th><th>message</th></tr>")
        for e in self.cp.store.events_for(cls.KIND, f"{ns}/{name}"):
            body.append(f"<tr><td>{html.escape(e.timestamp)}</td>"
                        f"<td>{html.escape(e.type)}</td>"
                        f"<td>{html.escape(e.reason)}</td>"
                        f"<td>{html.escape(e.message)}</td></tr>")
        body.append("</table>")
        if cls.KIND == "Experiment":
            body.append(self._experiment_trials_section(ns, name))
        if cls.KIND == "Pipeline":
            steps = obj.status.get("steps") or {}
            if steps:
                body.append("<h2>steps</h2><table><tr><th>step</th>"
                            "<th>phase</th></tr>")
                for sname, phase in steps.items():
                    body.append(
                        f"<tr><td>{html.escape(str(sname))}</td>"
                        f"<td class='{html.escape(str(phase))}'>"
                        f"{html.escape(str(phase))}</td></tr>")
                body.append("</table>")
        try:
            log = self.cp.job_logs(cls.KIND, name, ns, "")
            if log:
                tail = log[-8000:]
                body.append(f"<h2>log (chief, tail)</h2>"
                            f"<pre>{html.escape(tail)}</pre>")
        except Exception:  # non-job kinds / no log yet: page still renders
            pass
        body.append(f"<h2>spec</h2><pre>{html.escape(json.dumps(obj.spec, indent=1))}"
                    f"</pre>")
        return self._page(f"{cls.KIND} {ns}/{name}", "".join(body))


class ApiServer:
    """The HTTP front of a ControlPlane; embeddable (tests) or run via
    serve_forever (the `kfx server` verb)."""

    def __init__(self, cp: ControlPlane, port: int = 8134,
                 host: str = "127.0.0.1"):
        self.cp = cp
        self.httpd = ThreadingHTTPServer((host, port), _Handler)
        self.httpd.cp = cp  # type: ignore[attr-defined]
        # Possession of the home's admin token (0600 file) is
        # cluster-admin — the kubectl-kubeconfig analogue. Local kfx
        # invocations on the same box read it and bypass kfam checks;
        # plain HTTP callers are subject to them.
        self.admin_token = write_admin_token(cp.home)
        self.httpd.admin_token = self.admin_token  # type: ignore
        self.httpd.user_tokens = UserTokens(cp.home)  # type: ignore
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    @property
    def url(self) -> str:
        host, port = self.httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "ApiServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="kfx-apiserver", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def __enter__(self) -> "ApiServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class ApiError(Exception):
    """Non-2xx from the apiserver, carrying (status, message)."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class Client:
    """Thin HTTP client over the REST routes — what a kfx invocation
    becomes when ``KFX_SERVER`` points at a running `kfx server` (the
    kubectl model: state and gangs live in the server process)."""

    def __init__(self, base_url: str, timeout: float = 30.0,
                 user: Optional[str] = None,
                 admin_token: Optional[str] = None,
                 user_token: Optional[str] = None):
        self.base = base_url.rstrip("/")
        self.timeout = timeout
        # Caller identity for profile-owned namespaces (KFX_USER is the
        # kubeflow-userid analogue the reference gets from Istio);
        # KFX_USER_TOKEN is the bearer token issued at profile/binding
        # creation — without it the identity is read-only attribution.
        self.user = user if user is not None else os.environ.get("KFX_USER")
        self.user_token = (user_token if user_token is not None
                           else os.environ.get("KFX_USER_TOKEN"))
        self.admin_token = admin_token

    def _call(self, path: str, data: Optional[bytes] = None,
              method: str = "GET") -> Tuple[int, str, dict]:
        import urllib.error
        import urllib.request

        req = urllib.request.Request(self.base + path, data=data,
                                     method=method)
        if self.user:
            req.add_header(USER_HEADER, self.user)
        if self.user_token:
            req.add_header(USER_TOKEN_HEADER, self.user_token)
        if self.admin_token:
            req.add_header(ADMIN_HEADER, self.admin_token)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return r.status, r.read().decode(), dict(r.headers)
        except urllib.error.HTTPError as e:
            body = e.read().decode()
            try:
                msg = json.loads(body).get("error", body)
            except (json.JSONDecodeError, ValueError):
                msg = body
            raise ApiError(e.code, msg) from None

    def _json(self, path: str, **kw):
        return json.loads(self._call(path, **kw)[1])

    def healthy(self) -> bool:
        return self.served_home() is not None

    def served_home(self) -> Optional[str]:
        """Canonical home path the responding server owns, or None if
        unreachable (or an old server that predates the header)."""
        try:
            code, _, headers = self._call("/healthz")
        except Exception:
            return None
        if code != 200:
            return None
        return headers.get("X-Kfx-Home")

    def apply_text(self, text: str) -> List[dict]:
        return self._json("/apis", data=text.encode(),
                          method="POST")["applied"]

    def list(self, kind: str, namespace: Optional[str] = None) -> List[dict]:
        q = f"?namespace={namespace}" if namespace else ""
        return self._json(f"/apis/{kind}{q}")["items"]

    def get(self, kind: str, namespace: str, name: str) -> dict:
        return self._json(f"/apis/{kind}/{namespace}/{name}")

    def delete(self, kind: str, namespace: str, name: str) -> None:
        self._call(f"/apis/{kind}/{namespace}/{name}", method="DELETE")

    def logs(self, kind: str, namespace: str, name: str,
             replica: str = "") -> str:
        q = f"?replica={replica}" if replica else ""
        return self._call(f"/apis/{kind}/{namespace}/{name}/logs{q}")[1]

    def logs_from(self, kind: str, namespace: str, name: str,
                  replica: str, offset: int) -> Tuple[str, int]:
        """Incremental tail (mirrors ControlPlane.job_logs_from): text
        from byte ``offset`` plus the next offset, so pollers never
        re-download the whole log."""
        _, text, headers = self._call(
            f"/apis/{kind}/{namespace}/{name}/logs"
            f"?replica={replica}&offset={offset}")
        return text, int(headers.get("X-Kfx-Log-Offset") or offset)

    def logs_tail(self, kind: str, namespace: str, name: str,
                  replica: str = "", max_bytes: int = 16384) -> str:
        """Only the last ``max_bytes`` of a replica log (?tail=N) — the
        `kfx top` path, which must not transfer a huge log for its last
        few metric lines."""
        return self._call(
            f"/apis/{kind}/{namespace}/{name}/logs"
            f"?replica={replica}&tail={max_bytes}")[1]

    def events(self, kind: str, namespace: str, name: str) -> List[dict]:
        return self._json(f"/apis/{kind}/{namespace}/{name}/events")["events"]

    def metrics_json(self) -> dict:
        """The /metrics?format=json snapshot (incl. the ``sched``
        capacity/queue block the CLI summary line renders)."""
        return self._json("/metrics?format=json")

    def query(self, family: str, fn: str = "latest",
              labels: Optional[dict] = None,
              since_s: float = 60.0) -> dict:
        """One telemetry-store window query (GET /query) — the remote
        half of `kfx query` and the `kfx top --watch` rate columns."""
        from urllib.parse import quote

        sel = ",".join(f"{k}={v}" for k, v in (labels or {}).items())
        return self._json(
            f"/query?family={quote(family)}&fn={quote(fn)}"
            f"&since={since_s:g}&labels={quote(sel)}")

    def alerts(self) -> List[dict]:
        """Live alert-rule states (GET /alerts)."""
        return self._json("/alerts")["alerts"]

    def slos(self) -> List[dict]:
        """SLO objects + their generated rule states (GET /slos)."""
        return self._json("/slos")["slos"]

    def usage(self, tenant: Optional[str] = None,
              window_s: float = 3600.0) -> List[dict]:
        """Per-tenant usage summary (GET /usage) — `kfx usage` remote."""
        from urllib.parse import quote

        return self._json(
            f"/usage?window={window_s:g}"
            f"&tenant={quote(tenant or '')}")["usage"]


SERVER_MARKER = "server.json"


def write_server_marker(home: str, url: str) -> str:
    """Advertise a live server on its home (``<home>/server.json``), so
    plain `kfx` invocations against the same home route through it
    instead of silently diverging from the owning process's state. The
    marker may go stale on SIGKILL — readers must health-check the URL."""
    path = os.path.join(home, SERVER_MARKER)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"url": url, "pid": os.getpid()}, f)
    os.replace(tmp, path)
    return path


def live_server_url(home: str) -> Optional[str]:
    """URL of a live `kfx server` owning ``home``, else None (no marker,
    or a stale one from a killed server). The responder must report this
    very home: after a SIGKILL leaves a stale marker, a *different*
    server reusing the same default port would otherwise answer the
    health check and silently receive this home's mutations."""
    try:
        with open(os.path.join(home, SERVER_MARKER)) as f:
            info = json.load(f)
    except (OSError, ValueError):
        return None
    url = info.get("url")
    if not url:
        return None
    served = Client(url, timeout=2.0).served_home()
    if served is not None and served == os.path.realpath(home):
        return url
    return None


def serve_forever(home: Optional[str] = None, port: int = 8134) -> int:
    # Two servers on one home would each run a full control plane over
    # the same sqlite: the second would adopt Running jobs and spawn
    # duplicate gangs next to their owner. Refuse while an owner lives.
    import signal
    import sys

    from .controlplane import HomeBusy, resolve_home

    # ControlPlane's home flock is the authoritative single-owner guard
    # (atomic, kernel-released on any death, so no stale-lock problem);
    # the marker liveness check only names the owner in the error.
    try:
        plane = ControlPlane(home=home, journal=True)
    except HomeBusy:
        owner = live_server_url(resolve_home(home))
        at = f" at {owner}; use KFX_SERVER={owner} for client mode" \
            if owner else ""
        print(f"error: {resolve_home(home)} is already served by a live "
              f"kfx process{at}", file=sys.stderr, flush=True)
        return 1
    with plane as cp:
        server = ApiServer(cp, port=port)
        marker = write_server_marker(cp.home, server.url)
        print(f"kfx apiserver + dashboard on {server.url} "
              f"(KFX_SERVER={server.url} for client mode)", flush=True)
        # SIGTERM (what a supervisor or `kill` sends) takes SIGINT's clean
        # path: the plane stops its gangs and the marker goes. Only the
        # main thread may install a handler (a test may serve from another).
        previous = None
        if threading.current_thread() is threading.main_thread():
            previous = signal.signal(signal.SIGTERM, _sigterm)
        try:
            server.httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            if previous is not None:
                signal.signal(signal.SIGTERM, previous)
            server.httpd.server_close()
            _unlink_own_marker(marker)
    return 0


def _sigterm(signum, frame):
    raise KeyboardInterrupt


def _unlink_own_marker(marker: str) -> None:
    """Remove the server marker only if it is still ours — a successor
    that claimed the home must not have its advertisement deleted by
    the predecessor's shutdown path."""
    try:
        with open(marker) as f:
            if json.load(f).get("pid") != os.getpid():
                return
    except (OSError, ValueError):
        return
    try:
        os.unlink(marker)
    except OSError:
        pass
