"""Per-tenant usage metering — the port's own copy of
``kubeflow_tpu/serving/metering.py`` (JAX-free there too; the port
imports nothing of the reference package): the exact token ledger behind
``kfx usage``.

The ledger hangs off the decode engine's own admission/retirement
funnel — ``_count_admission`` (once per CLIENT request, the same
``req.counted`` gate the queue-wait histogram uses) and
``Request._finish`` (the single retirement path every outcome passes
through) — so its totals are EXACT against the engine's accounting by
construction, not sampled:

  * prompt tokens bill once at first admission — a requeued preempt is
    recompute, not client traffic;
  * generated tokens bill once at retirement from ``len(req.tokens)``,
    which only grows (recompute re-prefills, it never re-emits), minus
    ``req.meter_skip`` — the ``stream_skip`` a mid-stream recovery
    re-dispatch asked for, so a token a DIFFERENT replica already
    billed and streamed is never billed twice fleet-wide;
  * the tenant key defaults to the adapter tenant (``""`` -> "base"),
    overridable per request — the same resolution the rate limiter and
    the WRR fairness scheduler use.

Export is a registry collector projecting the ledger into seeded
``kfx_tenant_requests_total{tenant,qos,adapter}`` and
``kfx_tenant_tokens_total{tenant,qos,adapter,kind}`` families; the
central scraper aggregates them fleet-wide like any replica family.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

TOKENS_FAMILY = "kfx_tenant_tokens_total"
REQUESTS_FAMILY = "kfx_tenant_requests_total"

TOKENS_HELP = ("Exact prompt/generated token usage by tenant, QoS "
               "class and adapter (engine retirement accounting).")
REQUESTS_HELP = ("Admitted client requests by tenant, QoS class and "
                 "adapter.")

# (tenant, qos, adapter)
_MeterKey = Tuple[str, str, str]


class TenantLedger:
    """Thread-safe exact usage counts keyed by (tenant, qos, adapter).

    Writers are the engine's admission/retirement hooks (loop thread);
    readers are the metrics collector and tests. Monotonic by
    construction — only ever incremented."""

    __slots__ = ("_lock", "_rows")

    def __init__(self):
        self._lock = threading.Lock()
        # key -> [requests, prompt_tokens, generated_tokens]
        self._rows: Dict[_MeterKey, List[int]] = {}

    def _row(self, key: _MeterKey) -> List[int]:
        row = self._rows.get(key)
        if row is None:
            row = self._rows[key] = [0, 0, 0]
        return row

    def admit(self, tenant: str, qos: str, adapter: str,
              prompt_tokens: int) -> None:
        with self._lock:
            row = self._row((tenant, qos, adapter))
            row[0] += 1
            row[1] += int(prompt_tokens)

    def retire(self, tenant: str, qos: str, adapter: str,
               generated_tokens: int) -> None:
        with self._lock:
            self._row((tenant, qos, adapter))[2] += \
                max(int(generated_tokens), 0)

    def seed(self, tenant: str, qos: str, adapter: str) -> None:
        """Materialise a zero row (server startup seeds the default
        tenant so ``scrape_metrics --require`` holds pre-traffic)."""
        with self._lock:
            self._row((tenant, qos, adapter))

    def snapshot(self) -> List[Dict]:
        """[{tenant, qos, adapter, requests, promptTokens,
        generatedTokens}], sorted by tenant/qos/adapter."""
        with self._lock:
            rows = sorted(self._rows.items())
        return [{"tenant": t, "qos": q, "adapter": a,
                 "requests": r[0], "promptTokens": r[1],
                 "generatedTokens": r[2]}
                for (t, q, a), r in rows]

    def totals(self, tenant: Optional[str] = None) -> Dict[str, int]:
        """Summed {requests, promptTokens, generatedTokens}, optionally
        for one tenant — the ledger-exactness assertion surface."""
        out = {"requests": 0, "promptTokens": 0, "generatedTokens": 0}
        with self._lock:
            for (t, _q, _a), r in self._rows.items():
                if tenant is not None and t != tenant:
                    continue
                out["requests"] += r[0]
                out["promptTokens"] += r[1]
                out["generatedTokens"] += r[2]
        return out

    # -- export --------------------------------------------------------------
    def collect(self, registry) -> None:
        """Registry collector: project the ledger into the seeded
        counter families (set_total — the ledger owns the truth)."""
        reqs = registry.counter(REQUESTS_FAMILY, REQUESTS_HELP)
        toks = registry.counter(TOKENS_FAMILY, TOKENS_HELP)
        for row in self.snapshot():
            labels = {"tenant": row["tenant"], "qos": row["qos"],
                      "adapter": row["adapter"]}
            reqs.set_total(row["requests"], **labels)
            toks.set_total(row["promptTokens"], kind="prompt", **labels)
            toks.set_total(row["generatedTokens"], kind="generated",
                           **labels)
