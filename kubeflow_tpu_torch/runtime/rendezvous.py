"""Worker bootstrap — the port's copy of ``apply_startup_chaos`` from
``kubeflow_tpu/runtime/rendezvous.py`` and the env names it reads. The
rest of the reference module (the rendezvous env a gang member receives)
belongs to the control plane (ROADMAP.md Queue A 8)."""

from __future__ import annotations

import os
import time

ENV_REPLICA_TYPE = "KFX_REPLICA_TYPE"
ENV_REPLICA_INDEX = "KFX_REPLICA_INDEX"


def apply_startup_chaos() -> float:
    """Fault point ``rendezvous.delay``: a straggling worker. The runner
    calls this before it touches the device (workers inherit KFX_CHAOS
    through the gang env). Returns the seconds slept; an injected sleep
    is recorded as a ``rendezvous.chaos`` span, so the straggler shows
    on the trace exactly where the gap is."""
    from .. import chaos
    from ..obs import trace as obs_trace

    rtype = os.environ.get(ENV_REPLICA_TYPE, "")
    index = os.environ.get(ENV_REPLICA_INDEX, "")
    replica = f"{rtype.lower()}-{index}"
    t0 = time.time()
    slept = chaos.maybe_delay("rendezvous.delay", target=replica)
    if slept > 0:
        obs_trace.record_span("rendezvous.chaos", t0, slept, replica=replica)
    return slept
