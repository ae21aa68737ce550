"""engine.ttft_p95_ms: the 95th percentile (nearest rank), over every
request submitted in the window, of submit to first token; a failed
request, or one with no first token, counts as infinite. A per-layer
metric: at some 25 requests a window its runs spread too far to bound."""

import math

from kfxbench.core.stats import in_window, percentile

NAME = "engine.ttft_p95_ms"


def read(rec):
    serve = rec.get("serve")
    if not serve:
        return None
    ttft = [(q["times"][0] - q["t_submit"]) * 1e3
            if q["times"] and not q["failed"] else math.inf
            for q in in_window(serve)]
    return percentile(ttft, 95) if ttft else None
