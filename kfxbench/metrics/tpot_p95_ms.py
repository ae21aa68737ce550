"""tpot_p95_ms: the 95th percentile (nearest rank), over requests
completed in the window with two tokens or more, of (last token - first
token) / (tokens - 1): the gap a streaming client sees."""

from kfxbench.core.stats import percentile

NAME = "tpot_p95_ms"


def read(rec):
    serve = rec.get("serve")
    if not serve:
        return None
    lo, hi = serve["t_open"], serve["t_close"]
    gaps = [(q["times"][-1] - q["times"][0]) * 1e3 / (len(q["times"]) - 1)
            for q in serve["requests"]
            if not q["failed"] and lo <= q["t_done"] <= hi
            and len(q["times"]) >= 2]
    return percentile(gaps, 95) if gaps else None
