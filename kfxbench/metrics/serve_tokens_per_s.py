"""serve_tokens_per_s: output tokens the engine handed to clients in the
window, over the window's seconds. Tokens arrive a decode chunk at a time
(about 512 every few seconds), so the chunk that lands after either edge
of the window counts pro rata for the part of its making that lies
inside (``core/stats.py``): a whole-chunk count would move by a chunk
with the phase of the arrivals, and a stall at either edge still
shows."""

from kfxbench.core.stats import delivered_by

NAME = "serve_tokens_per_s"


def read(rec):
    serve = rec.get("serve")
    if not serve:
        return None
    lo, hi = serve["t_open"], serve["t_close"]
    return (delivered_by(serve, hi) - delivered_by(serve, lo)) / (hi - lo)
