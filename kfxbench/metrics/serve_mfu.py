"""serve.mfu: the forward FLOPs the window's tokens need at their
positions (core/flops.py), over the window's seconds and the H100's bf16
peak, in %. A request whose first token lands in the window counts its
whole prompt, a cached prefix included; each later token delivered in the
window counts one forward at the position of the token before it."""

from kfxbench.core import flops

NAME = "serve.mfu"


def read(rec):
    serve = rec.get("serve")
    if not serve:
        return None
    cfg, lo, hi = serve["config"], serve["t_open"], serve["t_close"]
    work = 0.0
    for q in serve["requests"]:
        n = q["n_prompt"]
        for k, t in enumerate(q["times"]):
            if lo <= t <= hi:
                work += flops.prompt_flops(cfg, n) if k == 0 \
                    else flops.decode_flops(cfg, n + k - 1)
    return 100.0 * work / (rec["window_s"] * flops.PEAK_BF16_FLOPS)
