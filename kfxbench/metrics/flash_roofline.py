"""flash_roofline: the least time of the traced window's attention calls
(core/flops.py's flash_least_seconds at the cell's shapes, one call a
forward launch) over the device time of the port's three flash kernels
(forward, dQ, dK/dV) in the trace, in %."""

from kfxbench.core.devtrace import short
from kfxbench.core.flops import flash_least_seconds

NAME = "flash_roofline"
KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")


def read(rec):
    train, trace = rec.get("train"), rec.get("trace")
    if not train or not trace:
        return None
    # The port's kernels live in namespace kfx (ops/csrc).
    kernel = {n: short(n).split("::") for n in trace["by_name"]}
    kernel = {n: k[-1] for n, k in kernel.items() if k[0] == "kfx"}
    mine = {n for n, k in kernel.items() if k.startswith(KERNELS)}
    calls = sum(trace["counts"][n] for n in mine
                if kernel[n].startswith("flash_fwd"))
    seconds = sum(trace["by_name"][n] for n in mine)
    if not calls or seconds <= 0:
        return None
    least = flash_least_seconds(train["batch"], train["seq_len"],
                                train["heads"], train["head_dim"])
    return 100.0 * calls * least["seconds"] / seconds
