"""device.idle_pct.train: the share of the traced window of a training
cell in which no operation ran on the device, in %."""

NAME = "device.idle_pct.train"


def read(rec):
    trace = rec.get("trace")
    if not rec.get("train") or not trace or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
