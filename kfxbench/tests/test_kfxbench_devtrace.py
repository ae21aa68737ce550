"""The device trace on the card: a profiled stretch of work reads busy
time and the kernels by name. Skips where there is no card."""

from __future__ import annotations

import tempfile

import pytest
import torch

from kfxbench.core.devtrace import DeviceTrace


@pytest.mark.cuda
def test_profiled_matmuls_read_busy_time():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the device trace needs CUPTI on a card")
    a = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
    with tempfile.TemporaryDirectory() as tmp:
        tr = DeviceTrace(tmp)
        tr.start()
        for _ in range(20):
            a = a @ a / 64
        tr.stop()
    s = tr.summary()
    assert 0 < s["busy_s"] <= s["window_s"]
    assert sum(s["counts"].values()) >= 20
