"""The traffic generators: repeatable from their seed, every seed the
same set of sizes, and the lengths and shares the mixes state."""

from __future__ import annotations

import numpy as np
import pytest

from kfxbench.core import bench, traffic


def _loop(mix, seed, vocab=102400):
    return bench.generator(mix["kind"]).requests(mix, vocab, seed)


def _batches(mix, seed):
    return bench.generator(mix["kind"]).batches(mix, 32256, 32014, seed)


def _first(mix_name, seed, n=256, vocab=102400):
    loop = _loop(traffic.load(mix_name), seed, vocab)
    out = []
    for c in range(loop.clients):
        it = loop.stream(c)
        out += [next(it) for _ in range(max(1, n // loop.clients))]
    return out


@pytest.mark.parametrize("mix", ["chat", "sessions"])
def test_closed_loop_repeats_from_seed(mix):
    a, b = _first(mix, 2 ** 31 + 17), _first(mix, 2 ** 31 + 17)
    assert a == b
    c = _first(mix, 5)
    assert [p for p, _ in a] != [p for p, _ in c]


def test_chat_sizes_are_the_table_in_another_order():
    mix = traffic.load("chat")
    n = mix["table"]
    sizes = []
    for seed in (1, 2 ** 33 + 3):
        got = _first("chat", seed, n)
        sizes.append((sorted(len(p) for p, _ in got),
                      sorted(m for _, m in got)))
    assert sizes[0] == sizes[1]
    prompts, outputs = map(np.array, sizes[0])
    assert np.median(prompts) == pytest.approx(1024, rel=0.01)
    assert prompts.min() >= 64 and prompts.max() == 3584
    assert np.median(outputs) == pytest.approx(128, rel=0.01)
    assert outputs.min() >= 8 and outputs.max() == 512
    assert (prompts + outputs).max() <= 4096


def test_chat_prompts_share_no_page():
    got = _first("chat", 9, 128)
    pages = {tuple(p[:32]) for p, _ in got}
    assert len(pages) == len(got)


def test_sessions_share_system_prompts_and_resend_history():
    mix = traffic.load("sessions")
    loop = _loop(mix, 77)
    assert len(loop.system) == 4
    assert all(len(s) == 1536 for s in loop.system)
    picks = [loop.system_pick(c, s) for s in range(128)
             for c in range(loop.clients)]
    shares = np.bincount(picks, minlength=4) / len(picks)
    assert shares == pytest.approx([0.70, 0.15, 0.10, 0.05], abs=0.01)
    it = loop.stream(0)
    first, m1 = next(it)
    second, _ = next(it)
    assert first[:1536] in loop.system
    # The second turn re-sends the first prompt and a reply of the length
    # asked for, then a new user message.
    assert second[:len(first)] == first
    assert len(second) > len(first) + m1
    for _ in range(200):
        prompt, max_new = next(it)
        assert len(prompt) + max_new <= mix["context_max"]


def test_packed_batches_repeat_and_differ_row_by_row():
    mix = traffic.load("pack-s4k-b4")
    a = _batches(mix, 3)
    b = _batches(mix, 3)
    assert len(a) == mix["pool_batches"]
    assert all((x == y).all() for x, y in zip(a, b))
    assert a[0].shape == (4, 4097) and a[0].dtype == np.int64
    rows = {r.tobytes() for batch in a for r in batch}
    assert len(rows) == mix["pool_batches"] * 4
    stream = np.concatenate([x.ravel() for x in a])
    assert stream.min() >= 0 and stream.max() < 32256
    assert (stream == 32014).sum() > 10          # document boundaries
    c = _batches(mix, 4)
    assert not (a[0] == c[0]).all()


def test_lognormal_table_quantiles():
    t = traffic.lognormal_table({"median": 1500, "sigma": 1.0, "min": 64,
                                 "max": 16384}, 257)
    assert t[128] == 1500
    assert t.min() >= 64 and t.max() <= 16384
    assert (np.diff(t) >= 0).all()


@pytest.mark.parametrize("mix", ["chat", "sessions"])
def test_every_seed_sends_nearly_the_same_first_round(mix):
    sums = []
    for seed in (1, 2 ** 31 + 3, 987654321987):
        loop = _loop(traffic.load(mix), seed)
        first = [next(loop.stream(c)) for c in range(loop.clients)]
        sums.append(sum(m for _, m in first))
    assert max(sums) <= 1.06 * min(sums)


@pytest.mark.parametrize("mix,lo,hi", [("chat", 64, 4088),
                                       ("sessions", 1, 3576)])
def test_prefill_range(mix, lo, hi):
    assert _loop(traffic.load(mix), 1).prefill_range() == (lo, hi)
