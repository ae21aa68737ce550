"""Traffic of kind ``closed_loop``: the request streams of the ``serve``
driver's clients. ``clients`` clients each send their next request when
the previous one completes. A client runs sessions: an optional system
prompt (one of ``system.count`` prompts of ``system.tokens`` tokens,
chosen with ``system.shares``), then ``turns`` turns. A turn sends the
whole history (system prompt, then every earlier user message and reply)
plus a new user message of ``user`` tokens, and asks for ``output`` new
tokens. A session ends after its turns, or before a turn whose prompt
plus output would pass ``context_max``. Replies in the history are the
client's transcript, drawn from the seed at the length asked for, so the
inputs depend on the seed alone. Single-turn sessions without a system
prompt are plain unique prompts. Every request is greedy."""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np

from kfxbench.core.traffic import (Dealer, lognormal_table, seed64,
                                   share_table, uniform_int_table)


def requests(mix: dict, vocab: int, seed: int) -> "ClosedLoop":
    return ClosedLoop(mix, vocab, seed)


class ClosedLoop:
    """The request streams of a ``closed_loop`` mix for one seed."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        self.mix = mix
        self.vocab = vocab
        self.seed = seed64(seed)
        self.clients = mix["clients"]
        # Whole rounds of one size a client.
        n = mix["table"] - mix["table"] % self.clients
        rng = np.random.default_rng([self.seed, 2])
        self.user = Dealer(lognormal_table(mix["user"], n), rng,
                           self.clients)
        self.output = Dealer(lognormal_table(mix["output"], n), rng,
                             self.clients)
        turns = mix.get("turns", {"min": 1, "max": 1})
        self.turns = Dealer(uniform_int_table(turns["min"], turns["max"],
                                              n), rng, self.clients)
        system = mix.get("system")
        self.system: List[List[int]] = []
        self.system_pick: Optional[Dealer] = None
        if system:
            for k in range(system["count"]):
                r = np.random.default_rng([self.seed, 3, k])
                self.system.append(r.integers(
                    0, vocab, system["tokens"]).tolist())
            self.system_pick = Dealer(
                share_table(system["shares"], n), rng, self.clients)
        self.context_max = mix["context_max"]

    def prefill_range(self) -> Tuple[int, int]:
        """The shortest and longest prompt tails the engine prefills: a
        whole first prompt (or, behind a shared system prompt, a single
        token) up to the longest prompt."""
        lo = 1 if self.system else self.mix["user"]["min"]
        return lo, self.context_max - self.mix["output"]["min"]

    def _tokens(self, client: int, j: int, kind: int, n: int) -> List[int]:
        rng = np.random.default_rng([self.seed, 4, client, j, kind])
        return rng.integers(0, self.vocab, n).tolist()

    def stream(self, client: int) -> Iterator[Tuple[List[int], int]]:
        """(prompt ids, max_new_tokens) of ``client``'s requests, forever."""
        j = 0          # requests made
        s = 0          # sessions opened
        while True:
            history: List[int] = []
            if self.system_pick is not None:
                history = list(self.system[self.system_pick(client, s)])
            n_turns = self.turns(client, s)
            s += 1
            for turn in range(n_turns):
                user = self._tokens(client, j, 0, self.user(client, j))
                max_new = self.output(client, j)
                prompt = history + user
                if turn and len(prompt) + max_new > self.context_max:
                    break
                yield prompt, max_new
                reply = self._tokens(client, j, 1, max_new)
                history = prompt + reply
                j += 1
