"""Closed-loop traffic: each client sends its next request as soon as its
last one has finished, with no think time.

The mix file gives the number of clients and, for the prompt and the
output length each, a lognormal law by its mean and log-space ``sigma``
(a heavy tail, as real serving traffic has), cut to ``[min, max]``; each
mix cites where its numbers come from.  The cell's context is the longest
prompt plus the longest output, so no slot reserves room that no request
can fill, and it has one slot a client.

Every client owns a stream of request sizes drawn once (from
:data:`SIZES_SEED`, :data:`STREAM_LEN` requests long), so every run seed
serves the same sizes; ``--seed`` only decides which client gets which
stream and the prompt token ids.  That keeps the work of a run fixed from
seed to seed while the inputs change.

The window opens on a steady state: a client's first request stands for a
request already part-way through its life.  Its prompt is the context it
would have reached (the prompt plus the tokens already generated) and its
budget is what it would have left.  The share of its life already spent
is stratified over the clients, (c + 0.5) / clients.  The requests after
it are drawn afresh from the stream.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

SIZES_SEED = 0
STREAM_LEN = 64


@dataclasses.dataclass(frozen=True)
class Request:
    client: int
    index: int  # 0 = the warm-start request
    prompt: np.ndarray  # int32 token ids
    max_new_tokens: int


def lengths(law: dict, rng: np.random.Generator, shape) -> np.ndarray:
    """Lengths drawn from a lognormal of mean ``law["mean"]`` and log-space
    ``law["sigma"]``, rounded and cut to ``[law["min"], law["max"]]``."""
    sigma = float(law["sigma"])
    mu = math.log(float(law["mean"])) - 0.5 * sigma * sigma
    raw = np.rint(rng.lognormal(mu, sigma, shape))
    return np.clip(raw, int(law["min"]), int(law["max"])).astype(np.int64)


class ClosedLoop:
    def __init__(self, mix: dict, seed: int, vocab_size: int):
        self.clients = int(mix["clients"])
        self.seed = int(seed)
        self.vocab_size = int(vocab_size)
        self.context_len = int(mix["prompt_len"]["max"]) + int(mix["output_len"]["max"])
        sizes = np.random.default_rng(SIZES_SEED)
        shape = (self.clients, STREAM_LEN)
        self.prompt_len = lengths(mix["prompt_len"], sizes, shape)
        self.output_len = lengths(mix["output_len"], sizes, shape)
        self.stream = np.random.default_rng(self.seed).permutation(self.clients)
        self.issued = np.zeros(self.clients, np.int64)

    def _ids(self, client: int, index: int, n: int) -> np.ndarray:
        # Keyed by (seed, client, index): the same ids whatever order the
        # clients' requests come in.
        rng = np.random.default_rng((self.seed, client, index))
        return rng.integers(0, self.vocab_size, n).astype(np.int32)

    def _sizes(self, client: int, index: int) -> tuple[int, int]:
        s = self.stream[client]
        j = index % STREAM_LEN
        return int(self.prompt_len[s, j]), int(self.output_len[s, j])

    def first(self) -> list[Request]:
        """Every client's warm-start request."""
        out = []
        for c in range(self.clients):
            p, o = self._sizes(c, 0)
            done = int((self.stream[c] + 0.5) / self.clients * o)
            out.append(Request(c, 0, self._ids(c, 0, p + done), o - done))
            self.issued[c] = 1
        return out

    def next(self, client: int) -> Request:
        """The client's next request."""
        j = int(self.issued[client])
        self.issued[client] += 1
        p, o = self._sizes(client, j)
        return Request(client, j, self._ids(client, j, p), o)
