"""The one traffic generator, as a traffic mix's file describes it: a
closed loop of `clients` threads, each with one request in flight
(VectorDBBench's concurrency model).

Through the entry `search`, a client calls Dataset.search on one query;
through `batching`, it submits the query to a BatchingSearcher and waits
for its Future. Either way it sends its next query as soon as the answer
is back. Client c walks the query pool from its own offset, so every seed
sends the same sizes in another order.

The clients run through the warm-up and the window without a pause: the
window opens on traffic that is already steady. A request belongs to the
window when it was sent inside it; one still in flight when the window
closes is waited for, and counts in the latencies but not in the window's
completions. The window's rate counts every answer that came inside it.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Window:
    seconds: float = 0.0
    open_at: float = 0.0  # perf_counter
    close_at: float = 0.0
    sent: np.ndarray = field(default_factory=lambda: np.zeros(0))  # s from open_at
    done: np.ndarray = field(default_factory=lambda: np.zeros(0))
    answers: list = field(default_factory=list)  # (pool index, query, answer or None)
    completions: int = 0  # answers that came back inside the window

    @property
    def attempted(self) -> int:
        return len(self.answers)

    def latencies(self) -> np.ndarray:
        """Every request's latency, s; +inf for one that failed."""
        lat = self.done - self.sent
        return np.where([a is None for _, _, a in self.answers], np.inf, lat)


class Clients:
    """`n` closed-loop clients over the pool, each calling
    `call(query) -> answer` and waiting for it."""

    def __init__(self, call, pool: np.ndarray, n: int):
        self.call, self.pool, self.n = call, pool, n
        self.open_at = self.close_at = self.stop_at = float("inf")
        self._logs = [[] for _ in range(n)]
        self._done = [0] * n  # each client's answers inside the window
        self._errors: list = []
        self._threads = [threading.Thread(target=self._client, args=(c,), daemon=True) for c in range(n)]

    def start(self) -> None:
        for t in self._threads:
            t.start()

    def _client(self, c: int) -> None:
        p = len(self.pool)
        i = c * p // self.n
        log = self._logs[c]
        while True:
            t0 = time.perf_counter()
            if t0 >= self.stop_at and t0 >= self.close_at:
                return
            k = i % p
            answer = self._answer(self.pool[k])
            t1 = time.perf_counter()
            if self.open_at <= t0 < self.close_at:
                log.append((t0, t1, k, answer))
            if self.open_at <= t1 < self.close_at:
                self._done[c] += 1
            i += 1

    def _answer(self, query):
        """call(query)'s answer, or None for a request that failed
        (counted, not fatal)."""
        try:
            return self.call(query)
        except Exception as e:
            if len(self._errors) < 3:
                self._errors.append(repr(e))
            return None

    def stop(self, timeout: float = 120.0) -> None:
        """Ask every client to stop after its request in flight, and wait."""
        self.stop_at = time.perf_counter()
        deadline = time.monotonic() + timeout
        for t in self._threads:
            t.join(max(0.0, deadline - time.monotonic()))
        if any(t.is_alive() for t in self._threads):
            raise RuntimeError("a client did not finish its request")

    @property
    def errors(self) -> list:
        return list(self._errors)

    def window(self) -> Window:
        rows = sorted((r for log in self._logs for r in log), key=lambda r: r[0])
        w = Window(seconds=self.close_at - self.open_at, open_at=self.open_at, close_at=self.close_at)
        w.sent = np.array([r[0] - self.open_at for r in rows])
        w.done = np.array([r[1] - self.open_at for r in rows])
        w.answers = [(r[2], self.pool[r[2]], r[3]) for r in rows]
        w.completions = sum(self._done)
        return w
