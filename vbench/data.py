"""Rows and queries drawn from the run's seed, on the device.

Rows are unit-normalised N(0, 1) draws (the real Cohere embeddings are not
in the repository), made chunk by chunk: chunk c comes from a generator of
its own, seeded from (seed, c), so the program's set-up and the plain
reference draw the same rows on the same device without holding them all
at once. Queries are made once, before the window: a share of them are
base rows with a little noise added (each has a near neighbour at a small
distance), the rest fresh draws; they are handed to the program and to the
reference alike as one float32 host array.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

ROW_CHUNK = 1 << 18  # rows a generated chunk: 768 MB of float32 at d = 768

_ROWS, _QUERIES, _NEAR, _ORDER, _SAMPLE = range(5)


def substream(seed: int, stream: int, index: int = 0) -> int:
    """A 63-bit seed for one stream of draws of a run: any whole seed,
    however large, gives well-mixed and independent streams."""
    state = np.random.SeedSequence([int(seed) % (1 << 128), stream, index]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(substream(seed, stream))


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


def _normal(shape: tuple, seed: int, device: torch.device) -> torch.Tensor:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randn(shape, generator=g, device=device, dtype=torch.float32)


def row_chunks(seed: int, n: int, d: int, device, chunk: int = ROW_CHUNK) -> Iterator[tuple[int, torch.Tensor]]:
    """(first row, rows [m, d] float32 on `device`) for every chunk of the
    n rows, in order."""
    device = torch.device(device)
    for c, start in enumerate(range(0, n, chunk)):
        m = min(chunk, n - start)
        yield start, _unit(_normal((m, d), substream(seed, _ROWS, c), device))


class QueryPlan:
    """The query pool of a run: which queries sit near which base rows."""

    def __init__(self, seed: int, n: int, d: int, pool: int, near_share: float, noise: float, device):
        self.seed, self.n, self.d, self.pool, self.noise = seed, n, d, pool, noise
        self.device = torch.device(device)
        r = rng(seed, _NEAR)
        n_near = int(round(pool * near_share))
        self.near_pos = np.sort(r.choice(n, size=n_near, replace=False))
        self._near_rows = torch.empty((n_near, d), dtype=torch.float32, device=self.device)

    def take(self, start: int, rows: torch.Tensor) -> None:
        """Keep the near queries' base rows found in one chunk of rows."""
        lo, hi = np.searchsorted(self.near_pos, [start, start + rows.shape[0]])
        if hi > lo:
            pos = torch.as_tensor(self.near_pos[lo:hi] - start, device=self.device)
            self._near_rows[lo:hi] = rows[pos]

    def queries(self) -> np.ndarray:
        """The pool [pool, d] float32, near and fresh queries shuffled
        together, once every chunk has been taken."""
        n_near = len(self.near_pos)
        g = _normal((n_near, self.d), substream(self.seed, _QUERIES, 0), self.device)
        near = _unit(self._near_rows + self.noise * _unit(g))
        fresh = _unit(_normal((self.pool - n_near, self.d), substream(self.seed, _QUERIES, 1), self.device))
        q = torch.cat([near, fresh]).cpu().numpy()
        return q[rng(self.seed, _ORDER).permutation(self.pool)]


def sample(seed: int, population: int, size: int) -> np.ndarray:
    """Sorted indices of `size` of `population` items, drawn from the seed."""
    size = min(size, population)
    return np.sort(rng(seed, _SAMPLE).choice(population, size=size, replace=False))
