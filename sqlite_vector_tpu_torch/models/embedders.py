"""Text embedders.

A copy of sqlite_vector_tpu/models/embedders.py (numpy only; the JAX
package's module cannot be imported without loading jax), so the two
packages' offline embedders give the same vectors bit for bit.

`SentenceTransformerEmbedder` matches the reference example's model
(all-MiniLM-L6-v2, 384-dim — reference: examples/semantic_search). The
offline embedders need no weights and keep the full pipeline runnable in
air-gapped environments; they capture lexical similarity only.
"""

from __future__ import annotations

import hashlib
from typing import Protocol, Sequence

import numpy as np

DIM = 384


class Embedder(Protocol):
    """Anything that maps texts to fixed-dimension float32 vectors."""

    name: str
    dim: int

    def encode(self, texts: Sequence[str]) -> np.ndarray: ...


class HashEmbedder:
    """Deterministic offline embedder: hashed 3-5-gram random projection.

    Every character n-gram deterministically seeds a gaussian direction; a
    text's embedding is the L2-normalized sum over its n-grams. No weights,
    no downloads, stable across processes.
    """

    name = "hashed-ngram-384"

    def __init__(self, dim: int = DIM, seed: int = 1234):
        self.dim = dim
        self._seed = seed
        self._cache: dict[str, np.ndarray] = {}

    def _gram_vector(self, gram: str) -> np.ndarray:
        v = self._cache.get(gram)
        if v is None:
            h = hashlib.blake2b(gram.encode(), digest_size=8).digest()
            rng = np.random.default_rng(int.from_bytes(h, "little") ^ self._seed)
            v = rng.standard_normal(self.dim).astype(np.float32)
            if len(self._cache) < 200_000:
                self._cache[gram] = v
        return v

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, text in enumerate(texts):
            t = " ".join(text.lower().split())
            acc = np.zeros(self.dim, np.float32)
            count = 0
            for n in (3, 4, 5):
                for j in range(max(len(t) - n + 1, 0)):
                    acc += self._gram_vector(t[j : j + n])
                    count += 1
            if count:
                norm = float(np.linalg.norm(acc))
                acc /= norm or 1.0
            out[i] = acc
        return out


class RandomProjectionEmbedder:
    """Offline embedder for token sequences: hashed bag-of-words projection.

    Faster than HashEmbedder on long documents (one direction per word)."""

    name = "hashed-bow-384"

    def __init__(self, dim: int = DIM, seed: int = 99):
        self.dim = dim
        self._seed = seed
        self._cache: dict[str, np.ndarray] = {}  # per-word direction

    def _word_vector(self, word: str) -> np.ndarray:
        v = self._cache.get(word)
        if v is None:
            h = hashlib.blake2b(word.encode(), digest_size=8).digest()
            rng = np.random.default_rng(int.from_bytes(h, "little") ^ self._seed)
            v = rng.standard_normal(self.dim).astype(np.float32)
            self._cache[word] = v
        return v

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, text in enumerate(texts):
            acc = np.zeros(self.dim, np.float32)
            for word in text.lower().split():
                acc += self._word_vector(word)  # cached: repeats are free
            norm = float(np.linalg.norm(acc))
            out[i] = acc / (norm or 1.0)
        return out


class SentenceTransformerEmbedder:
    """The reference example's model (requires local weights)."""

    name = "all-MiniLM-L6-v2"
    dim = DIM

    def __init__(self):
        import os

        # local weights only — never hit the network (air-gap friendly);
        # raises immediately when the model isn't cached, letting
        # get_embedder() fall back to the offline embedder. The env override
        # is scoped to construction: mutating it process-wide would break a
        # user's own later huggingface downloads after our fallback.
        saved = {
            k: os.environ.get(k)
            for k in ("HF_HUB_OFFLINE", "TRANSFORMERS_OFFLINE")
        }
        os.environ["HF_HUB_OFFLINE"] = "1"
        os.environ["TRANSFORMERS_OFFLINE"] = "1"
        try:
            from sentence_transformers import SentenceTransformer

            self.model = SentenceTransformer("all-MiniLM-L6-v2")
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        return np.asarray(self.model.encode(list(texts)), np.float32)


def get_embedder() -> Embedder:
    """Best available embedder: the real sentence model when its weights are
    installed, otherwise the offline hashed-n-gram fallback."""
    try:
        return SentenceTransformerEmbedder()
    except Exception:
        return HashEmbedder()
