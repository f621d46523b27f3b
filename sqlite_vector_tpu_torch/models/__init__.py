"""Embedding-model integration — the ingestion side of the search engine.

The reference has no model layer (vectors arrive as BLOBs; its example uses
sentence-transformers externally). This package hosts the embedder protocol
and built-in encoders that feed Datasets (port of
sqlite_vector_tpu/models/):

    from sqlite_vector_tpu_torch.models import get_embedder
    emb = get_embedder()               # best available
    ds.add(emb.encode(["some text"]))
"""

from sqlite_vector_tpu_torch.models.embedders import (
    DIM,
    Embedder,
    HashEmbedder,
    RandomProjectionEmbedder,
    SentenceTransformerEmbedder,
    get_embedder,
)

__all__ = [
    "DIM",
    "Embedder",
    "HashEmbedder",
    "RandomProjectionEmbedder",
    "SentenceTransformerEmbedder",
    "get_embedder",
]
