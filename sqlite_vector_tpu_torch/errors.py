"""Error types.

The reference reports errors through SQLite result codes plus
`sqlite3_result_error` text (reference: src/sqlite-vector.c:375-417). We use a
single exception hierarchy; error message text follows the reference's wording
where the condition is the same, so drivers / tests migrating from the C
extension can pattern-match messages.
"""


class VectorError(Exception):
    """Base error for all sqlite_vector_tpu_torch failures."""


class VectorConfigError(VectorError):
    """Invalid options / configuration (bad type name, dimension, metric...)."""


class VectorCodecError(VectorError):
    """Malformed JSON vector text or invalid BLOB shape/size."""


class VectorStateError(VectorError):
    """Operation out of order (e.g. quantized scan before quantize())."""
