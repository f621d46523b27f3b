"""Core enums, option parsing, and configuration.

Behavioral contract mirrored from the reference:
  - element types and their canonical names    (src/sqlite-vector.c:772-790)
  - distance metrics incl. aliases             (src/sqlite-vector.c:798-819)
  - quantization type names                    (src/sqlite-vector.c:792-796)
  - `key=value,key=value` option-string parser (src/sqlite-vector.c:878-992)
  - KB/MB/GB suffix parsing                    (src/sqlite-vector.c:916-933)
  - defaults: FLOAT32 / L2 / 30MB / QUANT_AUTO (src/sqlite-vector.c:71,1100-1112)

Unknown option keys are ignored, malformed pairs are skipped, and the
`normalized` key is parsed but (as in the reference, where it is never used in
any computation — src/sqlite-vector.c:119,966,2533) has no effect.

A copy of sqlite_vector_tpu/types.py: importing that module loads jax
through its package __init__. The enum `.value` strings are identical, so
tests map between the two packages by value.
"""

from __future__ import annotations

import dataclasses
import enum
import math
import re

import numpy as np

from sqlite_vector_tpu_torch.errors import VectorConfigError

# Default working-memory budget for quantization batching
# (reference: src/sqlite-vector.c:71  DEFAULT_MAX_MEMORY = 30MB).
DEFAULT_MAX_MEMORY = 30 * 1024 * 1024

# Fixed registry capacity in the reference (src/sqlite-vector.c:72 MAX_TABLES).
# We keep it as a soft parity constant; our registry is unbounded.
REFERENCE_MAX_TABLES = 128


class VectorType(enum.Enum):
    """Stored element type (reference: vector_type, src/sqlite-vector.h)."""

    F32 = "FLOAT32"
    F16 = "FLOAT16"
    BF16 = "FLOATB16"
    U8 = "UINT8"
    I8 = "INT8"

    @property
    def itemsize(self) -> int:
        return {"FLOAT32": 4, "FLOAT16": 2, "FLOATB16": 2, "UINT8": 1, "INT8": 1}[
            self.value
        ]

    @property
    def np_dtype(self) -> np.dtype:
        if self.value == "FLOATB16":
            import ml_dtypes  # only numpy bfloat16 arrays need it

            return np.dtype(ml_dtypes.bfloat16)
        return {
            "FLOAT32": np.dtype(np.float32),
            "FLOAT16": np.dtype(np.float16),
            "UINT8": np.dtype(np.uint8),
            "INT8": np.dtype(np.int8),
        }[self.value]

    @property
    def host_dtype(self) -> np.dtype:
        """The port's host storage dtype: bfloat16 rows are kept as their
        raw uint16 bits (numpy has no bfloat16 without ml_dtypes)."""
        return np.dtype(np.uint16) if self.value == "FLOATB16" else self.np_dtype

    @classmethod
    def from_name(cls, name: str) -> "VectorType":
        """Case-insensitive name lookup (reference: vector_name_to_type :772)."""
        up = name.strip().upper()
        for t in cls:
            if t.value == up:
                return t
        raise VectorConfigError(
            f"Invalid vector type: '{name}' is not a recognized type."
        )


class DistanceMetric(enum.Enum):
    """Distance metric (reference: vector_distance, aliases at :798-808).

    Semantics (reference: src/distance-cpu.c):
      L2          sqrt(sum((a-b)^2))
      SQUARED_L2  sum((a-b)^2)
      COSINE      1 - dot/(||a||*||b||); 1.0 if either norm is zero
      DOT         -dot(a, b)   (negative inner product, so smaller = closer)
      L1          sum(|a-b|)
    """

    L2 = "L2"
    SQUARED_L2 = "SQUARED_L2"
    COSINE = "COSINE"
    DOT = "DOT"
    L1 = "L1"

    @classmethod
    def from_name(cls, name: str) -> "DistanceMetric":
        up = name.strip().upper()
        aliases = {"EUCLIDEAN": "L2", "INNER": "DOT", "MANHATTAN": "L1"}
        up = aliases.get(up, up)
        for m in cls:
            if m.value == up:
                return m
        raise VectorConfigError(
            f"Invalid distance name: '{name}' is not a recognized or supported distance."
        )


class QuantType(enum.Enum):
    """Quantization target type (reference: vector_qtype).

    AUTO resolves to INT8 iff any stored value is negative, else UINT8
    (reference: src/sqlite-vector.c:1258-1261). AUTO never resolves to
    INT4 — the 4-bit path is explicit opt-in (beyond the reference; see
    ops/quantize4.py), packed two codes per byte with per-row scales.
    """

    AUTO = "AUTO"
    U8 = "UINT8"
    I8 = "INT8"
    I4 = "INT4"

    @property
    def np_dtype(self) -> np.dtype:
        if self is QuantType.U8:
            return np.dtype(np.uint8)
        if self is QuantType.I8:
            return np.dtype(np.int8)
        if self is QuantType.I4:
            # STORAGE dtype of the packed code array (two 4-bit codes per
            # byte; row width is packed_width(dim), not dim)
            return np.dtype(np.uint8)
        raise VectorConfigError("AUTO has no storage dtype until resolved")

    @classmethod
    def from_name(cls, name: str) -> "QuantType":
        up = name.strip().upper()
        if up == "UINT8":
            return cls.U8
        if up == "INT8":
            return cls.I8
        if up == "INT4":
            return cls.I4
        raise VectorConfigError(
            f"Invalid quantization type: '{name}' is not a recognized or supported quantization type."
        )


# The C reference's isspace/isdigit are ASCII; Python's str.isspace/strip
# accept Unicode (NBSP, Arabic-Indic digits) and would silently diverge
_ASCII_SPACE = " \t\n\r\v\f"


def human_to_number(s: str) -> int:
    """Parse a size with optional KB/MB/GB suffix (reference: human_to_number :916).

    Full strtod parity via the codec's number parser: leading whitespace,
    decimal AND hex floats (`0x10KB` == 16384), longest-valid-prefix. The
    suffix comparison is strncasecmp(end, "KB", 2) — case-insensitive on
    its first two chars with anything after them ignored (`5KBx` == 5120).
    Returns 0 on zero value, +-inf, negative, overflow, or invalid suffix —
    the reference's "0 means ignore" convention (:919-932). NaN input falls
    through the reference's checks into a (uint64_t)NaN cast (UB); pinned
    to 0 here.
    """
    from sqlite_vector_tpu_torch.codec import _parse_number  # lazy: import cycle

    i = 0
    while i < len(s) and s[i] in _ASCII_SPACE:
        i += 1
    d, end = _parse_number(s, i)
    if end == i or d == 0 or math.isnan(d) or math.isinf(d):
        return 0
    while end < len(s) and s[end] in _ASCII_SPACE:
        end += 1
    rest = s[end:]
    head = rest[:2].upper()
    if head == "KB":
        d *= 1024
    elif head == "MB":
        d *= 1024 * 1024
    elif head == "GB":
        d *= 1024 * 1024 * 1024
    elif rest != "":
        return 0  # invalid suffix
    if d < 0 or d > float(np.iinfo(np.int64).max):
        return 0
    return int(d)


@dataclasses.dataclass
class VectorOptions:
    """Parsed per-dataset options (reference: vector_options :116-124).

    Defaults mirror vector_options_init (src/sqlite-vector.c:1100-1112).
    """

    type: VectorType = VectorType.F32
    dimension: int = 0
    normalized: bool = False  # parsed but unused, as in the reference
    max_memory: int = DEFAULT_MAX_MEMORY
    distance: DistanceMetric = DistanceMetric.L2
    qtype: QuantType = QuantType.AUTO


def parse_options(
    options: str | None, base: VectorOptions | None = None
) -> VectorOptions:
    """Parse a `key=value,key=value` option string into VectorOptions.

    Mirrors parse_keyvalue_string + vector_keyvalue_callback
    (src/sqlite-vector.c:878-992): malformed pairs are skipped, unknown keys
    are ignored, keys are case-insensitive, values are trimmed.
    """
    opts = dataclasses.replace(base) if base is not None else VectorOptions()
    if not options:
        return opts

    p = 0
    s = options
    n = len(s)
    while p < n:
        while p < n and s[p] in _ASCII_SPACE:  # SKIP_SPACES is ASCII
            p += 1
        key_start = p
        while p < n and s[p] not in "=,":
            p += 1
        key = s[key_start:p].rstrip(_ASCII_SPACE)
        if p >= n or s[p] != "=":
            # malformed pair: skip to next comma
            while p < n and s[p] != ",":
                p += 1
            if p < n:
                p += 1
            continue
        p += 1  # skip '='
        while p < n and s[p] in _ASCII_SPACE:
            p += 1
        val_start = p
        while p < n and s[p] != ",":
            p += 1
        value = s[val_start:p].rstrip(_ASCII_SPACE)
        if p < n:
            p += 1  # skip ','
        _apply_option(opts, key, value)
    return opts


_STRTOL0 = re.compile(
    r"^[ \t\n\r\v\f]*([+-]?)(?:(0[xX][0-9a-fA-F]+)|(0[0-7]*)|([1-9][0-9]*))"
)


def _strtol0(s: str) -> int:
    """C strtol(s, NULL, 0): longest valid prefix, auto base (0x hex, leading
    0 octal), 0 on no parse — the reference parses dimension/normalized with
    exactly this (src/sqlite-vector.c:958, :965)."""
    m = _STRTOL0.match(s)
    if not m:
        return 0
    sign = -1 if m.group(1) == "-" else 1
    if m.group(2):
        return sign * int(m.group(2), 16)
    if m.group(3) is not None:
        g = m.group(3)
        return sign * (int(g, 8) if len(g) > 1 else 0)
    return sign * int(m.group(4))


def _apply_option(opts: VectorOptions, key: str, value: str) -> None:
    if not key or not value:
        # reference aborts the whole option string on an empty key OR value
        # (parse_keyvalue_string returns false); mirror with an error
        raise VectorConfigError("Malformed option: empty key or value.")
    k = key.lower()
    # The reference matches keys with strncasecmp(key, OPTION_NAME, key_len)
    # — i.e. any case-insensitive PREFIX of an option name selects it, in
    # the callback's declaration order, first match wins (:952-989). So
    # 'dim=768' sets dimension, 'dist=cosine' sets distance, and the
    # ambiguous 'd' selects dimension (checked before distance).
    if "type".startswith(k):
        opts.type = VectorType.from_name(value)
    elif "dimension".startswith(k):
        dim = _strtol0(value)
        if dim <= 0:
            raise VectorConfigError(
                f"Invalid vector dimension: expected a positive integer, got '{value}'."
            )
        opts.dimension = dim
    elif "normalized".startswith(k):
        opts.normalized = _strtol0(value) != 0
    elif "max_memory".startswith(k):
        # assigned UNCONDITIONALLY — including 0 on parse failure: the
        # reference's `if (max_memory >= 0)` is always true for uint64
        # (:969-972). DELIBERATE DEVIATION: no (int) narrowing — the
        # reference's cast truncates e.g. 4GB to 0 on 32-bit int; we keep
        # the parsed value (docs/MIGRATION.md deviations)
        opts.max_memory = human_to_number(value)
    elif "qtype".startswith(k):
        opts.qtype = QuantType.from_name(value)
    elif k in ("qscale", "qoffset"):
        # accepted-but-unused here for parity: the reference parses these
        # keys only when restoring from _sqliteai_vector (sqlite.py handles
        # that restoration path directly). strtod never fails, so neither
        # may we (a garbage value parses as 0 and is discarded)
        try:
            float(value)
        except ValueError:
            pass
    elif "distance".startswith(k):
        opts.distance = DistanceMetric.from_name(value)
    # unknown keys are ignored (reference :991)
