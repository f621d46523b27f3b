"""Vector codec: JSON text <-> typed little-endian blobs <-> numpy arrays.

Mirrors the reference's codec layer (src/sqlite-vector.c:1528-1719):

  - `vector_from_json` parses a JSON array `[x, y, ...]` into a typed
    little-endian blob. Quirks preserved: leading/trailing whitespace is
    allowed, a trailing comma before `]` is tolerated (:1627-1635), i8/u8
    values are range-checked (:1601-1615), a `dimension` argument (when > 0)
    enforces an exact element count (:1646).
  - `vector_as_blob` is the vector_as_{f32,f16,bf16,i8,u8} family (:1655-1719):
    BLOB inputs are validated (size must be a multiple of the element size;
    exact size when a dimension is given) and passed through unchanged; TEXT
    inputs go through the JSON parser.

Everything is little-endian, matching the reference's on-disk format, so blobs
produced here are byte-compatible with databases written by the C extension.

A copy of sqlite_vector_tpu/codec.py (which cannot be imported without
loading jax) minus its optional native parser: the pure-Python parser is
the one this package runs.
"""

from __future__ import annotations

import math

import numpy as np

from sqlite_vector_tpu_torch.errors import VectorCodecError
from sqlite_vector_tpu_torch.types import VectorType


# ASCII character classes — the C reference's isdigit/isspace operate on
# ASCII; Python's str.isdigit()/isspace() accept Unicode digits (e.g. '²',
# '٣') and NBSP, which must NOT parse (they either crash float() or
# silently diverge from the native strtod path)
_DIGITS = frozenset("0123456789")
_HEXDIGITS = frozenset("0123456789abcdefABCDEF")
_SPACE = frozenset(" \t\n\r\v\f")


def _parse_number(s: str, p: int) -> tuple[float, int]:
    """strtod-equivalent: parse the longest valid number starting at s[p].

    Returns (value, end_index); end_index == p means parse failure.
    """
    n = len(s)
    i = p
    if i < n and s[i] in "+-":
        i += 1
    # hex floats: strtod (and therefore the native path + the C reference)
    # accepts 0x1A / -0x1.8p3 — the fallback must parse identically
    if i + 1 < n and s[i] == "0" and s[i + 1] in "xX":
        j = i + 2
        hd = 0
        while j < n and s[j] in _HEXDIGITS:
            j += 1
            hd += 1
        fd = 0
        if j < n and s[j] == ".":
            j += 1
            while j < n and s[j] in _HEXDIGITS:
                j += 1
                fd += 1
        if hd + fd == 0:
            # '0x' with no hex digits: strtod consumes just the '0'
            return 0.0, i + 1
        end = j
        if j < n and s[j] in "pP":
            m = j + 1
            if m < n and s[m] in "+-":
                m += 1
            if m < n and s[m] in _DIGITS:
                while m < n and s[m] in _DIGITS:
                    m += 1
                end = m
        try:
            return float.fromhex(s[p:end]), end
        except ValueError:
            return 0.0, p
        except OverflowError:
            # strtod saturates an over-range hex float to +-HUGE_VAL;
            # float.fromhex raises instead — mirror the saturation
            return (-math.inf if s[p] == "-" else math.inf), end
    int_digits = 0
    while i < n and s[i] in _DIGITS:
        i += 1
        int_digits += 1
    frac_digits = 0
    if i < n and s[i] == ".":
        i += 1
        while i < n and s[i] in _DIGITS:
            i += 1
            frac_digits += 1
    if int_digits == 0 and frac_digits == 0:
        # strtod also accepts inf/nan; JSON arrays from the reference never
        # contain them, but strtod would parse them — mirror that.
        rest = s[p:p + 9].lower()
        for tok, val in (("infinity", 8), ("inf", 3), ("nan", 3)):
            body = rest[1:] if rest[:1] in "+-" else rest
            if body.startswith(tok):
                off = (1 if rest[:1] in "+-" else 0) + val
                sign = -1.0 if rest[:1] == "-" else 1.0
                v = float("nan") if tok == "nan" else sign * float("inf")
                return v, p + off
        return 0.0, p
    end = i
    if i < n and s[i] in "eE":
        j = i + 1
        if j < n and s[j] in "+-":
            j += 1
        if j < n and s[j] in _DIGITS:
            while j < n and s[j] in _DIGITS:
                j += 1
            end = j
    try:
        return float(s[p:end]), end
    except ValueError:  # defensive: surface as a parse failure, not a crash
        return 0.0, p


def vector_from_json(
    json_text: str, vtype: VectorType, dimension: int = 0
) -> np.ndarray:
    """Parse a JSON array into a typed numpy vector.

    Mirrors vector_from_json (src/sqlite-vector.c:1528-1652) including its
    error messages and edge-case tolerance.
    """
    s = json_text
    n = len(s)
    p = 0
    while p < n and s[p] in _SPACE:
        p += 1
    if p >= n or s[p] != "[":
        raise VectorCodecError(
            "Malformed JSON: expected '[' at the beginning of the array."
        )
    p += 1
    start = p

    # The reference scans a NUL-terminated string (:1563-1641): EOF at the
    # loop top (right after '[' or after a comma+spaces) falls out of
    # `while (*p)` and is ACCEPTED; EOF right after a number hits the
    # unexpected-character branch with '?'; EOF after '['+whitespace hits
    # the expected-a-number branch. Mirror each state exactly.
    values: list[float] = []
    while p < n:
        while p < n and s[p] in _SPACE:
            p += 1
        if p < n and s[p] == "]":
            break
        value, end = _parse_number(s, p)
        if end == p:
            ch = s[p] if p < n else "?"
            raise VectorCodecError(
                f"Malformed JSON: expected a number at position {p - start + 1} (found '{ch}')."
            )
        if vtype is VectorType.U8 and not (0 <= value <= 255):
            raise VectorCodecError("Value out of range for uint8_t.")
        if vtype is VectorType.I8 and not (-128 <= value <= 127):
            raise VectorCodecError("Value out of range for int8_t.")
        values.append(value)
        p = end
        while p < n and s[p] in _SPACE:
            p += 1
        if p < n and s[p] == ",":
            p += 1
            while p < n and s[p] in _SPACE:
                p += 1
            if p < n and s[p] == "]":
                break  # trailing comma tolerated (:1627-1635)
        elif p < n and s[p] == "]":
            break
        else:
            # includes EOF right after a number: reference reports '?'
            ch = s[p] if p < n else "?"
            raise VectorCodecError(
                f"Malformed JSON: unexpected character '{ch}' at position {p - start + 1}."
            )

    if dimension > 0 and dimension != len(values):
        raise VectorCodecError(
            f"Invalid JSON vector dimension: expected {dimension} but found {len(values)}."
        )

    arr64 = np.asarray(values, dtype=np.float64)
    if vtype in (VectorType.U8, VectorType.I8):
        # C casts the double directly (truncation toward zero)
        return arr64.astype(vtype.np_dtype)
    return arr64.astype(np.float32).astype(vtype.np_dtype)


def vector_as_blob(
    value: str | bytes | np.ndarray, vtype: VectorType, dimension: int = 0
) -> bytes:
    """The vector_as_{f32,f16,bf16,i8,u8} family (src/sqlite-vector.c:1655-1719).

    - bytes: validated (size % itemsize == 0; exact size if dimension given)
      and passed through unchanged.
    - str: parsed as a JSON array.
    - np.ndarray: cast to the target dtype and serialized little-endian.
    """
    if isinstance(value, (bytes, bytearray, memoryview)):
        blob = bytes(value)
        if len(blob) % vtype.itemsize != 0:
            raise VectorCodecError(
                f"Invalid BLOB size for format '{vtype.value}': size must be a "
                f"multiple of {vtype.itemsize} bytes."
            )
        if dimension > 0:
            expected = vtype.itemsize * dimension
            if len(blob) != expected:
                raise VectorCodecError(
                    f"Invalid BLOB size for format '{vtype.value}': expected "
                    f"dimension should be {dimension} (BLOB is {len(blob)} bytes "
                    f"instead of {expected})."
                )
        return blob
    if isinstance(value, str):
        return array_to_blob(vector_from_json(value, vtype, dimension))
    if isinstance(value, np.ndarray):
        arr = np.atleast_1d(np.asarray(value))
        if dimension > 0 and arr.shape[-1] != dimension:
            raise VectorCodecError(
                f"Invalid JSON vector dimension: expected {dimension} but found {arr.shape[-1]}."
            )
        # same range contract as the TEXT path (:1601-1615): astype would
        # silently wrap out-of-range values into the on-disk format
        if vtype is VectorType.U8 and arr.size and (
            arr.min() < 0 or arr.max() > 255
        ):
            raise VectorCodecError("Value out of range for uint8_t.")
        if vtype is VectorType.I8 and arr.size and (
            arr.min() < -128 or arr.max() > 127
        ):
            raise VectorCodecError("Value out of range for int8_t.")
        return array_to_blob(arr.astype(vtype.np_dtype))
    raise VectorCodecError(
        "Unsupported input type: only BLOB and TEXT values are accepted "
        f"(received {type(value).__name__})."
    )


def array_to_blob(arr: np.ndarray) -> bytes:
    """Serialize an array to the little-endian wire format."""
    a = np.ascontiguousarray(arr)
    if a.dtype.byteorder == ">":  # big-endian host arrays: force LE
        a = a.astype(a.dtype.newbyteorder("<"))
    return a.tobytes()


def blob_to_array(blob: bytes, vtype: VectorType, dimension: int = 0) -> np.ndarray:
    """Decode a little-endian typed blob into a numpy vector.

    If dimension > 0, the blob must contain at least `dimension` elements
    (the reference's scan path validates `blob_size >= dim*itemsize` and reads
    only the first dim elements — src/sqlite-vector.c:1221-1224).
    """
    if len(blob) % vtype.itemsize != 0:
        raise VectorCodecError(
            f"Invalid BLOB size for format '{vtype.value}': size must be a "
            f"multiple of {vtype.itemsize} bytes."
        )
    arr = np.frombuffer(blob, dtype=vtype.np_dtype)
    if dimension > 0:
        if arr.size < dimension:
            raise VectorCodecError("Invalid vector blob: too small for dimension.")
        arr = arr[:dimension]
    return arr
