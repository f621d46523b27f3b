"""The table of peaks and the scan's bound, frozen here as the yardstick
(copied from chip_smoke.py's `bound` and `k1_bound`, which later changes to
the program may move; this copy stays).

Published peaks of one NVIDIA H100 SXM at its 700 W limit: 3.35 TB/s of
HBM; dense tensor-core rates of 495 TFLOP/s (TF32), 989 TFLOP/s (16-bit)
and 1,979 TOP/s (int8).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"tf32": 495e12, "int8": 1979e12, "fp16": 989e12}

GROUP = 128  # rows per minimum the scan writes


def bound(nbytes: float, ops: float, peak: str) -> tuple[float, str]:
    """The least ms the card could take: the larger of the bytes over the
    HBM rate and the operations over the type's peak, and which of the two
    it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[peak] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bound(b: int, n: int, d: int, elem: int, masked: bool = False) -> tuple[float, str]:
    """The scan's bound for the dot-family metrics: queries and rows read
    once (plus a mask byte a row), the [B, ceil(N/128)] float32 minima
    written once; 2 B N d products, each three TF32 products for 4-byte
    rows (the 3xTF32 split, the cheapest float32-accurate product on the
    card), one 16-bit product for 2-byte rows and one int8 product for
    1-byte codes."""
    nbytes = (b + n) * d * elem + b * -(-n // GROUP) * 4 + (n if masked else 0)
    if elem == 4:
        return bound(nbytes, 3 * 2.0 * b * n * d, "tf32")
    return bound(nbytes, 2.0 * b * n * d, "fp16" if elem == 2 else "int8")


# bytes an element of the rows a scan reads, by the configuration's row
# type, or by its code type where the scan reads codes
ELEM_BYTES = {"FLOAT32": 4, "FLOAT16": 2, "FLOATB16": 2, "UINT8": 1, "INT8": 1, "int8": 1, "uint8": 1}


def scan_elem(cfg: dict) -> int:
    """Bytes an element of what the configuration's search scans."""
    quant = cfg.get("quantize")
    if cfg["mode"] in ("quantized", "rerank") and quant:
        return ELEM_BYTES[quant["qtype"]]
    return ELEM_BYTES[cfg["type"]]
