"""Quantization pipeline (device side, plain PyTorch).

Port of sqlite_vector_tpu/ops/quantize.py; codes and params are
bit-equal to it:

  pass 1  min/max + any-negative over valid rows (NaN skipped, +-Inf kept)
  resolve AUTO -> INT8 iff any negative, scale/offset in float32
          (resolve_quant_params, numpy, copied verbatim)
  pass 2  element-wise (x - offset) * scale, q_round, saturating cast

Every step is a separate float32 torch op, so nothing fuses into a
differently rounded fma.

The host-storage build runs the same two passes over row chunks brought
to the device one at a time, folding pass 1 into fold_stats.
"""

from __future__ import annotations

import numpy as np
import torch

from sqlite_vector_tpu_torch.types import QuantType

# rows per chunk of the min/max pass: bounds its float32 temporaries
_MINMAX_CHUNK_ELEMS = 1 << 26

QUANT_TORCH_DTYPE = {QuantType.U8: torch.uint8, QuantType.I8: torch.int8}


def minmax_and_negative(
    base: torch.Tensor, valid_count: int | None = None
) -> tuple[float, float, bool]:
    """Global (min, max, any_negative) over rows [0, valid_count).

    NaN elements are skipped (C comparisons are false for NaN —
    src/sqlite-vector.c:1254-1256); +-Inf propagates into min/max. With no
    non-NaN value, min is FLT_MAX and max is -FLT_MAX.
    """
    n = base.shape[0] if valid_count is None else int(valid_count)
    big = float(np.finfo(np.float32).max)
    mn, mx, neg = big, -big, False
    rows = max(1, _MINMAX_CHUNK_ELEMS // max(1, base.shape[1]))
    for s in range(0, n, rows):
        x = base[s : min(s + rows, n)].float()
        nan = torch.isnan(x)
        mn = min(mn, float(torch.where(nan, big, x).amin()))
        mx = max(mx, float(torch.where(nan, -big, x).amax()))
        neg = neg or bool((x < 0).any())  # NaN < 0 is False
    return mn, mx, neg


def resolve_quant_params(
    mn: float, mx: float, any_negative: bool, qtype: QuantType
) -> tuple[QuantType, np.float32, np.float32]:
    """AUTO resolution + scale/offset (host-side, float32 math).

    Mirrors src/sqlite-vector.c:1258-1268:
      u8: scale = 255/(max-min), offset = min
      s8: scale = 127/max(|min|,|max|), offset = 0 (symmetric)
    """
    if qtype is QuantType.AUTO:
        qtype = QuantType.I8 if any_negative else QuantType.U8
    # C-init clamps (oracle.compute_quant_params parity; the reference
    # initializes min=FLT_MAX / max=-FLT_MAX, so +Inf can never raise min
    # above FLT_MAX nor -Inf lower max below -FLT_MAX, :1202-1252) — the
    # raw device reduce propagates +-Inf and would otherwise install a NaN
    # scale for non-finite-only columns, poisoning every later query
    flt_max = float(np.finfo(np.float32).max)
    mn32 = np.float32(min(float(mn), flt_max))
    mx32 = np.float32(max(float(mx), -flt_max))
    if float(mn32) > float(mx32):
        # no valid (non-NaN) values were scanned: the reference's
        # no-rows params (:1173-1178), matching the oracle's all-NaN case
        return qtype, np.float32(1.0), np.float32(0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        if qtype is QuantType.U8:
            scale = np.float32(255.0) / (mx32 - mn32)
            offset = mn32
        else:
            abs_max = np.float32(max(abs(float(mn32)), abs(float(mx32))))
            scale = np.float32(127.0) / abs_max
            offset = np.float32(0.0)
    return qtype, np.float32(scale), np.float32(offset)


def fold_stats(stats: dict | None, x: torch.Tensor) -> dict:
    """Fold float32 rows x into the running quantize statistics
    {n_notnan, min_val, max_val, neg} of a chunked build (None starts
    afresh): NaN skipped, +-Inf kept, each step rounded to float32. The
    JAX package keeps the same JSON-serializable dict (oracle.
    accumulate_quant_stats) and persists it with each chunk's progress, so
    the two packages resume each other's checkpoints."""
    if stats is None:
        big = float(np.finfo(np.float32).max)
        stats = {"n_notnan": 0, "min_val": big, "max_val": -big, "neg": False}
    n = int((~torch.isnan(x)).sum()) if x.numel() else 0
    if n:
        mn, mx, neg = minmax_and_negative(x)
        stats["n_notnan"] += n
        stats["min_val"] = float(np.float32(min(float(np.float32(stats["min_val"])), mn)))
        stats["max_val"] = float(np.float32(max(float(np.float32(stats["max_val"])), mx)))
        stats["neg"] = stats["neg"] or neg
    return stats


def _q_round(s: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """q_round_u8/q_round_s8 (src/sqlite-vector.c:495-515): half away from
    zero, truncating cast, saturate; NaN -> 0, +Inf -> hi, -Inf -> lo."""
    r = s + 0.5 * (1.0 - 2.0 * (s < 0).float())
    out = torch.clamp(torch.trunc(r), lo, hi)
    nf = torch.where(s > 0, hi, torch.where(s < 0, lo, 0.0))
    return torch.where(torch.isfinite(s), out, nf)


def quantize_device(
    base: torch.Tensor,
    scale: float | np.float32,
    offset: float | np.float32,
    qtype: QuantType,
) -> torch.Tensor:
    """Element-wise quantize: (x - offset) * scale, q_round, cast.

    Matches quantize_<src>_to_<dst> (src/sqlite-vector.c:517-732) with the
    guarded q_round semantics for every source (identical for finite
    inputs).
    """
    if qtype not in QUANT_TORCH_DTYPE:
        raise ValueError("quantize_device() requires a resolved qtype (U8 or I8)")
    # 0-dim float32 tensors: the arithmetic is float32 end to end
    off = torch.tensor(np.float32(offset), device=base.device)
    sc = torch.tensor(np.float32(scale), device=base.device)
    s = (base.float() - off) * sc
    lo, hi = (0.0, 255.0) if qtype is QuantType.U8 else (-128.0, 127.0)
    return _q_round(s, lo, hi).to(QUANT_TORCH_DTYPE[qtype])
