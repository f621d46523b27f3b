"""Plain reference of an exact search over float32 rows: every distance of
a query to a row computed in float64 from the float32 values, with the
formulas of int8_codes.py (the dot and the squared norms, then the
metric).

The control (precision="control") is the same search one precision step
down: queries and rows rounded to TF32 (10 mantissa bits, to nearest, ties
to even) before the float64 arithmetic. TF32 is what a float32 matrix
product takes on the H100's tensor cores when it is allowed to.

Plain torch; imports nothing of the program. A Reference switches TF32
off for the process's float32 matrix products (the harness builds it once
the program's window has closed).
"""

from __future__ import annotations

import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32, to nearest with ties to even, on the
    bits: the 13 low mantissa bits cleared after adding half their weight
    less one, plus the kept part's lowest bit."""
    b = x.float().contiguous().view(torch.int32)
    r = (b + (0x0FFF + ((b >> 13) & 1))) & -0x2000
    return r.view(torch.float32)


class Reference:
    def __init__(self, cfg: dict, precision: str = "reference"):
        if cfg["metric"] not in ("COSINE", "L2", "SQUARED_L2", "DOT"):
            raise ValueError(f"no reference for metric {cfg['metric']}")
        # the products below in full precision, whatever the process allowed
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.metric = cfg["metric"]
        self.round = tf32 if precision == "control" else (lambda x: x.float())

    def fit(self, chunks) -> None:
        """Nothing to learn from the rows."""

    def queries(self, q: torch.Tensor) -> torch.Tensor:
        return self.round(q).double()

    def distances(self, qd: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """[S, m] float64 distances of the queries (from queries()) to the
        rows."""
        rd = self.round(rows).double()
        dot = qd @ rd.T
        if self.metric == "DOT":
            return -dot
        q_sq = (qd * qd).sum(1)
        r_sq = (rd * rd).sum(1)
        if self.metric in ("L2", "SQUARED_L2"):
            # float64 leaves a residual of ~1e-16 where a row equals its
            # query; the clamp keeps its square root real
            d = (q_sq[:, None] + r_sq[None, :] - 2.0 * dot).clamp(min=0.0)
            return d.sqrt() if self.metric == "L2" else d
        denom = q_sq.sqrt()[:, None] * r_sq.sqrt()[None, :]
        return torch.where(denom > 0, 1.0 - dot / torch.where(denom > 0, denom, 1.0), 1.0)
