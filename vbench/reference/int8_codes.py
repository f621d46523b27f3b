"""Plain reference of a search over int8 codes built with sqlite-vector's
global min-max quantization (vector_quantize, qtype INT8): one pass over
every row for the global min and max, scale = 127 / max(|min|, |max|) in
float32, offset 0; a code is (x - 0) * scale in float32, rounded half away
from zero as the C code does (adding +-0.5 in float32, then truncating)
and saturated to [-128, 127]. Queries are coded with the same scale.
Distances are the integer domain's: the dot and the squared norms of the
codes summed exactly (float64 holds every sum at these widths), then the
metric in float64.

The control (precision="control") is the same search over int4 codes one
step down: scale = 7 / max(|min|, |max|), saturated to [-8, 7].

Plain torch and numpy; imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch


class Reference:
    def __init__(self, cfg: dict, precision: str = "reference"):
        if cfg["metric"] not in ("COSINE", "L2", "SQUARED_L2", "DOT"):
            raise ValueError(f"no reference for metric {cfg['metric']}")
        self.metric = cfg["metric"]
        self.levels, self.lo, self.hi = (7, -8, 7) if precision == "control" else (127, -128, 127)
        self.scale = None

    def fit(self, chunks) -> None:
        """The global min and max over every row, then the scale."""
        mn, mx = np.float32(np.inf), np.float32(-np.inf)
        for _, x in chunks:
            mn = min(mn, np.float32(x.amin().item()))
            mx = max(mx, np.float32(x.amax().item()))
        self.scale = np.float32(self.levels) / np.float32(max(abs(mn), abs(mx)))

    def codes(self, x: torch.Tensor) -> torch.Tensor:
        s = (x.float() - 0.0) * torch.tensor(self.scale, device=x.device)
        r = torch.trunc(s + torch.where(s < 0, -0.5, 0.5))
        return r.clamp(self.lo, self.hi).to(torch.int8)

    def queries(self, q: torch.Tensor) -> torch.Tensor:
        return self.codes(q)

    def distances(self, qc: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """[S, m] float64 integer-domain distances of the coded queries to
        the rows, coded here."""
        qd, rd = qc.double(), self.codes(rows).double()
        dot = qd @ rd.T
        if self.metric == "DOT":
            return -dot
        q_sq = (qd * qd).sum(1)
        r_sq = (rd * rd).sum(1)
        if self.metric in ("L2", "SQUARED_L2"):
            d = q_sq[:, None] + r_sq[None, :] - 2.0 * dot
            return d.sqrt() if self.metric == "L2" else d
        denom = q_sq.sqrt()[:, None] * r_sq.sqrt()[None, :]
        return torch.where(denom > 0, 1.0 - dot / torch.where(denom > 0, denom, 1.0), 1.0)
