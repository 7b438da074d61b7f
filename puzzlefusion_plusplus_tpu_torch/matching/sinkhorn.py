"""Log-space Sinkhorn and the Hungarian assignment (port of ``puzzlefusion_plusplus_tpu/
matching/sinkhorn.py``).

``sinkhorn_log`` takes an unnormalised affinity matrix, divides it by tau and alternates row
and column log-sum-exp normalisations ``max_iter`` times over the valid (n_rows, n_cols)
block; padded rows and columns are filled with -1e18 and come out 0. ``hungarian`` is a host
function over scipy's ``linear_sum_assignment`` (test time only, as in the reference).
"""

from __future__ import annotations

import numpy as np
import torch

_NEG = -1e18


def sinkhorn_log(scores: torch.Tensor, n_rows: torch.Tensor, n_cols: torch.Tensor,
                 max_iter: int = 20, tau: float = 0.05) -> torch.Tensor:
    """scores [B, N, M], n_rows/n_cols [B] -> approximately doubly stochastic [B, N, M]."""
    B, N, M = scores.shape
    row_valid = torch.arange(N, device=scores.device)[None, :] < n_rows[:, None]
    col_valid = torch.arange(M, device=scores.device)[None, :] < n_cols[:, None]
    mask = row_valid[:, :, None] & col_valid[:, None, :]
    log_s = torch.where(mask, scores / tau, _NEG)
    for _ in range(max_iter):
        # the row normalisation, then the column normalisation
        log_s = log_s - torch.where(row_valid[:, :, None],
                                    torch.logsumexp(log_s, dim=2, keepdim=True), 0.0)
        log_s = torch.where(mask, log_s, _NEG)
        log_s = log_s - torch.where(col_valid[:, None, :],
                                    torch.logsumexp(log_s, dim=1, keepdim=True), 0.0)
        log_s = torch.where(mask, log_s, _NEG)
    return torch.where(mask, torch.exp(log_s), 0.0)


def hungarian(scores: np.ndarray, n_rows: np.ndarray, n_cols: np.ndarray) -> np.ndarray:
    """The maximum-score assignment of each [n_rows, n_cols] block as a 0/1 matrix shaped
    like ``scores`` [B, N, M] (numpy, on the host)."""
    from scipy.optimize import linear_sum_assignment

    scores = np.asarray(scores)
    out = np.zeros(scores.shape, dtype=np.float32)
    for b in range(scores.shape[0]):
        r, c = int(n_rows[b]), int(n_cols[b])
        if r == 0 or c == 0:
            continue
        ri, ci = linear_sum_assignment(-scores[b, :r, :c])
        out[b, ri, ci] = 1.0
    return out
