"""NeRF frequency embedding + sinusoidal position table (port of
``puzzlefusion_plusplus_tpu/models/embeddings.py``)."""

from __future__ import annotations

import numpy as np
import torch


def nerf_embed(x: torch.Tensor, num_freqs: int = 10) -> torch.Tensor:
    """[..., d] -> [..., d * (1 + 2*num_freqs)]: x, sin(x 2^0), cos(x 2^0), ... interleaved."""
    freqs = 2.0 ** np.linspace(0.0, num_freqs - 1.0, num_freqs)
    outs = [x]
    for f in freqs:
        outs.append(torch.sin(x * float(f)))
        outs.append(torch.cos(x * float(f)))
    return torch.cat(outs, dim=-1)


def sinusoidal_table(max_len: int, d_model: int) -> np.ndarray:
    """[max_len, d_model] float32 sin/cos position table."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * (-np.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), np.float64)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe.astype(np.float32)
