"""Numerical sanitizers (port of ``puzzlefusion_plusplus_tpu/utils/sanitize.py``).

The reference guards its numerics with Lightning's ``detect_anomaly=True``
(train_matching.py:68), NaN asserts inside Sinkhorn (linear_solvers.py:171-177) and range
asserts on doubly-stochastic matrices (loss.py:41-45). The port's versions:

* ``check_finite``: raise naming every non-finite floating tensor of a ``state_dict``, a
  module, or a nested dict / list / tuple of tensors and arrays.
* ``assert_doubly_stochastic``: range and row-sum check of Sinkhorn outputs.
* ``debug_nans``: ``torch.autograd.set_detect_anomaly`` around a block, which raises at the
  backward of the first operation that made a NaN, with its forward traceback.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def _leaves(tree, path: str = ""):
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _finite(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return not leaf.is_floating_point() or bool(torch.isfinite(leaf).all())
    a = np.asarray(leaf)
    return not np.issubdtype(a.dtype, np.floating) or bool(np.isfinite(a).all())


def check_finite(tree, name: str = "value") -> None:
    """Raise ``FloatingPointError`` naming the paths of the non-finite floating leaves."""
    bad = [path for path, leaf in _leaves(tree) if not _finite(leaf)]
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad}")


def assert_doubly_stochastic(mat, n_rows, n_cols, atol: float = 1e-3) -> None:
    """Sinkhorn-output sanity (reference loss.py:41-45): entries in [0, 1], the valid rows'
    sums about 1. ``mat`` [B, R, C], ``n_rows`` [B]; tensors or arrays."""
    m = mat.detach().cpu().numpy() if isinstance(mat, torch.Tensor) else np.asarray(mat)
    if not ((m >= -atol) & (m <= 1 + atol)).all():
        raise AssertionError(f"doubly-stochastic range violated: [{m.min()}, {m.max()}]")
    n_rows = (n_rows.cpu().numpy() if isinstance(n_rows, torch.Tensor)
              else np.asarray(n_rows))
    for b in range(m.shape[0]):
        r = int(n_rows[b])
        if r:
            sums = m[b, :r].sum(-1)
            if not np.allclose(sums, 1.0, atol=max(atol, 1e-2)):
                raise AssertionError(f"row sums off: {sums.min()}..{sums.max()}")


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Autograd anomaly detection around a block (``detect_anomaly``'s analogue): the
    backward of an operation that produced a NaN raises, naming the operation."""
    prev = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(enable)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(prev)
