"""Matrix products of the plain reference, in float32 or in TF32.

Every product of the reference goes through ``lin``, ``mm`` or ``ein``. In float32 they are
the plain PyTorch operations (the caller turns TF32 off). ``Precision(tf32=True)`` is the
control: each operand is rounded to TF32 (10 mantissa bits, to nearest, ties to even) before
the product, which then accumulates in float32, as the tensor cores compute TF32. The
rounding is done here, not by ``torch.backends``, so that the control computes the same
on the CPU as on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> float32 holding the nearest TF32 value (ties to even)."""
    i = x.float().contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class _RoundOperand(torch.autograd.Function):
    """An operand rounded to TF32; its gradient passes through."""

    @staticmethod
    def forward(ctx, x):
        return round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundGradient(torch.autograd.Function):
    """The identity, whose gradient is rounded to TF32 before the product's backward takes
    it, so that the backward's products also see TF32 operands."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return round_tf32(g)


class Precision:
    """The products' precision: float32, or TF32 for the control (forward and backward)."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def _product(self, fn, *ops):
        if not self.tf32:
            return fn(*ops)
        return _RoundGradient.apply(fn(*(_RoundOperand.apply(o) for o in ops)))

    def lin(self, x, w, b=None):
        """x @ w.T + b over the last axis."""
        if not self.tf32:
            return F.linear(x, w, b)
        y = self._product(F.linear, x, w)
        return y if b is None else y + b

    def mm(self, a, b):
        return self._product(torch.matmul, a, b)

    def ein(self, eq: str, *ops):
        return self._product(lambda *o: torch.einsum(eq, *o), *ops)


FP32 = Precision(False)
