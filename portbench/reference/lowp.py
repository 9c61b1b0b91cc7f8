"""Matmuls with fp8 operands: the control that ``correct`` must refuse.

The configurations state bfloat16 compute; the next precision below it
is fp8. Each matmul operand is rounded to e4m3 with a per-tensor scale
(its largest magnitude at e4m3's largest, 448) and each gradient that
enters a backward matmul to e5m2 (largest 57344), the usual fp8
training recipe; the products are summed in f32.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Operand(torch.autograd.Function):
    """Forward: round to e4m3; backward: the gradient as it is."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return g


class _Output(torch.autograd.Function):
    """Forward: as it is; backward: the incoming gradient to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _Output.apply(torch.matmul(_Operand.apply(a), _Operand.apply(b)))
