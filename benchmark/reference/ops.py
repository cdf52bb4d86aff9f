"""The reference's products and its precision.

Every convolution, linear layer and attention product of the reference goes
through `conv2d`, `linear` or `matmul`. In float32 (the default) they are
the plain PyTorch calls with TF32 off. Under `lower_precision()` their
operands are first rounded to float8 e4m3 with one scale a tensor, as an
fp8 deployment computes them, and in training the gradient reaching each
operand is rounded to float8 e5m2 alike (the usual fp8 training recipe):
the control that the comparison has to fail.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

_state = {'low': None}


def _scaled_round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to `dtype` after scaling its largest magnitude to the
    format's largest, and scaled back; float32 out."""
    xf = x.float()
    scale = xf.abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (xf / scale).to(dtype).float() * scale


class _RoundFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _scaled_round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, grad):
        return _scaled_round(grad, torch.float8_e5m2)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    return _RoundFp8.apply(x)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16, the gradient passed straight through."""
    return x + (x.to(torch.bfloat16).float() - x).detach()


def _operand(x: torch.Tensor) -> torch.Tensor:
    low = _state['low']
    return x if low is None else low(x)


@contextlib.contextmanager
def lower_precision(kind: str = 'fp8'):
    """Run the reference's products on fp8 operands inside the block (the
    control), or on bfloat16 ones (a witness of what bf16 rounding alone
    does to a comparison)."""
    old = _state['low']
    _state['low'] = {'fp8': round_fp8, 'bf16': round_bf16}[kind]
    try:
        yield
    finally:
        _state['low'] = old


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matrix products and convolutions inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def conv2d(x, weight, bias=None, stride=1, padding=0):
    return F.conv2d(_operand(x), _operand(weight), bias, stride=stride, padding=padding)


def linear(x, weight, bias=None):
    return F.linear(_operand(x), _operand(weight), bias)


def matmul(a, b):
    return torch.matmul(_operand(a), _operand(b))
