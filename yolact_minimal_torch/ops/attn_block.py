"""The attention half of a Swin block on windowed, already normalised rows:

    y = proj(attention(x Wqkv^T + bqkv)) + bproj          x, y: [B*nW, N, C]

with `attention` the per-window, per-head softmax of `ops/window_attention.py`.

`attn_block` launches the hand-written CUDA kernel (`csrc/attn_block.cu`) for
tensors on the card and runs the plain PyTorch version, `attn_block_plain`,
for tensors on the CPU. It counts its kernel launches in
`attn_block.launches`.

Rounding places, shared by the plain version, the kernel and the JAX
package's kernel: qkv accumulates in float32, `+ bqkv` in float32, rounded to
the compute dtype; the attention rounds where `window_attention` does
(`q * scale` with the scale rounded first, the softmax output, p v once);
proj accumulates in float32, `+ bproj` in float32, rounded once. The compute
dtype is x's. Weights are laid out as nn.Linear keeps them: wqkv [3C, C],
wproj [C, C].
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from yolact_minimal_torch.ops import _build
from yolact_minimal_torch.ops.swin_mlp import KERNEL_WIDTHS
from yolact_minimal_torch.ops.window_attention import (KERNEL_HEAD_DIM, KERNEL_TOKENS,
                                                       window_attention_plain)


def attn_block_plain(x, wqkv, bqkv, bias, region: Optional[torch.Tensor], wproj, bproj,
                     heads: int) -> torch.Tensor:
    """x [B*nW, N, C] (float32 or bfloat16), wqkv [3C, C], bqkv [3C], bias
    [heads, N, N] in x's dtype, region [nW, N] int32 or None, wproj [C, C],
    bproj [C] -> [B*nW, N, C] in x's dtype. Weights in another dtype than x's
    are rounded to it first."""
    dt = x.dtype
    # products of two bf16 values are exact in float32: float() operands give
    # the float32 accumulation and float32 bias add the kernels have
    qkv = F.linear(x.float(), wqkv.to(dt).float(), bqkv.float()).to(dt)
    out = window_attention_plain(qkv, bias, region, heads)
    return F.linear(out.float(), wproj.to(dt).float(), bproj.float()).to(dt)


def check_windows(name, x, bias, region, heads):
    """What both block kernels ask of the windowed rows, the relative-position
    bias and the region ids."""
    if x.dim() != 3 or x.dtype not in (torch.float32, torch.bfloat16) or \
            not x.is_contiguous() or x.shape[2] % heads:
        raise ValueError(f'{name} takes contiguous float32 or bfloat16 windows [B*nW, N, C] '
                         f'with C a multiple of heads={heads}, got {x.dtype} {tuple(x.shape)}')
    n = x.shape[1]
    if bias.shape != (heads, n, n) or bias.dtype != x.dtype or not bias.is_contiguous():
        raise ValueError(f'{name}: bias must be contiguous [{heads}, {n}, {n}] of x\'s dtype, '
                         f'got {bias.dtype} {tuple(bias.shape)}')
    if region is not None:
        check_per_window(name, 'region', region, torch.int32, x)


def check_per_window(name, what, t, dtype, x):
    """A [nW, N] table of which window w of x uses row w % nW."""
    n = x.shape[1]
    if t.dim() != 2 or t.shape[1] != n or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f'{name}: {what} must be contiguous {dtype} [nW, {n}], '
                         f'got {t.dtype} {tuple(t.shape)}')
    if t.shape[0] == 0 or x.shape[0] % t.shape[0]:
        raise ValueError(f'{name}: {x.shape[0]} windows are not a whole number of images of '
                         f'{t.shape[0]} windows')


def check_params(name, x, vectors, matrices):
    """`vectors`: (name, tensor, length), float32; `matrices`: (name, tensor,
    shape), in x's dtype or float32."""
    for what, t, length in vectors:
        if t.shape != (length,) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f'{name}: {what} must be contiguous float32 ({length},), '
                             f'got {t.dtype} {tuple(t.shape)}')
    for what, t, shape in matrices:
        if t.shape != shape or t.dtype not in (x.dtype, torch.float32) or \
                not t.is_contiguous():
            raise ValueError(f'{name}: {what} must be contiguous {shape} in x\'s dtype or '
                             f'float32, got {t.dtype} {tuple(t.shape)}')


def check_kernel_shape(name, x, heads):
    """What the CUDA block kernels are compiled for."""
    _, n, c = x.shape
    if n != KERNEL_TOKENS or c // heads != KERNEL_HEAD_DIM or c not in KERNEL_WIDTHS:
        raise ValueError(f'{name}: the kernel takes {KERNEL_TOKENS} tokens, head width '
                         f'{KERNEL_HEAD_DIM} and C in {KERNEL_WIDTHS}, got {n}, '
                         f'{c // heads} and {c}')


def _check(x, wqkv, bqkv, bias, region, wproj, bproj, heads):
    check_windows('attn_block', x, bias, region, heads)
    c = x.shape[2]
    check_params('attn_block', x, (('bqkv', bqkv, 3 * c), ('bproj', bproj, c)),
                 (('wqkv', wqkv, (3 * c, c)), ('wproj', wproj, (c, c))))
    tensors = [x, wqkv, bqkv, bias, wproj, bproj] + ([] if region is None else [region])
    if len({t.device for t in tensors}) != 1:
        raise ValueError('attn_block: inputs lie on different devices')


def attn_block(x, wqkv, bqkv, bias, region: Optional[torch.Tensor], wproj, bproj,
               heads: int) -> torch.Tensor:
    """Kernel wrapper: CUDA kernel for tensors on the card, plain version
    for tensors on the CPU. Window w of the batch-major leading axis uses
    region row w % nW. A caller that runs in bfloat16 passes wqkv and wproj
    already in bfloat16; float32 weights are rounded here, on every call."""
    _check(x, wqkv, bqkv, bias, region, wproj, bproj, heads)
    if x.device.type == 'cpu':
        return attn_block_plain(x, wqkv, bqkv, bias, region, wproj, bproj, heads)
    if x.device.type != 'cuda':
        raise ValueError(f'attn_block: unsupported device {x.device}')
    check_kernel_shape('attn_block', x, heads)
    wqkv, wproj = wqkv.to(x.dtype), wproj.to(x.dtype)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    lib = _build.load('attn_block')
    fn = lib.attn_block
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _build.launch(fn, x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), bias.data_ptr(),
                      None if region is None else region.data_ptr(), wproj.data_ptr(),
                      bproj.data_ptr(), out.data_ptr(), x.shape[0], x.shape[2],
                      0 if region is None else region.shape[0],
                      int(x.dtype == torch.bfloat16), stream)
    attn_block.launches += 1
    return out


attn_block.launches = 0
