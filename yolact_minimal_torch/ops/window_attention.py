"""Shifted-window attention on packed qkv: per window and head,
softmax(q k^T * hd^-0.5 + rel_bias[h] + (-100 where region ids differ)) v.

`window_attention` launches the hand-written CUDA kernel
(`csrc/window_attention.cu`) for tensors on the card and runs the plain
PyTorch version, `window_attention_plain`, for tensors on the CPU, through
the registered operator `yolact_torch::window_attention`, so that
`torch.export` records the call and an exported program launches the kernel.
It counts its kernel launches in `window_attention.launches`. The operator's
backward (`register_autograd`) recomputes the plain version from the saved
qkv and bias, as the JAX package's custom_vjp does through its XLA form, so
no [*, N, N] residual is kept. The region ids get no gradient.

Rounding places, shared by the plain version, the kernel and the JAX
package's kernel: `q * scale` is rounded to the compute dtype (the scale
itself rounded first); scores, bias and the additive -100 mask add in
float32; the softmax output is rounded to the compute dtype; p v accumulates
in float32 and is rounded once.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache
from typing import List, Optional, Tuple

import torch

from yolact_minimal_torch.ops import _build

NEG = -100.0       # additive fill for pairs in different regions (not -inf)
# What the kernel is compiled for: tokens per window and head width.
KERNEL_TOKENS = 49
KERNEL_HEAD_DIM = 32
# The bf16 kernel's blocks: groups of four warps a block, blocks resident on
# one multiprocessor (csrc/window_attention.cu reports the values it was
# compiled with through `kernel_attributes`).
GROUPS_PER_BLOCK = 2
BLOCKS_PER_SM = 2


@dataclass(frozen=True)
class Geometry:
    """The bf16 launch: `blocks` persistent blocks hold `groups` groups of
    four warps (GROUPS_PER_BLOCK a block; a last odd one idles). Group g takes
    head g % heads and walks windows g // heads, + per_head, ... below bnw,
    one (window, head) unit at a time; groups is per_head * heads."""
    bnw: int
    heads: int
    blocks: int
    groups: int
    per_head: int

    def units(self, block: int) -> List[Tuple[int, int]]:
        """The (window, head) units block `block` walks, group by group, each
        group's in its order."""
        return [(w, g % self.heads)
                for g in range(block * GROUPS_PER_BLOCK,
                               min((block + 1) * GROUPS_PER_BLOCK, self.groups))
                for w in range(g // self.heads, self.bnw, self.per_head)]


@lru_cache(maxsize=64)
def kernel_geometry(bnw: int, heads: int, sms: int) -> Geometry:
    """The bf16 kernel's launch for bnw windows of `heads` heads on a card of
    `sms` multiprocessors: as many groups as stay resident, a whole number for
    every head and at most one a window, so that each head's windows are
    dealt round-robin to the same number of groups and a group's bias stays
    that of one head for its whole walk."""
    if bnw <= 0 or heads <= 0 or sms <= 0:
        raise ValueError(f'kernel_geometry: bnw={bnw}, heads={heads}, sms={sms}')
    per_head = max(1, min(bnw, sms * BLOCKS_PER_SM * GROUPS_PER_BLOCK // heads))
    groups = per_head * heads
    return Geometry(bnw=bnw, heads=heads, blocks=-(-groups // GROUPS_PER_BLOCK),
                    groups=groups, per_head=per_head)


@lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def window_attention_plain(qkv, bias, region: Optional[torch.Tensor],
                           heads: int) -> torch.Tensor:
    """qkv [B*nW, N, 3C] (q | k | v along the last axis, each head-major),
    bias [heads, N, N] in qkv's dtype, region [nW, N] int32 or None
    -> [B*nW, N, C] in qkv's dtype."""
    bnw, n, c3 = qkv.shape
    c = c3 // 3
    hd = c // heads
    dt = qkv.dtype
    q, k, v = (qkv[..., i * c:(i + 1) * c].reshape(bnw, n, heads, hd) for i in range(3))
    q = q * torch.tensor(hd ** -0.5, dtype=dt, device=qkv.device)
    # products of two bf16 values are exact in float32: float() operands give
    # the float32 accumulation the kernels have
    attn = torch.einsum('bnhd,bmhd->bhnm', q.float(), k.float())
    attn = attn + bias[None].float()
    if region is not None:
        nw = region.shape[0]
        madd = torch.where(region[:, :, None] != region[:, None, :], NEG, 0.0)
        attn = attn.reshape(bnw // nw, nw, heads, n, n) + madd[None, :, None].float()
        attn = attn.reshape(bnw, heads, n, n)
    attn = torch.softmax(attn, dim=-1).to(dt)
    out = torch.einsum('bhnm,bmhd->bnhd', attn.float(), v.float()).to(dt)
    return out.reshape(bnw, n, c)


def _check(qkv, bias, region, heads):
    if qkv.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'window_attention: unsupported device {qkv.device}')
    if qkv.dim() != 3 or qkv.shape[2] % (3 * heads):
        raise ValueError(f'window_attention takes qkv [B*nW, N, 3C] with C a multiple '
                         f'of heads={heads}, got {tuple(qkv.shape)}')
    if qkv.dtype not in (torch.float32, torch.bfloat16) or not qkv.is_contiguous():
        raise ValueError('window_attention: qkv must be contiguous float32 or bfloat16')
    n = qkv.shape[1]
    if bias.shape != (heads, n, n) or bias.dtype != qkv.dtype or \
            bias.device != qkv.device or not bias.is_contiguous():
        raise ValueError(f'window_attention: bias must be contiguous [{heads}, {n}, {n}] '
                         f'of qkv\'s dtype and device, got {bias.dtype} {tuple(bias.shape)}')
    if region is not None:
        if region.dim() != 2 or region.shape[1] != n or region.dtype != torch.int32 or \
                region.device != qkv.device or not region.is_contiguous():
            raise ValueError(f'window_attention: region must be contiguous int32 [nW, {n}] '
                             f'on qkv\'s device, got {region.dtype} {tuple(region.shape)}')
        if region.shape[0] == 0 or qkv.shape[0] % region.shape[0]:
            raise ValueError(f'window_attention: {qkv.shape[0]} windows are not a whole '
                             f'number of images of {region.shape[0]} windows')


def window_attention(qkv, bias, region: Optional[torch.Tensor],
                     heads: int) -> torch.Tensor:
    """Kernel wrapper: CUDA kernel for tensors on the card, plain version
    for tensors on the CPU, through the registered operator (its backward
    recomputes the plain version). Window w of the batch-major leading
    axis uses region row w % nW. Returns [B*nW, N, C] in qkv's dtype."""
    _check(qkv, bias, region, heads)
    return _window_attention_op(qkv, bias, region, heads)


@torch.library.custom_op('yolact_torch::window_attention', mutates_args=(),
                         device_types=('cpu', 'cuda'))
def _window_attention_op(qkv: torch.Tensor, bias: torch.Tensor, region: Optional[torch.Tensor],
                         heads: int) -> torch.Tensor:
    """The plain version on the CPU, the kernel on the card."""
    if qkv.device.type == 'cpu':
        return window_attention_plain(qkv, bias, region, heads)
    bnw, n, c3 = qkv.shape
    c = c3 // 3
    if n != KERNEL_TOKENS or c // heads != KERNEL_HEAD_DIM:
        raise ValueError(f'window_attention: the kernel takes {KERNEL_TOKENS} tokens and '
                         f'head width {KERNEL_HEAD_DIM}, got {n} and {c // heads}')
    if heads > 65535:
        raise ValueError(f'window_attention: grid too large (heads={heads})')
    out = torch.empty((bnw, n, c), dtype=qkv.dtype, device=qkv.device)
    if out.numel() == 0:
        return out
    index = qkv.device.index if qkv.device.index is not None else torch.cuda.current_device()
    geo = kernel_geometry(bnw, heads, _sm_count(index))
    lib = _build.load('window_attention')
    fn = lib.window_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        _build.launch(fn, qkv.data_ptr(), bias.data_ptr(),
                      None if region is None else region.data_ptr(), out.data_ptr(),
                      bnw, heads, 0 if region is None else region.shape[0],
                      int(qkv.dtype == torch.bfloat16), geo.blocks, geo.groups, geo.per_head,
                      stream)
    window_attention.launches += 1
    return out


@_window_attention_op.register_fake
def _(qkv, bias, region, heads):
    bnw, n, c3 = qkv.shape
    return qkv.new_empty((bnw, n, c3 // 3))


def _setup_context(ctx, inputs, output):
    qkv, bias, region, heads = inputs
    ctx.save_for_backward(qkv, bias)
    ctx.region, ctx.heads = region, heads


def _backward(ctx, grad):
    qkv, bias = ctx.saved_tensors
    with torch.enable_grad(), torch.autocast(qkv.device.type, enabled=False):
        qkv, bias = qkv.detach().requires_grad_(), bias.detach().requires_grad_()
        out = window_attention_plain(qkv, bias, ctx.region, ctx.heads)
        d_qkv, d_bias = torch.autograd.grad(out, (qkv, bias), grad)
    return d_qkv, d_bias, None, None


_window_attention_op.register_autograd(_backward, setup_context=_setup_context)


window_attention.launches = 0


ATTRIBUTE_KEYS = ('groups_per_block', 'blocks_per_sm', 'stages', 'threads', 'smem_bytes',
                  'registers', 'spill_bytes')


def kernel_attributes() -> dict:
    """The compiled bf16 kernel's shape: groups a block, blocks a
    multiprocessor, ring slots a group, threads and dynamic shared memory
    bytes a block, and the registers and local (spill) bytes a thread."""
    out = (ctypes.c_int * len(ATTRIBUTE_KEYS))()
    fn = _build.load('window_attention').window_attention_attributes
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build.launch(fn, ctypes.addressof(out))
    return dict(zip(ATTRIBUTE_KEYS, out))
