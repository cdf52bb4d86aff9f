"""A whole Swin block on windowed PRE-norm rows x [B*nW, N, C]:

    h = x + proj(attention(qkv(LayerNorm1(x) * rowmask))) + bproj
    y = h + fc2(gelu_erf(fc1(LayerNorm2(h))))

`rowmask` [nW, N] is 1 for a token of the feature map and 0 for one that the
caller's padding added: the block pads AFTER norm1, so a padding token enters
the attention as 0 and its qkv is the projection bias. It still attends and is
attended to; the caller crops its output row.

`swin_block` launches the hand-written CUDA kernel (`csrc/swin_block.cu`) for
tensors on the card and runs the plain PyTorch version, `swin_block_plain`,
for tensors on the CPU. It counts its kernel launches in
`swin_block.launches`. `kernel_geometry` fixes the bf16 launch's grid (tiles
of windows at C = 96, 192 and 384, one block a window at C = 768).

Rounding places, shared by the plain version, the kernel and the JAX
package's kernel: LayerNorm1 in float32 (eps 1e-5), times the rowmask,
rounded to the compute dtype; qkv and the attention as in `ops/attn_block.py`;
proj accumulates in float32 and `h = x + y + bproj` STAYS float32 between the
halves (composing `attn_block` and `mlp_block` rounds it: the residual is then
a tensor of the compute dtype). LayerNorm2 of that float32 h, rounded; fc1
accumulates in float32, `+ b1` and gelu in float32, rounded ONCE after the
gelu (`mlp_block` rounds before it as well); fc2 accumulates in float32,
`h + y2 + b2` in float32, rounded once. Weights are laid out as nn.Linear
keeps them.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional

import torch
import torch.nn.functional as F

from yolact_minimal_torch.ops import _build
from yolact_minimal_torch.ops.attn_block import (Geometry, check_kernel_shape, check_params,
                                                 check_per_window, check_windows,
                                                 tiled_geometry)
from yolact_minimal_torch.ops.swin_mlp import LN_EPS
from yolact_minimal_torch.ops.window_attention import _sm_count, window_attention_plain

# The tiled bf16 kernel's shape per row width C, as csrc/swin_block.cu
# compiles it (`kernel_attributes` reports it from the compiled kernel): G
# windows a tile, CS warpgroups a window (each takes 1 / CS of every
# product's columns), ring slots, and the 64-wide k-blocks that one use of
# the ring carries for the qkv and for the fc1 product. At C = 768 the bf16
# body is one block a window, which keeps the float32 h in a scratch tensor
# that the wrapper allocates.
KERNEL_SHAPES = {96: (3, 1, 3, 2, 2), 192: (2, 1, 4, 1, 3), 384: (1, 2, 4, 2, 3)}
SCRATCH_WIDTHS = (768,)
TOKENS = 49
WEIGHT_BOX_ROWS = (32, 96, 64, 96)    # TMA boxes of wqkv, wproj, k1, k2 (at most 256)


def _align1k(n: int) -> int:
    return -(-n // 1024) * 1024


def shared_bytes(c: int) -> int:
    """Dynamic shared memory of a tiled bf16 block at width c, as
    BlockPlan<C> lays it out: per window the LN tile [64, C], the
    attention-output tile and one set of q, k, v tiles (two where CS > 1)
    with h [49, C] float32 over them, and where CS > 1 the gelu tile
    [64, 64]; then the ring, whose slots hold the largest use (KQ k-blocks of
    a head's 96 q | k | v rows, K1 of a chunk's 64 k1 rows, or one of CS x 96
    proj or k2 rows), its barriers (in the first window's unused tail where
    they fit) and 1 KB to align the base."""
    g, cs, stages, kq, k1 = KERNEL_SHAPES[c]
    tile = -(-c // 64) * 64 * 128
    qkv_sets = 2 if cs > 1 else 1
    used = max(2 * tile + qkv_sets * 3 * 64 * 64, tile + TOKENS * c * 4)
    window = _align1k(used) + (64 * 128 if cs > 1 else 0)
    slot = max(96 * kq, 64 * k1, 96 * cs) * 128
    barriers = 2 * stages * 8        # in window 0's unused tail where they fit
    tail = _align1k(used) - used >= barriers
    return g * window + stages * slot + (0 if tail else barriers) + 1024


@lru_cache(maxsize=64)
def kernel_geometry(bnw: int, c: int, sms: int) -> Geometry:
    """The bf16 kernel's launch for bnw windows of width c on a card of `sms`
    multiprocessors. Tiled widths: tiles of G windows, one block a
    multiprocessor (each takes most of one's shared memory), or one a tile
    where there are fewer tiles. C = 768: one block a window."""
    if bnw <= 0 or c not in (96, 192, 384, 768) or sms <= 0:
        raise ValueError(f'kernel_geometry: bnw={bnw}, c={c}, sms={sms}')
    if c not in KERNEL_SHAPES:
        return Geometry(bnw=bnw, windows_per_tile=1, tiles=bnw, blocks=bnw, rounds=1)
    return tiled_geometry(bnw, KERNEL_SHAPES[c][0], sms)


def swin_block_plain(x, rowmask: Optional[torch.Tensor], ln1_scale, ln1_bias, wqkv, bqkv,
                     bias, region: Optional[torch.Tensor], wproj, bproj, ln2_scale, ln2_bias,
                     k1, b1, k2, b2, heads: int) -> torch.Tensor:
    """x [B*nW, N, C] (float32 or bfloat16), rowmask [nW, N] float32 or None,
    LayerNorm parameters [C], wqkv [3C, C], bqkv [3C], bias [heads, N, N] in
    x's dtype, region [nW, N] int32 or None, wproj [C, C], bproj [C], k1
    [4C, C], b1 [4C], k2 [C, 4C], b2 [C] -> [B*nW, N, C] in x's dtype.

    It follows the JAX package's whole-block kernel, not the composition of
    `attn_block_plain` and `mlp_block_plain`: h is not rounded between the
    halves and the hidden activations are rounded once, after the gelu."""
    dt = x.dtype
    bnw, n, c = x.shape
    xf = x.float()
    xn = F.layer_norm(xf, (c,), ln1_scale.float(), ln1_bias.float(), LN_EPS)
    if rowmask is not None:
        nw = rowmask.shape[0]
        xn = (xn.reshape(bnw // nw, nw, n, c) * rowmask[None, :, :, None]).reshape(bnw, n, c)
    xn = xn.to(dt)
    # products of two bf16 values are exact in float32: float() operands give
    # the float32 accumulation and float32 bias add the kernels have
    qkv = F.linear(xn.float(), wqkv.to(dt).float(), bqkv.float()).to(dt)
    att = window_attention_plain(qkv, bias, region, heads)
    h = xf + F.linear(att.float(), wproj.to(dt).float()) + bproj.float()
    hn = F.layer_norm(h, (c,), ln2_scale.float(), ln2_bias.float(), LN_EPS).to(dt)
    u = F.gelu(F.linear(hn.float(), k1.to(dt).float(), b1.float())).to(dt)
    return (h + F.linear(u.float(), k2.to(dt).float()) + b2.float()).to(dt)


def _check(x, rowmask, ln1_scale, ln1_bias, wqkv, bqkv, bias, region, wproj, bproj,
           ln2_scale, ln2_bias, k1, b1, k2, b2, heads):
    check_windows('swin_block', x, bias, region, heads)
    if rowmask is not None:
        check_per_window('swin_block', 'rowmask', rowmask, torch.float32, x)
        if region is not None and region.shape[0] != rowmask.shape[0]:
            raise ValueError(f'swin_block: rowmask has {rowmask.shape[0]} windows an image, '
                             f'region {region.shape[0]}')
    c = x.shape[2]
    check_params('swin_block', x,
                 (('ln1_scale', ln1_scale, c), ('ln1_bias', ln1_bias, c), ('bqkv', bqkv, 3 * c),
                  ('bproj', bproj, c), ('ln2_scale', ln2_scale, c), ('ln2_bias', ln2_bias, c),
                  ('b1', b1, 4 * c), ('b2', b2, c)),
                 (('wqkv', wqkv, (3 * c, c)), ('wproj', wproj, (c, c)),
                  ('k1', k1, (4 * c, c)), ('k2', k2, (c, 4 * c))))
    tensors = [x, ln1_scale, ln1_bias, wqkv, bqkv, bias, wproj, bproj, ln2_scale, ln2_bias,
               k1, b1, k2, b2] + [t for t in (rowmask, region) if t is not None]
    if len({t.device for t in tensors}) != 1:
        raise ValueError('swin_block: inputs lie on different devices')


def swin_block(x, rowmask: Optional[torch.Tensor], ln1_scale, ln1_bias, wqkv, bqkv, bias,
               region: Optional[torch.Tensor], wproj, bproj, ln2_scale, ln2_bias,
               k1, b1, k2, b2, heads: int) -> torch.Tensor:
    """Kernel wrapper: CUDA kernel for tensors on the card, plain version
    for tensors on the CPU. Window w of the batch-major leading axis uses row
    w % nW of rowmask and of region. A caller that runs in bfloat16 passes the
    four weight matrices already in bfloat16; float32 weights are rounded
    here, on every call."""
    args = (x, rowmask, ln1_scale, ln1_bias, wqkv, bqkv, bias, region, wproj, bproj,
            ln2_scale, ln2_bias, k1, b1, k2, b2, heads)
    _check(*args)
    if x.device.type == 'cpu':
        return swin_block_plain(*args)
    if x.device.type != 'cuda':
        raise ValueError(f'swin_block: unsupported device {x.device}')
    check_kernel_shape('swin_block', x, heads)
    wqkv, wproj, k1, k2 = (w.to(x.dtype) for w in (wqkv, wproj, k1, k2))
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    is_bf16 = x.dtype == torch.bfloat16
    bnw, _, c = x.shape
    scratch, blocks = None, 0
    if is_bf16:
        blocks = kernel_geometry(bnw, c, _sm_count(x.device.index or 0)).blocks
        if c in SCRATCH_WIDTHS:
            scratch = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    nw = rowmask.shape[0] if rowmask is not None else \
        region.shape[0] if region is not None else 0
    lib = _build.load('swin_block')
    fn = lib.swin_block
    fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _build.launch(fn, ptr(x), ptr(rowmask), ptr(ln1_scale), ptr(ln1_bias), ptr(wqkv),
                      ptr(bqkv), ptr(bias), ptr(region), ptr(wproj), ptr(bproj),
                      ptr(ln2_scale), ptr(ln2_bias), ptr(k1), ptr(b1), ptr(k2), ptr(b2),
                      ptr(scratch), ptr(out), bnw, c, nw, int(is_bf16), blocks, stream)
    swin_block.launches += 1
    return out


swin_block.launches = 0


ATTRIBUTE_KEYS = ('windows_per_tile', 'column_split', 'threads', 'stages', 'smem_bytes',
                  'registers', 'spill_bytes')


def kernel_attributes(c: int) -> dict:
    """The compiled tiled bf16 kernel's shape at width c (KERNEL_SHAPES):
    windows a tile, warpgroups a window, threads, ring slots and dynamic
    shared memory bytes a block, and the registers and local (spill) bytes a
    thread."""
    if c not in KERNEL_SHAPES:
        raise ValueError(f'kernel_attributes: the tiled kernel takes C in '
                         f'{tuple(KERNEL_SHAPES)}, got {c}')
    out = (ctypes.c_int * len(ATTRIBUTE_KEYS))()
    fn = _build.load('swin_block').swin_block_attributes
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build.launch(fn, c, ctypes.addressof(out))
    return dict(zip(ATTRIBUTE_KEYS, out))
