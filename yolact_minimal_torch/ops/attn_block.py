"""The attention half of a Swin block on windowed, already normalised rows:

    y = proj(attention(x Wqkv^T + bqkv)) + bproj          x, y: [B*nW, N, C]

with `attention` the per-window, per-head softmax of `ops/window_attention.py`.

`attn_block` launches the hand-written CUDA kernel (`csrc/attn_block.cu`) for
tensors on the card and runs the plain PyTorch version, `attn_block_plain`,
for tensors on the CPU, through the registered operator
`yolact_torch::attn_block` (no backward), so that `torch.export` records the
call. It counts its kernel launches in `attn_block.launches`.
`kernel_geometry` states the bf16 launch's grids (tiles of windows on
persistent blocks at C = 96; two phases at C = 192, 384 and 768: a block per
head and chunk of windows, then persistent blocks over 64-row tiles of the
output) and `shared_bytes` their shared memory.

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
from dataclasses import dataclass
from functools import lru_cache
from typing import List, Optional

import torch
import torch.nn.functional as F

from yolact_minimal_torch.ops import _build
from yolact_minimal_torch.ops.swin_mlp import KERNEL_WIDTHS
from yolact_minimal_torch.ops.window_attention import (KERNEL_HEAD_DIM, KERNEL_TOKENS,
                                                       window_attention_plain)

# The bf16 kernels' shapes per row width C, as csrc/attn_block.cu compiles
# them (`kernel_attributes` reports them from the compiled kernels). C = 96:
# one tiled kernel, tiles of G windows, a warpgroup each, both weight
# matrices in shared memory. C = 192, 384, 768: two phases; phase 1 has
# HEAD_SHAPES warpgroups a block and x ring slots a warpgroup; phase 2 has
# PROJ_SHAPES 64-row tiles a block at once, column groups a tile (a
# warpgroup each), ring slots and groups of tiles held at once.
TILED_WINDOWS = {96: 3}
HEAD_SHAPES = {192: (3, 5), 384: (3, 5), 768: (2, 4)}
PROJ_SHAPES = {192: (1, 2, 4, 2), 384: (3, 1, 6, 1), 768: (1, 2, 4, 1)}
SHARED_MEMORY_LIMIT = 232448          # bytes a block may use on an H100
WINDOW_ROWS = 56                      # a window's rows in the tiled kernel's x and output tiles
ROW_TILE = 64                         # rows of a phase-2 tile


def shared_bytes(c: int) -> tuple:
    """Dynamic shared memory a block of each bf16 kernel at width c, as
    csrc/attn_block.cu lays it out, 1 KB to align the base included.
    Tiled (one kernel): the x and attention-output tiles (per 64-wide
    k-block G windows WINDOW_ROWS rows apart and 8 rows more, 128 bytes a
    row), per window the q, k, v tiles [64, 32], both weight matrices (per
    head and k-block 96 q | k | v rows, per k-block C proj rows), bqkv and
    bproj in float32, the barriers. Two phases: phase 1 the head's 96 rows
    of wqkv and per warpgroup its x slots [64 rows, 64] and k, v tiles;
    phase 2 its groups of row tiles, the ring of every column group's 96
    proj rows and bproj."""
    kb = -(-c // 64)
    if c in TILED_WINDOWS:
        g = TILED_WINDOWS[c]
        tiles = 2 * kb * (g * WINDOW_ROWS + 8) * 128
        weights = (c // 32) * kb * 96 * 128 + kb * c * 128
        return (tiles + g * 3 * 64 * 64 + weights + 4 * c * 4 + (g + 1) * 8 + 1024,)
    wgn, xs = HEAD_SHAPES[c]
    heads = kb * 96 * 128 + wgn * (xs * 64 * 128 + 2 * 64 * 64) + (1 + 2 * wgn * xs) * 8 + 1024
    rw, cs, stages, abuf = PROJ_SHAPES[c]
    proj = abuf * rw * kb * 64 * 128 + stages * cs * 96 * 128 + c * 4 + \
        (2 * stages + abuf) * 8 + 1024
    return heads, proj


@dataclass(frozen=True)
class Geometry:
    """A bf16 launch: `blocks` persistent blocks walk `tiles` tiles of
    `windows_per_tile` consecutive windows (the last may hold fewer); block b
    takes tiles b, b + blocks, ..., `rounds` at most."""
    bnw: int
    windows_per_tile: int
    tiles: int
    blocks: int
    rounds: int

    def windows(self, block: int) -> List[range]:
        """The windows of each tile block `block` walks, in its order."""
        g = self.windows_per_tile
        return [range(t * g, min(self.bnw, (t + 1) * g))
                for t in range(block, self.tiles, self.blocks)]


def tiled_geometry(bnw: int, g: int, sms: int) -> Geometry:
    """Tiles of g windows, one persistent block a multiprocessor, or one a
    tile where there are fewer tiles."""
    tiles = -(-bnw // g)
    blocks = min(tiles, sms)
    return Geometry(bnw=bnw, windows_per_tile=g, tiles=tiles, blocks=blocks,
                    rounds=-(-tiles // blocks))


@dataclass(frozen=True)
class HeadGeometry:
    """The bf16 phase-1 launch (csrc/swin_tiled.cuh::attend_heads): `heads` x
    `chunks` blocks (block b takes head b % heads and chunk b // heads) of
    `warpgroups` warpgroups, each walking its own windows."""
    bnw: int
    heads: int
    chunks: int
    warpgroups: int

    @property
    def blocks(self) -> int:
        return self.heads * self.chunks

    def windows(self, block: int, warpgroup: int) -> range:
        """The windows warpgroup `warpgroup` of phase-1 block `block` walks."""
        stride = self.chunks * self.warpgroups
        return range(block // self.heads + self.chunks * warpgroup, self.bnw, stride)

    @property
    def rounds(self) -> int:
        """The most windows a phase-1 warpgroup walks."""
        return -(-self.bnw // (self.chunks * self.warpgroups))


def head_geometry(bnw: int, c: int, sms: int) -> dict:
    """HeadGeometry's fields for bnw windows of width c on `sms`
    multiprocessors: as many chunks as there are multiprocessors a head."""
    heads = c // KERNEL_HEAD_DIM
    return dict(bnw=bnw, heads=heads, chunks=max(1, sms // heads),
                warpgroups=HEAD_SHAPES[c][0])


@dataclass(frozen=True)
class TwoPhaseGeometry(HeadGeometry):
    """The two bf16 launches: phase 1 as HeadGeometry; phase 2 runs
    `proj_blocks` persistent blocks over `row_tiles` tiles of ROW_TILE rows
    in groups of `tiles_per_group` (block b takes groups b, b + proj_blocks,
    ...)."""
    row_tiles: int
    tiles_per_group: int
    proj_blocks: int

    def tiles(self, block: int) -> List[range]:
        """The groups of row tiles phase-2 block `block` takes, in its order."""
        n = self.tiles_per_group
        groups = -(-self.row_tiles // n)
        return [range(g * n, min(self.row_tiles, (g + 1) * n))
                for g in range(block, groups, self.proj_blocks)]


@lru_cache(maxsize=64)
def kernel_geometry(bnw: int, c: int, sms: int):
    """The bf16 launch for bnw windows of width c on a card of `sms`
    multiprocessors, as csrc/attn_block.cu computes it: a Geometry of tiles
    of G windows at C = 96, a TwoPhaseGeometry at C = 192, 384 and 768."""
    if bnw <= 0 or c not in KERNEL_WIDTHS or sms <= 0:
        raise ValueError(f'kernel_geometry: bnw={bnw}, c={c}, sms={sms}')
    if c in TILED_WINDOWS:
        return tiled_geometry(bnw, TILED_WINDOWS[c], sms)
    row_tiles = -(-bnw * KERNEL_TOKENS // ROW_TILE)
    per_group = PROJ_SHAPES[c][0]
    return TwoPhaseGeometry(**head_geometry(bnw, c, sms), row_tiles=row_tiles,
                            tiles_per_group=per_group,
                            proj_blocks=min(-(-row_tiles // per_group), sms))


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
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'attn_block: unsupported device {x.device}')


def attn_block(x, wqkv, bqkv, bias, region: Optional[torch.Tensor], wproj, bproj,
               heads: int) -> torch.Tensor:
    """Kernel wrapper: CUDA kernel for tensors on the card, plain version
    for tensors on the CPU, through the registered operator. Window w of the
    batch-major leading axis uses region row w % nW. A caller that runs in
    bfloat16 passes wqkv and wproj already in bfloat16; float32 weights are
    rounded here, on every call."""
    _check(x, wqkv, bqkv, bias, region, wproj, bproj, heads)
    return _attn_block_op(x, wqkv, bqkv, bias, region, wproj, bproj, heads)


@torch.library.custom_op('yolact_torch::attn_block', mutates_args=(),
                         device_types=('cpu', 'cuda'))
def _attn_block_op(x: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor, bias: torch.Tensor,
                   region: Optional[torch.Tensor], wproj: torch.Tensor, bproj: torch.Tensor,
                   heads: int) -> torch.Tensor:
    """The plain version on the CPU, the kernel on the card."""
    if x.device.type == 'cpu':
        return attn_block_plain(x, wqkv, bqkv, bias, region, wproj, bproj, heads)
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


@_attn_block_op.register_fake
def _(x, wqkv, bqkv, bias, region, wproj, bproj, heads):
    return torch.empty_like(x)


attn_block.launches = 0


ATTRIBUTE_KEYS = ('threads', 'smem_bytes', 'registers', 'spill_bytes')


def kernel_attributes(c: int) -> dict:
    """The compiled bf16 kernels at width c: {'tiled': ...} at C = 96, else
    {'heads': ..., 'proj': ...} for the two phases; each the threads and
    dynamic shared memory bytes a block and the registers and local (spill)
    bytes a thread."""
    if c not in KERNEL_WIDTHS:
        raise ValueError(f'kernel_attributes: C in {KERNEL_WIDTHS}, got {c}')
    fn = _build.load('attn_block').attn_block_attributes
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    names = ('tiled',) if c in TILED_WINDOWS else ('heads', 'proj')
    attrs = {}
    for which, name in enumerate(names):
        out = (ctypes.c_int * len(ATTRIBUTE_KEYS))()
        _build.launch(fn, c, which, ctypes.addressof(out))
        attrs[name] = dict(zip(ATTRIBUTE_KEYS, out))
    return attrs
