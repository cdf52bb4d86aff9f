"""A whole Swin block on windowed PRE-norm rows x [B*nW, N, C]:

    h = x + proj(attention(qkv(LayerNorm1(x) * rowmask))) + bproj
    y = h + fc2(gelu_erf(fc1(LayerNorm2(h))))

`rowmask` [nW, N] is 1 for a token of the feature map and 0 for one that the
caller's padding added: the block pads AFTER norm1, so a padding token enters
the attention as 0 and its qkv is the projection bias. It still attends and is
attended to; the caller crops its output row.

`swin_block` launches the hand-written CUDA kernel (`csrc/swin_block.cu`) for
tensors on the card and runs the plain PyTorch version, `swin_block_plain`,
for tensors on the CPU, through the registered operator
`yolact_torch::swin_block`, so that `torch.export` records the call; the
scratch and the grids stay inside the operator's CUDA side. Its backward, as
the JAX package's custom_vjp `_bwd`, recomputes the plain version under
autograd (gradients of x and the 13 parameters; none of rowmask or region):
it needs no scratch. It
counts its calls that launch the kernels in `swin_block.launches` (one a
call, whatever the launches in it).
`kernel_geometry` fixes the bf16 launches' grids, which the wrapper passes
to the kernel: at C = 96, 192 and 384 one launch over tiles of windows; at
C = 768 six over the rows taken as one flat [B*nW*N, C] matrix (LayerNorm1,
the attention, proj, LayerNorm2, fc1, fc2), passing what lies between them
through a scratch buffer. The tile shapes are the kernel's own, compiled
into it; `launch_shapes` holds this module's copy of them, and
`kernel_attributes` reads them from the compiled kernel.

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
from dataclasses import dataclass
from functools import lru_cache
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from yolact_minimal_torch.ops import _build
from yolact_minimal_torch.ops import attn_block as attn_ops
from yolact_minimal_torch.ops.attn_block import (Geometry, HeadGeometry, check_kernel_shape,
                                                 check_params, check_per_window, check_windows,
                                                 head_geometry, tiled_geometry)
from yolact_minimal_torch.ops.swin_mlp import LN_EPS
from yolact_minimal_torch.ops.window_attention import _sm_count, window_attention_plain

# The tiled bf16 kernel's shape per row width C, as csrc/swin_block.cu
# compiles it (`kernel_attributes` reports it from the compiled kernel): G
# windows a tile, CS warpgroups a window (each takes 1 / CS of every
# product's columns), ring slots, and the 64-wide k-blocks that one use of
# the ring carries for the qkv and for the fc1 product.
KERNEL_SHAPES = {96: (3, 1, 3, 2, 2), 192: (2, 1, 4, 1, 3), 384: (1, 2, 4, 2, 3)}
TOKENS = 49
WEIGHT_BOX_ROWS = (32, 96, 64, 96)    # TMA boxes of wqkv, wproj, k1, k2 (at most 256)
# The flat form's widths (C = 768): its bf16 launches, in order, pass the
# rows between them through a scratch buffer (`scratch_bytes`). The two
# LayerNorms take LN_ROWS rows a block, one a warp; the attention is
# attn_block's phase 1 (attn_ops.HEAD_SHAPES); each product of
# GEMM_LAUNCHES runs tiles of GEMM_ROWS rows by GEMM_SHAPES[launch] =
# (columns, ring slots, blocks a multiprocessor) on persistent blocks of 256
# threads, each slot a 64-wide k-block of both operands. csrc/swin_block.cu
# compiles these shapes (`launch_shapes`).
SCRATCH_WIDTHS = (768,)
FLAT_LAUNCHES = ('ln1', 'heads', 'proj', 'ln2', 'fc1', 'fc2')
GEMM_LAUNCHES = ('proj', 'fc1', 'fc2')
GEMM_ROWS = 128
GEMM_SHAPES = {'proj': (192, 4, 1), 'fc1': (128, 3, 2), 'fc2': (192, 4, 1)}
LN_ROWS = 8


def _align1k(n: int) -> int:
    return -(-n // 1024) * 1024


def launch_shapes(c: int) -> dict:
    """The tile shape of each bf16 launch at width c, by name, in the order
    they run, as csrc/swin_block.cu compiles it and `kernel_attributes`
    reports it: {'tiled': (windows a tile, warpgroups a window, ring slots)}
    at C = 96, 192 and 384; at C = 768 for each of FLAT_LAUNCHES, the
    LayerNorms' (rows a block,), the attention's (warpgroups a block, x ring
    slots a warpgroup) and a product's (rows a tile, columns a tile, ring
    slots, blocks a multiprocessor)."""
    if c in KERNEL_SHAPES:
        return {'tiled': KERNEL_SHAPES[c][:3]}
    if c not in SCRATCH_WIDTHS:
        raise ValueError(f'launch_shapes: the kernels take C in '
                         f'{tuple(KERNEL_SHAPES) + SCRATCH_WIDTHS}, got {c}')
    shapes = {k: (GEMM_ROWS,) + GEMM_SHAPES[k] for k in GEMM_LAUNCHES}
    shapes.update(ln1=(LN_ROWS,), ln2=(LN_ROWS,), heads=attn_ops.HEAD_SHAPES[c])
    return {name: shapes[name] for name in FLAT_LAUNCHES}


def shared_bytes(c: int) -> tuple:
    """Dynamic shared memory a block of each bf16 launch at width c, in the
    order of `launch_shapes`. Tiled: one launch, as
    BlockPlan<C> lays it out: per window the LN tile [64, C], the
    attention-output tile and one set of q, k, v tiles (two where CS > 1)
    with h [49, C] float32 over them, and where CS > 1 the gelu tile
    [64, 64]; then the ring, whose slots hold the largest use (KQ k-blocks of
    a head's 96 q | k | v rows, K1 of a chunk's 64 k1 rows, or one of CS x 96
    proj or k2 rows), its barriers (in the first window's unused tail where
    they fit) and 1 KB to align the base. C = 768: one value for each of
    FLAT_LAUNCHES (0 for the LayerNorms, which take none)."""
    if c in SCRATCH_WIDTHS:
        return (0, attn_ops.shared_bytes(c)[0], gemm_shared_bytes('proj'), 0,
                gemm_shared_bytes('fc1'), gemm_shared_bytes('fc2'))
    g, cs, stages, kq, k1 = KERNEL_SHAPES[c]
    tile = -(-c // 64) * 64 * 128
    qkv_sets = 2 if cs > 1 else 1
    used = max(2 * tile + qkv_sets * 3 * 64 * 64, tile + TOKENS * c * 4)
    window = _align1k(used) + (64 * 128 if cs > 1 else 0)
    slot = max(96 * kq, 64 * k1, 96 * cs) * 128
    barriers = 2 * stages * 8        # in window 0's unused tail where they fit
    tail = _align1k(used) - used >= barriers
    return (g * window + stages * slot + (0 if tail else barriers) + 1024,)


def scratch_bytes(bnw: int, c: int) -> int:
    """The flat form's scratch for bnw windows of width c: the hidden
    activations [rows, 4C] bf16, h [rows, C] float32, the attention output
    and the LayerNorm rows [rows, C] bf16 each (csrc/swin_block.cu,
    FlatScratch)."""
    return bnw * TOKENS * c * (8 + 4 + 2 + 2)


def gemm_shape(launch: str, c: int) -> Tuple[int, int]:
    """(K, N) of one of the flat form's products: A [rows, K] times B^T,
    B [N, K]."""
    return {'proj': (c, c), 'fc1': (c, 4 * c), 'fc2': (4 * c, c)}[launch]


def gemm_shared_bytes(launch: str) -> int:
    """A product block's ring: per slot the A rows [GEMM_ROWS, 64] and the B
    rows [columns, 64], 128 bytes a row; its barriers and 1 KB to align the
    base."""
    cols, stages, _ = GEMM_SHAPES[launch]
    return stages * (GEMM_ROWS + cols) * 128 + 2 * stages * 8 + 1024


@dataclass(frozen=True)
class FlatGeometry(HeadGeometry):
    """The flat form's six bf16 launches for bnw windows (C = 768): LN1 and
    LN2 on `ln_blocks` blocks of LN_ROWS rows; the attention as HeadGeometry
    (attn_block's phase 1); each product of GEMM_LAUNCHES on
    `gemm_blocks[i]` persistent blocks over `row_tiles` x `col_tiles[i]`
    tiles of GEMM_ROWS rows by its GEMM_SHAPES columns, tile t being row tile
    t // col_tiles[i] and column tile t % col_tiles[i]; block b takes tiles
    b, b + gemm_blocks[i], ..."""
    rows: int
    ln_blocks: int
    row_tiles: int
    col_tiles: Tuple[int, int, int]
    gemm_blocks: Tuple[int, int, int]

    def tiles(self, launch: str, block: int) -> List[Tuple[int, int]]:
        """The (row tile, column tile) pairs block `block` of a product walks,
        in its order."""
        i = GEMM_LAUNCHES.index(launch)
        n = self.col_tiles[i]
        return [divmod(t, n) for t in range(block, self.row_tiles * n, self.gemm_blocks[i])]

    def gemm_rounds(self, launch: str) -> int:
        """The most tiles a block of a product walks."""
        i = GEMM_LAUNCHES.index(launch)
        return -(-self.row_tiles * self.col_tiles[i] // self.gemm_blocks[i])

    @property
    def grids(self) -> Tuple[int, ...]:
        """Each launch's grid, in the order of FLAT_LAUNCHES, as the wrapper
        passes them to the kernel."""
        grid = dict(zip(GEMM_LAUNCHES, self.gemm_blocks), ln1=self.ln_blocks,
                    ln2=self.ln_blocks, heads=self.blocks)
        return tuple(grid[name] for name in FLAT_LAUNCHES)


@lru_cache(maxsize=64)
def kernel_geometry(bnw: int, c: int, sms: int):
    """The bf16 launches for bnw windows of width c on a card of `sms`
    multiprocessors, as csrc/swin_block.cu computes them. Tiled widths: a
    Geometry of tiles of G windows, one block a multiprocessor (each takes
    most of one's shared memory), or one a tile where there are fewer tiles.
    C = 768: a FlatGeometry, each product on its GEMM_SHAPES blocks a
    multiprocessor, or one a tile where there are fewer."""
    if bnw <= 0 or c not in (96, 192, 384, 768) or sms <= 0:
        raise ValueError(f'kernel_geometry: bnw={bnw}, c={c}, sms={sms}')
    if c in KERNEL_SHAPES:
        return tiled_geometry(bnw, KERNEL_SHAPES[c][0], sms)
    rows = bnw * TOKENS
    row_tiles = -(-rows // GEMM_ROWS)
    col_tiles = tuple(gemm_shape(k, c)[1] // GEMM_SHAPES[k][0] for k in GEMM_LAUNCHES)
    per_sm = tuple(GEMM_SHAPES[k][2] for k in GEMM_LAUNCHES)
    return FlatGeometry(**head_geometry(bnw, c, sms), rows=rows,
                        ln_blocks=-(-rows // LN_ROWS), row_tiles=row_tiles, col_tiles=col_tiles,
                        gemm_blocks=tuple(min(row_tiles * n, k * sms)
                                          for n, k in zip(col_tiles, per_sm)))


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
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'swin_block: unsupported device {x.device}')


def swin_block(x, rowmask: Optional[torch.Tensor], ln1_scale, ln1_bias, wqkv, bqkv, bias,
               region: Optional[torch.Tensor], wproj, bproj, ln2_scale, ln2_bias,
               k1, b1, k2, b2, heads: int) -> torch.Tensor:
    """Kernel wrapper: CUDA kernel for tensors on the card, plain version
    for tensors on the CPU, through the registered operator. Window w of the
    batch-major leading axis uses row w % nW of rowmask and of region. A
    caller that runs in bfloat16 passes the four weight matrices already in
    bfloat16; float32 weights are rounded here, on every call."""
    args = (x, rowmask, ln1_scale, ln1_bias, wqkv, bqkv, bias, region, wproj, bproj,
            ln2_scale, ln2_bias, k1, b1, k2, b2, heads)
    _check(*args)
    return _swin_block_op(*args)


@torch.library.custom_op('yolact_torch::swin_block', mutates_args=(),
                         device_types=('cpu', 'cuda'))
def _swin_block_op(x: torch.Tensor, rowmask: Optional[torch.Tensor], ln1_scale: torch.Tensor,
                   ln1_bias: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor,
                   bias: torch.Tensor, region: Optional[torch.Tensor], wproj: torch.Tensor,
                   bproj: torch.Tensor, ln2_scale: torch.Tensor, ln2_bias: torch.Tensor,
                   k1: torch.Tensor, b1: torch.Tensor, k2: torch.Tensor, b2: torch.Tensor,
                   heads: int) -> torch.Tensor:
    """The plain version on the CPU, the kernel on the card: its flat form's
    scratch and every launch's grid are made here, never in the fake."""
    if x.device.type == 'cpu':
        return swin_block_plain(x, rowmask, ln1_scale, ln1_bias, wqkv, bqkv, bias, region,
                                wproj, bproj, ln2_scale, ln2_bias, k1, b1, k2, b2, heads)
    check_kernel_shape('swin_block', x, heads)
    wqkv, wproj, k1, k2 = (w.to(x.dtype) for w in (wqkv, wproj, k1, k2))
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    is_bf16 = x.dtype == torch.bfloat16
    bnw, _, c = x.shape
    scratch, grids = None, None
    if is_bf16:
        geo = kernel_geometry(bnw, c, _sm_count(x.device.index or 0))
        flat = c in SCRATCH_WIDTHS
        grids = (ctypes.c_int * len(FLAT_LAUNCHES))(*(geo.grids if flat else (geo.blocks,)))
        if flat:
            scratch = torch.empty(scratch_bytes(bnw, c), dtype=torch.uint8, device=x.device)
    nw = rowmask.shape[0] if rowmask is not None else \
        region.shape[0] if region is not None else 0
    lib = _build.load('swin_block')
    fn = lib.swin_block
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _build.launch(fn, ptr(x), ptr(rowmask), ptr(ln1_scale), ptr(ln1_bias), ptr(wqkv),
                      ptr(bqkv), ptr(bias), ptr(region), ptr(wproj), ptr(bproj),
                      ptr(ln2_scale), ptr(ln2_bias), ptr(k1), ptr(b1), ptr(k2), ptr(b2),
                      ptr(scratch), ptr(out), bnw, c, nw, int(is_bf16),
                      None if grids is None else ctypes.addressof(grids), stream)
    swin_block.launches += 1
    return out


@_swin_block_op.register_fake
def _(x, rowmask, ln1_scale, ln1_bias, wqkv, bqkv, bias, region, wproj, bproj, ln2_scale,
      ln2_bias, k1, b1, k2, b2, heads):
    return torch.empty_like(x)


# gradients for all inputs but rowmask (1), region (7) and heads (16)
_build.register_plain_backward(_swin_block_op, swin_block_plain,
                               (0, 2, 3, 4, 5, 6, 8, 9, 10, 11, 12, 13, 14, 15))


swin_block.launches = 0


ATTRIBUTE_KEYS = ('threads', 'smem_bytes', 'registers', 'spill_bytes')


def kernel_attributes(c: int) -> dict:
    """The compiled bf16 launches at width c, by the names of
    `launch_shapes`: each the threads and dynamic shared memory bytes a
    block, the registers and local (spill) bytes a thread, and the tile
    `shape` compiled into it, which should be the one `launch_shapes`
    states."""
    names = list(launch_shapes(c))
    fn = _build.load('swin_block').swin_block_attributes
    attrs = {}
    for which, name in enumerate(names):
        out = (ctypes.c_int * 8)()
        _build.launch(fn, c, which, ctypes.addressof(out))
        attrs[name] = dict(zip(ATTRIBUTE_KEYS, out),
                           shape=tuple(v for v in out[len(ATTRIBUTE_KEYS):] if v))
    return attrs
