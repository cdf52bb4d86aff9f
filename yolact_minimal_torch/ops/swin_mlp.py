"""The MLP half of a Swin block: y = x + fc2(gelu_erf(fc1(LayerNorm(x)))).

`mlp_block` launches the hand-written CUDA kernel (`csrc/swin_mlp.cu`) for
tensors on the card and runs the plain PyTorch version, `mlp_block_plain`,
for tensors on the CPU, through the registered operator
`yolact_torch::mlp_block`, so that `torch.export` records the call and an
exported program launches the kernel. `mlp_form` says how a call runs: in
bf16 at the widths of `WIDE_WIDTHS` as three launches (LayerNorm, then fc1
and fc2 on a persistent warp-specialised GEMM kernel) with the hidden
activations in device memory, at the other widths of `MLP_WIDTHS`, and in
float32 at every one, as one fused kernel. It counts its calls on the card
in `mlp_block.launches`, once a call in either form. The operator's backward
(`register_autograd`) recomputes the plain version from the saved inputs, as
the JAX package's custom_vjp does through its XLA form; gradients go to x,
the LayerNorm scale and bias, k1, b1, k2 and b2.

Rounding places, shared by the plain version, both forms and the JAX
package's kernel: LayerNorm in float32 (eps 1e-5), rounded to the compute
dtype; fc1 accumulates in float32, `+ b1` in float32, rounded; gelu (erf) in
float32, rounded; fc2 accumulates in float32, `+ b2` and `+ x` in float32,
rounded once. The compute dtype is x's. Weights are laid out as nn.Linear
keeps them: k1 [4C, C], k2 [C, 4C].
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from yolact_minimal_torch.ops import _build

LN_EPS = 1e-5
# swin_tiny's four stage widths (kernels 5 and 6 take the same).
KERNEL_WIDTHS = (96, 192, 384, 768)
# The widths kernel 4 takes: swin_tiny's and swin_large's stages.
MLP_WIDTHS = KERNEL_WIDTHS + (1536,)
# bf16 widths that run as three launches: there a tile of the fused kernel
# cannot hold its rows' fc2 accumulators and LN(x) on chip at a size that
# keeps the tensor cores busy, and the two GEMM launches are faster at
# Swin-T's and Swin-L's row counts alike (PERF.md).
WIDE_WIDTHS = (384, 768, 1536)


def mlp_form(c: int, dtype: torch.dtype, device_type: str = 'cuda') -> str:
    """How `mlp_block` runs rows of width c in `dtype` on a device of that
    type: 'plain' on the CPU; on the card 'wide' (LayerNorm, fc1 and fc2 as
    three launches) for bf16 rows of a width in WIDE_WIDTHS, else 'fused'
    (one kernel)."""
    if device_type == 'cpu':
        return 'plain'
    return 'wide' if dtype == torch.bfloat16 and c in WIDE_WIDTHS else 'fused'


def mlp_block_plain(x, ln_scale, ln_bias, k1, b1, k2, b2) -> torch.Tensor:
    """x [R, C] (float32 or bfloat16), ln_scale/ln_bias [C], k1 [4C, C],
    b1 [4C], k2 [C, 4C], b2 [C] -> [R, C] in x's dtype. Weights in another
    dtype than x's are rounded to it first."""
    dt = x.dtype
    xf = x.float()
    xn = F.layer_norm(xf, (x.shape[-1],), ln_scale.float(), ln_bias.float(), LN_EPS).to(dt)
    # products of two bf16 values are exact in float32: float() operands give
    # the float32 accumulation and float32 bias add the kernels have
    h = F.linear(xn.float(), k1.to(dt).float(), b1.float()).to(dt)
    h = F.gelu(h.float()).to(dt)
    y = F.linear(h.float(), k2.to(dt).float(), b2.float())
    return (xf + y).to(dt)


def _check(x, ln_scale, ln_bias, k1, b1, k2, b2):
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.bfloat16) or \
            not x.is_contiguous():
        raise ValueError('mlp_block takes contiguous float32 or bfloat16 rows [R, C], '
                         f'got {x.dtype} {tuple(x.shape)}')
    c = x.shape[1]
    for name, t, shape in (('ln_scale', ln_scale, (c,)), ('ln_bias', ln_bias, (c,)),
                           ('b1', b1, (4 * c,)), ('b2', b2, (c,))):
        if t.shape != shape or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f'mlp_block: {name} must be contiguous float32 {shape}, '
                             f'got {t.dtype} {tuple(t.shape)}')
    for name, t, shape in (('k1', k1, (4 * c, c)), ('k2', k2, (c, 4 * c))):
        if t.shape != shape or t.dtype not in (x.dtype, torch.float32) or \
                not t.is_contiguous():
            raise ValueError(f'mlp_block: {name} must be contiguous {shape} in x\'s dtype '
                             f'or float32, got {t.dtype} {tuple(t.shape)}')
    if len({t.device for t in (x, ln_scale, ln_bias, k1, b1, k2, b2)}) != 1:
        raise ValueError('mlp_block: inputs lie on different devices')
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'mlp_block: unsupported device {x.device}')


def mlp_block(x, ln_scale, ln_bias, k1, b1, k2, b2) -> torch.Tensor:
    """Kernel wrapper: CUDA kernel for tensors on the card, plain version
    for tensors on the CPU, through the registered operator (its backward
    recomputes the plain version).
    A caller that runs in bfloat16 passes k1 and k2 already in bfloat16
    (models/swin.py keeps such copies per block); float32 weights are
    rounded here, on every call."""
    _check(x, ln_scale, ln_bias, k1, b1, k2, b2)
    return _mlp_block_op(x, ln_scale, ln_bias, k1, b1, k2, b2)


def _forward(x, ln_scale, ln_bias, k1, b1, k2, b2):
    """The operator on a CPU or CUDA tensor: the plain version on the CPU,
    the kernel on the card."""
    form = mlp_form(x.shape[1], x.dtype, x.device.type)
    if form == 'plain':
        return mlp_block_plain(x, ln_scale, ln_bias, k1, b1, k2, b2)
    rows, c = x.shape
    if c not in MLP_WIDTHS:
        raise ValueError(f'mlp_block: the kernel takes C in {MLP_WIDTHS}, got {c}')
    k1, k2 = k1.to(x.dtype), k2.to(x.dtype)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    lib = _build.load('swin_mlp')
    ptrs = [t.data_ptr() for t in (x, ln_scale, ln_bias, k1, b1, k2, b2, out)]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if form == 'wide':
            # room for LN(x) [rows, c] and the hidden activations [rows, 4c]
            # after it, from PyTorch's cache
            room = x.new_empty(5 * rows * c)
            fn = lib.swin_mlp_wide
            args = (*ptrs, room.data_ptr(), room[rows * c:].data_ptr(), rows, c)
        else:
            fn = lib.swin_mlp
            args = (*ptrs, rows, c, int(x.dtype == torch.bfloat16))
        _build.launch(fn, *args, stream)
    mlp_block.launches += 1
    return out


@torch.library.custom_op('yolact_torch::mlp_block', mutates_args=(),
                         device_types=('cpu', 'cuda'))
def _mlp_block_op(x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                  k1: torch.Tensor, b1: torch.Tensor, k2: torch.Tensor,
                  b2: torch.Tensor) -> torch.Tensor:
    # `_forward` is looked up at each call: a test may wrap it
    return _forward(x, ln_scale, ln_bias, k1, b1, k2, b2)


@_mlp_block_op.register_fake
def _(x, ln_scale, ln_bias, k1, b1, k2, b2):
    return torch.empty_like(x)


# gradients for all seven inputs
_build.register_plain_backward(_mlp_block_op, mlp_block_plain, tuple(range(7)))

mlp_block.launches = 0


GEOMETRY_KEYS = ('rows_per_tile', 'cluster', 'blocks', 'tiles', 'stages', 'smem_bytes',
                 'threads', 'registers', 'spill_bytes', 'cols_per_tile', 'col_tiles')
# kernel_geometry's launches, as swin_mlp_geometry numbers them
GEOMETRY_LAUNCHES = {'fused': 0, 'fc1': 1, 'fc2': 2}


def kernel_geometry(c: int, rows: int, launch: str) -> dict:
    """A bf16 launch's geometry for `rows` rows of width `c` on the current
    card, with the registers and local (spill) bytes a thread that the
    compiled kernel reports: `launch` 'fused' (the one kernel), or 'fc1' or
    'fc2' (the wide form's GEMM launches; a tile is rows_per_tile x
    cols_per_tile of the product's output, `tiles` of them)."""
    out = (ctypes.c_int * len(GEOMETRY_KEYS))()
    fn = _build.load('swin_mlp').swin_mlp_geometry
    _build.launch(fn, c, rows, GEOMETRY_LAUNCHES[launch], ctypes.addressof(out))
    return dict(zip(GEOMETRY_KEYS, out))
