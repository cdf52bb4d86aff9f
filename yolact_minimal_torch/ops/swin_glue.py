"""The layout glue of a Swin block's attention half, one pass each way.

`to_windows(x, scale, bias, window, shift)` takes x [B, H, W, C] to the
windows the attention runs on, [B * nW, window^2, C]: norm1 (LayerNorm in
float32, eps 1e-5, rounded once to x's dtype), zero padding bottom and right
to a multiple of the window (after the norm), a roll by -shift on both
spatial axes, and the window partition. `from_windows(y, shortcut, window,
shift)` takes the attention's windows back: the reverse partition, the roll
by +shift, the crop to shortcut's [B, H, W, C], and `shortcut +` in float32,
rounded once. Each launches a hand-written CUDA kernel (`csrc/swin_glue.cu`)
for tensors on the card and runs its plain PyTorch version
(`to_windows_plain`, `from_windows_plain`) for tensors on the CPU, through
the registered operators `yolact_torch::to_windows` and
`yolact_torch::from_windows`, so that `torch.export` records the calls. Each
counts its launches in `to_windows.launches` / `from_windows.launches`. The
kernels have no backward: models/swin.py takes them only for calls that
need no gradient, and runs the plain glue (`partition`, `reverse`) under
autograd.

The plain versions are the composition models/swin.py ran before the
kernels, and their reference: `to_windows_plain` is `partition` of the
rounded LayerNorm, `from_windows_plain` is `shortcut + reverse(y)`.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from yolact_minimal_torch.ops import _build

LN_EPS = 1e-5
# The widths the kernels are built for: Swin-T's and Swin-L's stages.
KERNEL_WIDTHS = (96, 192, 384, 768, 1536)


def padded(h: int, w: int, window: int) -> Tuple[int, int]:
    """h and w padded up to a multiple of the window."""
    return -(-h // window) * window, -(-w // window) * window


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """[B, H, W, C] -> [B * nW, window*window, C]."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def window_reverse(x: torch.Tensor, window: int, h: int, w: int) -> torch.Tensor:
    """[B * nW, window*window, C] -> [B, H, W, C]."""
    c = x.shape[-1]
    b = x.shape[0] // ((h // window) * (w // window))
    x = x.reshape(b, h // window, w // window, window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def partition(x: torch.Tensor, window: int, shift: int) -> torch.Tensor:
    """x [B, H, W, C] padded bottom and right with zeros to a multiple of the
    window, rolled by -shift and partitioned: [B * nW, window^2, C]."""
    _, h, w, _ = x.shape
    hp, wp = padded(h, w, window)
    if (hp, wp) != (h, w):
        x = F.pad(x, (0, 0, 0, wp - w, 0, hp - h))
    if shift > 0:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    return window_partition(x, window)


def reverse(windows: torch.Tensor, window: int, shift: int, h: int, w: int) -> torch.Tensor:
    """The inverse of `partition` for an h x w map: [B, h, w, C]."""
    hp, wp = padded(h, w, window)
    x = window_reverse(windows, window, hp, wp)
    if shift > 0:
        x = torch.roll(x, (shift, shift), dims=(1, 2))
    return x[:, :h, :w, :] if (hp, wp) != (h, w) else x


def to_windows_plain(x, scale, bias, window: int, shift: int) -> torch.Tensor:
    xn = F.layer_norm(x.float(), (x.shape[-1],), scale, bias, LN_EPS).to(x.dtype)
    return partition(xn, window, shift)


def from_windows_plain(y, shortcut, window: int, shift: int) -> torch.Tensor:
    return shortcut + reverse(y, window, shift, shortcut.shape[1], shortcut.shape[2])


def _check_geometry(name, x, window, shift):
    if x.dim() != 4 or x.dtype not in (torch.float32, torch.bfloat16) or \
            not x.is_contiguous():
        raise ValueError(f'{name} takes a contiguous float32 or bfloat16 map [B, H, W, C], '
                         f'got {x.dtype} {tuple(x.shape)}')
    if window <= 0 or not 0 <= shift < window:
        raise ValueError(f'{name}: need window > 0 and 0 <= shift < window, '
                         f'got {window}, {shift}')


def _check_devices(name, c, tensors):
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f'{name}: inputs lie on different devices')
    device = tensors[0].device
    if device.type not in ('cpu', 'cuda'):
        raise ValueError(f'{name}: unsupported device {device}')
    if device.type == 'cuda' and c not in KERNEL_WIDTHS:
        raise ValueError(f'{name}: the kernel takes C in {KERNEL_WIDTHS}, got {c}')


def _aligned(name, tensors):
    """The kernels read and write 16-byte vectors. Checked in the operator,
    on the tensors it launches on: a traced call's have no data."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f'{name}: an input is not 16-byte aligned')


def _check_to(x, scale, bias, window, shift):
    _check_geometry('to_windows', x, window, shift)
    c = x.shape[-1]
    for name, t in (('scale', scale), ('bias', bias)):
        if t.shape != (c,) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f'to_windows: {name} must be contiguous float32 ({c},), '
                             f'got {t.dtype} {tuple(t.shape)}')
    _check_devices('to_windows', c, (x, scale, bias))


def _check_from(y, shortcut, window, shift):
    _check_geometry('from_windows', shortcut, window, shift)
    b, h, w, c = shortcut.shape
    hp, wp = padded(h, w, window)
    shape = (b * hp * wp // (window * window), window * window, c)
    if y.shape != shape or y.dtype != shortcut.dtype or not y.is_contiguous():
        raise ValueError(f'from_windows: y must be contiguous {shortcut.dtype} {shape}, '
                         f'got {y.dtype} {tuple(y.shape)}')
    _check_devices('from_windows', c, (y, shortcut))


def to_windows(x, scale, bias, window: int, shift: int) -> torch.Tensor:
    """Kernel wrapper: the CUDA kernel for tensors on the card, the plain
    version for tensors on the CPU, through the registered operator."""
    _check_to(x, scale, bias, window, shift)
    return _to_windows_op(x, scale, bias, window, shift)


def from_windows(y, shortcut, window: int, shift: int) -> torch.Tensor:
    """Kernel wrapper: the CUDA kernel for tensors on the card, the plain
    version for tensors on the CPU, through the registered operator."""
    _check_from(y, shortcut, window, shift)
    return _from_windows_op(y, shortcut, window, shift)


def _windows_like(x, window):
    b, h, w, c = x.shape
    hp, wp = padded(h, w, window)
    return x.new_empty(b * hp * wp // (window * window), window * window, c)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


@torch.library.custom_op('yolact_torch::to_windows', mutates_args=(),
                         device_types=('cpu', 'cuda'))
def _to_windows_op(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, window: int,
                   shift: int) -> torch.Tensor:
    if x.device.type == 'cpu':
        return to_windows_plain(x, scale, bias, window, shift)
    _aligned('to_windows', (x, scale, bias))
    out = _windows_like(x, window)
    b, h, w, c = x.shape
    with torch.cuda.device(x.device):
        _build.launch(_build.load('swin_glue').swin_glue_to_windows, x.data_ptr(),
                      scale.data_ptr(), bias.data_ptr(), out.data_ptr(), b, h, w, c, window,
                      shift, int(x.dtype == torch.bfloat16), _stream(x))
    to_windows.launches += 1
    return out


@_to_windows_op.register_fake
def _(x, scale, bias, window, shift):
    return _windows_like(x, window)


@torch.library.custom_op('yolact_torch::from_windows', mutates_args=(),
                         device_types=('cpu', 'cuda'))
def _from_windows_op(y: torch.Tensor, shortcut: torch.Tensor, window: int,
                     shift: int) -> torch.Tensor:
    if y.device.type == 'cpu':
        return from_windows_plain(y, shortcut, window, shift)
    _aligned('from_windows', (y, shortcut))
    out = torch.empty_like(shortcut)
    b, h, w, c = shortcut.shape
    with torch.cuda.device(y.device):
        _build.launch(_build.load('swin_glue').swin_glue_from_windows, y.data_ptr(),
                      shortcut.data_ptr(), out.data_ptr(), b, h, w, c, window, shift,
                      int(y.dtype == torch.bfloat16), _stream(y))
    from_windows.launches += 1
    return out


@_from_windows_op.register_fake
def _(y, shortcut, window, shift):
    return torch.empty_like(shortcut)


to_windows.launches = 0
from_windows.launches = 0
