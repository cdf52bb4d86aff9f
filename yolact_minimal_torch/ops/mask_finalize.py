"""Fused detect-mask finalize: lincomb -> crop -> bilinear upsample -> > 0.5.

`mask_finalize` launches the hand-written CUDA kernel
(`csrc/mask_finalize.cu`) for tensors on the card and runs the plain PyTorch
version, `mask_finalize_plain` (= `finalize_masks_fixed(assemble_masks(...))`),
for tensors on the CPU. It counts its kernel launches in
`mask_finalize.launches`.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from yolact_minimal_torch.ops import _build
from yolact_minimal_torch.ops.nms import (Detections, assemble_masks,
                                          finalize_masks_fixed)
from yolact_minimal_torch.ops.resize import _gather_lerp

# Output rows per block.
BAND_ROWS = 32
# Dynamic shared memory a block may take on an H100 (227 KB).
_MAX_SMEM = 232448


def mask_finalize_plain(proto, coefs, boxes, valid, out_size: int,
                        do_crop: bool = True) -> torch.Tensor:
    """proto [B, ph, pw, C], coefs [B, D, C], boxes [B, D, 4], valid [B, D]
    -> bool [B, D, S, S]."""
    dets = Detections(None, None, boxes, coefs, valid)
    return finalize_masks_fixed(assemble_masks(proto, dets, do_crop), out_size)


@lru_cache(maxsize=None)
def _tables(ph: int, pw: int, out_size: int, device: torch.device):
    """Row and column 2-tap tables on `device`, and the most proto rows one
    band of BAND_ROWS output rows reads."""
    lo_h, hi_h, fh = _gather_lerp(ph, out_size, False)
    lo_w, hi_w, fw = _gather_lerp(pw, out_size, False)
    starts = np.arange(0, out_size, BAND_ROWS)
    ends = np.minimum(starts + BAND_ROWS, out_size) - 1
    proto_rows = int((hi_h[ends] - lo_h[starts]).max()) + 1
    tabs = tuple(torch.from_numpy(np.ascontiguousarray(t)).to(device)
                 for t in (lo_h, hi_h, fh, lo_w, hi_w, fw))
    return tabs, proto_rows


def _check(proto, coefs, boxes, valid, out_size):
    if proto.dim() != 4 or coefs.dim() != 3 or boxes.dim() != 3 or valid.dim() != 2:
        raise ValueError('mask_finalize takes proto [B, ph, pw, C], coefs '
                         '[B, D, C], boxes [B, D, 4] and valid [B, D]')
    b, _, _, nc = proto.shape
    d = coefs.shape[1]
    if coefs.shape != (b, d, nc) or boxes.shape != (b, d, 4) or valid.shape != (b, d):
        raise ValueError(f'mask_finalize shapes disagree: proto {tuple(proto.shape)}, '
                         f'coefs {tuple(coefs.shape)}, boxes {tuple(boxes.shape)}, '
                         f'valid {tuple(valid.shape)}')
    for name, t in (('proto', proto), ('coefs', coefs), ('boxes', boxes)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f'mask_finalize: {name} must be contiguous float32')
    if valid.dtype != torch.bool or not valid.is_contiguous():
        raise ValueError('mask_finalize: valid must be contiguous bool')
    if len({t.device for t in (proto, coefs, boxes, valid)}) != 1:
        raise ValueError('mask_finalize: inputs lie on different devices')
    if out_size <= 0:
        raise ValueError(f'mask_finalize: out_size {out_size}')


def mask_finalize(proto, coefs, boxes, valid, out_size: int,
                  do_crop: bool = True) -> torch.Tensor:
    """Kernel wrapper: CUDA kernel for tensors on the card, plain version
    for tensors on the CPU. Returns bool [B, D, out_size, out_size]."""
    _check(proto, coefs, boxes, valid, out_size)
    if proto.device.type == 'cpu':
        return mask_finalize_plain(proto, coefs, boxes, valid, out_size, do_crop)
    if proto.device.type != 'cuda':
        raise ValueError(f'mask_finalize: unsupported device {proto.device}')
    b, ph, pw, nc = proto.shape
    d = coefs.shape[1]
    if d > 65535 or b > 65535:
        raise ValueError(f'mask_finalize: grid too large (B={b}, D={d})')
    tabs, proto_rows = _tables(ph, pw, out_size, proto.device)
    smem = (nc + proto_rows * pw) * 4
    if smem > _MAX_SMEM:
        raise ValueError(f'mask_finalize: a band needs {smem} bytes of shared '
                         f'memory (proto {ph}x{pw}x{nc} -> {out_size})')
    out = torch.empty((b, d, out_size, out_size), dtype=torch.bool,
                      device=proto.device)
    if out.numel() == 0:
        return out
    lib = _build.load('mask_finalize')
    fn = lib.mask_finalize
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(proto.device):
        stream = torch.cuda.current_stream(proto.device).cuda_stream
        _build.launch(fn, proto.data_ptr(), coefs.data_ptr(), boxes.data_ptr(),
                      valid.data_ptr(), *(t.data_ptr() for t in tabs),
                      out.data_ptr(), b, ph, pw, nc, d, out_size, BAND_ROWS,
                      proto_rows, int(do_crop), stream)
    mask_finalize.launches += 1
    return out


mask_finalize.launches = 0
