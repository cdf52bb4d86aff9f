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
from yolact_minimal_torch.ops.boxes import sanitize_coordinates
from yolact_minimal_torch.ops.nms import (Detections, assemble_masks,
                                          finalize_masks_fixed)
from yolact_minimal_torch.ops.resize import _gather_lerp

# Output rows of one work item (a band of a slot's plane).
BAND_ROWS = 32
# Dynamic shared memory a block may take on an H100 (227 KB).
_MAX_SMEM = 232448


def mask_finalize_plain(proto, coefs, boxes, valid, out_size: int,
                        do_crop: bool = True) -> torch.Tensor:
    """proto [B, ph, pw, C], coefs [B, D, C], boxes [B, D, 4], valid [B, D]
    -> bool [B, D, S, S]."""
    dets = Detections(None, None, boxes, coefs, valid)
    return finalize_masks_fixed(assemble_masks(proto, dets, do_crop), out_size)


def _reach(lo: np.ndarray, hi: np.ndarray, n: int):
    """For each of the n source pixels r: the first output index whose taps
    (lo, hi) reach r or beyond (len(lo) where none does) and the last whose
    taps reach r or before (-1 where none does). Both tables are
    nondecreasing, so a crop [r0, r1) reaches the outputs
    [first[r0], last[r1 - 1] + 1) and no other."""
    r = np.arange(n)
    first = np.searchsorted(hi, r, side='left')
    last = np.searchsorted(lo, r, side='right') - 1
    return first.astype(np.int32), last.astype(np.int32)


@lru_cache(maxsize=None)
def _tables(ph: int, pw: int, out_size: int, device: torch.device):
    """The kernel's ten tables on `device`: the row and column 2-tap tables
    (lo_h, hi_h, fh, lo_w, hi_w, fw, each [out_size]) and the first/last
    output row and column that each proto row and column reaches (first_h,
    last_h [ph], first_w, last_w [pw]); and the most proto rows the taps of
    one band of BAND_ROWS output rows reach."""
    lo_h, hi_h, fh = _gather_lerp(ph, out_size, False)
    lo_w, hi_w, fw = _gather_lerp(pw, out_size, False)
    starts = np.arange(0, out_size, BAND_ROWS)
    ends = np.minimum(starts + BAND_ROWS, out_size) - 1
    tile_rows = int((hi_h[ends] - lo_h[starts]).max()) + 1
    tabs = (lo_h, hi_h, fh, lo_w, hi_w, fw, *_reach(lo_h, hi_h, ph), *_reach(lo_w, hi_w, pw))
    return tuple(torch.from_numpy(np.ascontiguousarray(t)).to(device) for t in tabs), tile_rows


def output_windows(boxes, valid, ph: int, pw: int, out_size: int,
                   do_crop: bool = True) -> torch.Tensor:
    """Each slot's output window as the kernel finds it: int64 [B, D, 4] of
    (oy0, oy1, ox0, ox1), the rows [oy0, oy1) and columns [ox0, ox1) outside
    which every mask pixel is 0; (0, 0, 0, 0) for an invalid slot or a crop
    that keeps no proto pixel or reaches no output."""
    tabs, _ = _tables(ph, pw, out_size, torch.device('cpu'))
    first_h, last_h, first_w, last_w = (t.long() for t in tabs[6:])
    b, d = valid.shape
    boxes, valid = boxes.detach().cpu().float(), valid.detach().cpu()
    if do_crop:
        x1, x2 = sanitize_coordinates(boxes[..., 0], boxes[..., 2], pw, 1)
        y1, y2 = sanitize_coordinates(boxes[..., 1], boxes[..., 3], ph, 1)
        # the proto pixels the crop keeps: the integers c with x1 <= c < x2
        c0, c1, r0, r1 = (v.ceil().long() for v in (x1, x2, y1, y2))
    else:
        c0 = r0 = torch.zeros((b, d), dtype=torch.long)
        c1, r1 = torch.full((b, d), pw), torch.full((b, d), ph)
    keep = valid & (c0 < c1) & (r0 < r1)
    c0, r0 = c0.clamp(0, pw - 1), r0.clamp(0, ph - 1)
    c1, r1 = c1.clamp(1, pw), r1.clamp(1, ph)
    win = torch.stack([first_h[r0], last_h[r1 - 1] + 1, first_w[c0], last_w[c1 - 1] + 1], -1)
    keep &= (win[..., 0] < win[..., 1]) & (win[..., 2] < win[..., 3])
    return torch.where(keep[..., None], win, torch.zeros_like(win))


@lru_cache(maxsize=None)
def _work_counters(device: torch.device, stream: int) -> torch.Tensor:
    """The kernel's two work counters for launches on `stream`: zero, and left
    zero by every launch, so one pair serves all launches of a stream."""
    return torch.zeros(2, dtype=torch.int32, device=device)


GEOMETRY_KEYS = ('blocks', 'threads', 'blocks_per_sm', 'sms', 'smem_bytes', 'registers',
                 'spill_bytes', 'items')


@lru_cache(maxsize=64)
def kernel_geometry(n_slots: int, out_size: int, nc: int, tile_rows: int, pw: int,
                    device_index: int) -> dict:
    """The launch on card `device_index` for n_slots slots of out_size x
    out_size: persistent blocks, as many as stay resident and at most one a
    (slot, band) item, with the registers and local (spill) bytes a thread
    that the compiled kernel reports."""
    out = (ctypes.c_int * len(GEOMETRY_KEYS))()
    fn = _build.load('mask_finalize').mask_finalize_geometry
    with torch.cuda.device(device_index):
        _build.launch(fn, n_slots, out_size, nc, BAND_ROWS, tile_rows, pw,
                      ctypes.addressof(out))
    return dict(zip(GEOMETRY_KEYS, out))


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
    if max(ph, pw) > 65535:
        raise ValueError(f'mask_finalize: proto {ph}x{pw} is wider than the '
                         '16-bit column taps of the kernel')
    tabs, tile_rows = _tables(ph, pw, out_size, proto.device)
    # csrc/mask_finalize.cu::smem_bytes: column taps, coefficients, row taps,
    # the m tile and the row mix
    smem = 4 * (2 * out_size + nc + 3 * BAND_ROWS + (tile_rows + BAND_ROWS) * pw)
    if smem > _MAX_SMEM:
        raise ValueError(f'mask_finalize: a block needs {smem} bytes of shared '
                         f'memory (proto {ph}x{pw}x{nc} -> {out_size})')
    out = torch.empty((b, d, out_size, out_size), dtype=torch.bool,
                      device=proto.device)
    if out.numel() == 0:
        return out
    if proto.data_ptr() % 16:
        proto = proto.clone()          # the kernel reads a pixel as 16-byte loads
    index = proto.device.index if proto.device.index is not None else torch.cuda.current_device()
    geo = kernel_geometry(b * d, out_size, nc, tile_rows, pw, index)
    lib = _build.load('mask_finalize')
    fn = lib.mask_finalize
    tables = (ctypes.c_void_p * len(tabs))(*(t.data_ptr() for t in tabs))
    with torch.cuda.device(proto.device):
        stream = torch.cuda.current_stream(proto.device).cuda_stream
        work = _work_counters(proto.device, stream)
        _build.launch(fn, proto.data_ptr(), coefs.data_ptr(), boxes.data_ptr(),
                      valid.data_ptr(), ctypes.addressof(tables), out.data_ptr(),
                      work.data_ptr(), b, ph, pw, nc, d, out_size, BAND_ROWS, tile_rows,
                      int(do_crop), geo['blocks'], stream)
    mask_finalize.launches += 1
    return out


mask_finalize.launches = 0
