"""Triangular IoU-max suppression: the fast-NMS core.

`suppression_iou_max` launches the hand-written CUDA kernel
(`csrc/suppression.cu`) for tensors on the card and runs the plain PyTorch
version, `suppression_iou_max_plain`, for tensors on the CPU. It counts its
kernel launches in `suppression_iou_max.launches`.
"""
from __future__ import annotations

import ctypes

import torch

from yolact_minimal_torch.ops import _build
from yolact_minimal_torch.ops.boxes import box_iou

# Largest row length the kernel takes: it keeps a candidate's compacted
# position in 16 bits, and its shared memory (42 bytes a candidate, 86 KB at
# 2048) stays below the 227 KB a block may opt in to.
MAX_K = 2048

GEOMETRY_KEYS = ('blocks', 'threads', 'smem_bytes', 'blocks_per_sm', 'registers',
                 'spill_bytes')


def suppression_iou_max_plain(x1, y1, x2, y2, valid) -> torch.Tensor:
    """[R, K] planes + bool validity -> [R, K]: each candidate's max IoU
    against the earlier (higher-scored) valid candidates of its row. Invalid
    pairs give 0; a valid pair of zero-area boxes gives NaN, and the max
    keeps it."""
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)
    iou = box_iou(boxes, boxes)
    pair = valid[..., None, :] & valid[..., :, None]
    iou = torch.where(pair, iou, torch.zeros((), dtype=iou.dtype, device=iou.device))
    iou = torch.triu(iou, diagonal=1)
    return iou.amax(dim=-2)


def _check(x1, y1, x2, y2, valid):
    for t in (x1, y1, x2, y2):
        if t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError('suppression_iou_max takes contiguous float32 '
                             f'[R, K] planes, got {t.dtype} {tuple(t.shape)}')
        if t.shape != x1.shape or t.device != x1.device:
            raise ValueError('suppression_iou_max planes differ in shape or device')
    if valid.dtype != torch.bool or valid.shape != x1.shape or \
            valid.device != x1.device or not valid.is_contiguous():
        raise ValueError('suppression_iou_max takes a contiguous bool validity '
                         'of the planes\' shape and device')


def suppression_iou_max(x1, y1, x2, y2, valid) -> torch.Tensor:
    """Kernel wrapper: CUDA kernel for tensors on the card, plain version
    for tensors on the CPU."""
    _check(x1, y1, x2, y2, valid)
    if x1.device.type == 'cpu':
        return suppression_iou_max_plain(x1, y1, x2, y2, valid)
    if x1.device.type != 'cuda':
        raise ValueError(f'suppression_iou_max: unsupported device {x1.device}')
    rows, k = x1.shape
    if k > MAX_K:
        raise ValueError(f'suppression_iou_max: K={k} exceeds {MAX_K}')
    out = torch.empty_like(x1)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream(x1.device).cuda_stream
        _build.launch(_build.load('suppression').suppression_iou_max, x1.data_ptr(),
                      y1.data_ptr(), x2.data_ptr(), y2.data_ptr(), valid.data_ptr(),
                      out.data_ptr(), rows, k, stream)
    suppression_iou_max.launches += 1
    return out


suppression_iou_max.launches = 0


def kernel_geometry(rows: int, k: int, device_index: int = 0) -> dict:
    """The kernel's launch for rows x k on card `device_index` (one block a
    row): blocks, threads a block, dynamic shared bytes a block, resident
    blocks a multiprocessor, and the registers and local (spill) bytes a
    thread that the compiled kernel reports."""
    out = (ctypes.c_int * len(GEOMETRY_KEYS))()
    with torch.cuda.device(device_index):
        _build.launch(_build.load('suppression').suppression_geometry, rows, k,
                      ctypes.addressof(out))
    return dict(zip(GEOMETRY_KEYS, out))
