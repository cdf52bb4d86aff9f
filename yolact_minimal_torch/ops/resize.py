"""Bilinear resize: `F.interpolate` for feature maps, plus the static 2-tap
tables that the mask kernel and its plain version read.

Two sampling conventions are used, as in the reference: align_corners=False
(FPN top-down, mask upsample) and align_corners=True (ProtoNet 2x).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


def _source_coords(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """Clamped source coordinate of every output pixel (float64)."""
    i = np.arange(out_size, dtype=np.float64)
    if align_corners:
        src = i * (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0 * i
    else:
        src = (i + 0.5) * in_size / out_size - 0.5
    return np.clip(src, 0.0, in_size - 1)


@lru_cache(maxsize=None)
def _interp_matrix(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """[out, in] float32 matrix; each row holds the two source-pixel weights."""
    w = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == 1:
        w[:, 0] = 1.0
        return w
    for i, src in enumerate(_source_coords(in_size, out_size, align_corners)):
        lo = int(np.floor(src))
        hi = min(lo + 1, in_size - 1)
        frac = src - lo
        w[i, lo] += 1.0 - frac
        w[i, hi] += frac
    return w


@lru_cache(maxsize=None)
def _gather_lerp(in_size: int, out_size: int, align_corners: bool):
    """(lo int32, hi int32, hi_frac float32) tables for a 2-tap gather."""
    src = _source_coords(in_size, out_size, align_corners)
    lo = np.floor(src).astype(np.int32)
    w = (src - lo).astype(np.float32)
    hi = np.minimum(lo + 1, in_size - 1).astype(np.int32)
    return lo, hi, w


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int,
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear-resize the two spatial axes of an NCHW tensor, computed in
    float32 and returned in its dtype (the JAX package's resize returns the
    compute dtype). The float32 input is explicit: autocast on the card
    interpolates in float32 and on the CPU in the input's dtype, and an
    exported program must see the same dtype when traced and when run."""
    if tuple(x.shape[-2:]) == (out_h, out_w):
        return x
    return F.interpolate(x.float(), size=(out_h, out_w), mode='bilinear',
                         align_corners=align_corners).to(x.dtype)


def resize_bilinear_hw_last(x: torch.Tensor, out_h: int, out_w: int,
                            align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of [..., H, W] as two interpolation-matrix products,
    rows first and then columns: the summation order of the JAX package's
    mask upsample, so the plain mask path rounds as the reference does."""
    in_h, in_w = x.shape[-2], x.shape[-1]
    if (in_h, in_w) == (out_h, out_w):
        return x
    wh = torch.from_numpy(_interp_matrix(in_h, out_h, align_corners)).to(x)
    ww = torch.from_numpy(_interp_matrix(in_w, out_w, align_corners)).to(x)
    x = torch.matmul(wh, x)
    return torch.matmul(x, ww.T)
