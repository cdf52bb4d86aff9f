"""Eval-time image preprocessing (the port's own copy of `val_aug`).

The resize is cv2.resize where cv2 imports, as in the reference. Without cv2
it is F.interpolate's bilinear on float32, cv2 INTER_LINEAR's rule
(half-pixel centres, edges clamped, no antialias), which rounds its weights
differently. cv2 is imported inside `resize_bilinear`, so importing this
module needs no cv2.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from yolact_minimal_torch.config import NORM_MEAN, NORM_STD


def pad_to_square_eval(img: np.ndarray) -> np.ndarray:
    """Top-left placement, mean padding."""
    h, w = img.shape[:2]
    if h == w:
        return img
    size = max(h, w)
    out = np.empty((size, size, 3), np.float32)
    out[:] = NORM_MEAN
    out[:h, :w] = img
    return out


def normalize_to_rgb(img: np.ndarray) -> np.ndarray:
    """(img - mean) / std, BGR -> RGB; stays HWC."""
    img = (img - NORM_MEAN) / NORM_STD
    return np.ascontiguousarray(img[:, :, ::-1])


def resize_bilinear(img: np.ndarray, size: int) -> np.ndarray:
    """float32 [H, W, C] -> [size, size, C]: cv2.resize(img, (size, size)),
    or without cv2 the same INTER_LINEAR rule through F.interpolate."""
    try:
        import cv2
    except ImportError:
        x = torch.from_numpy(np.ascontiguousarray(img, np.float32)).permute(2, 0, 1)[None]
        out = F.interpolate(x, size=(size, size), mode='bilinear', align_corners=False,
                            antialias=False)
        return out[0].permute(1, 2, 0).contiguous().numpy()
    return cv2.resize(img, (size, size))


def val_aug(img: np.ndarray, val_size: int) -> np.ndarray:
    """BGR uint8 image -> normalized RGB float32 [val_size, val_size, 3]."""
    img = pad_to_square_eval(img.astype(np.float32))
    img = resize_bilinear(img, val_size)
    return normalize_to_rgb(img)
