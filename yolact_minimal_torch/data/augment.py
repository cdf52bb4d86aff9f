"""Eval-time image preprocessing (the port's own copy of `val_aug`).

cv2 is imported inside `val_aug`, so importing this module needs no cv2.
"""
from __future__ import annotations

import numpy as np

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


def val_aug(img: np.ndarray, val_size: int) -> np.ndarray:
    """BGR uint8 image -> normalized RGB float32 [val_size, val_size, 3]."""
    import cv2
    img = pad_to_square_eval(img.astype(np.float32))
    img = cv2.resize(img, (val_size, val_size))
    return normalize_to_rgb(img)
