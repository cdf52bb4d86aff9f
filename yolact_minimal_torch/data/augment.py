"""Image preprocessing: the port's own copy of `val_aug` and of the training
augmentation `train_aug`.

Eval: the resize is cv2.resize where cv2 imports, as in the reference.
Without cv2 it is F.interpolate's bilinear on float32, cv2 INTER_LINEAR's
rule (half-pixel centres, edges clamped, no antialias), which rounds its
weights differently.

Training: photometric distortion (brightness, contrast, HSV saturation and
hue), random mirror, random crop with a bounded retry loop, pad to square
at a random place, resize to a random multiple of 32 in [256, 768], fit to
the train size, box clipping and small-box removal, normalization with
BGR -> RGB. Every function draws from the `random.Random` it is given, in
the JAX package's order, so one seed gives the JAX package's bytes. It
needs cv2 (colour conversion and resizes, as the reference) and says so
when cv2 is missing. A failed augmentation returns None.

cv2 is imported inside the functions, so importing this module needs no
cv2.
"""
from __future__ import annotations

import random
from typing import Optional, Tuple

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


# --- training ------------------------------------------------------------------

NO_CV2_TRAIN = ('training needs cv2: the augmentation converts colours and '
                'resizes images and masks with cv2, as the reference does')


def import_cv2(needs: str = NO_CV2_TRAIN):
    """cv2, or an ImportError that says what needs it (training unless
    `needs` says otherwise)."""
    try:
        import cv2
    except ImportError:
        raise ImportError(needs) from None
    return cv2


def photometric_distort(img: np.ndarray, rnd: random.Random) -> np.ndarray:
    """Brightness/contrast jitter, then HSV saturation/hue jitter."""
    cv2 = import_cv2()
    if rnd.randint(0, 1):
        img = np.clip(img + rnd.uniform(-32, 32), 0.0, 255.0)
    if rnd.randint(0, 1):
        img = np.clip(img * rnd.uniform(0.7, 1.3), 0.0, 255.0)

    hsv = cv2.cvtColor(img, cv2.COLOR_BGR2HSV)
    hsv[:, :, 1] *= rnd.uniform(0.7, 1.3)
    hue = hsv[:, :, 0] + rnd.uniform(-15.0, 15.0)
    hue = np.where(hue > 360.0, hue - 360.0, hue)
    hue = np.where(hue < 0.0, hue + 360.0, hue)
    hsv[:, :, 0] = hue
    img = cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)
    return np.clip(img, 0.0, 255.0)


def random_mirror(img, masks, boxes, rnd: random.Random):
    if rnd.randint(0, 1):
        width = img.shape[1]
        img = img[:, ::-1]
        masks = masks[:, :, ::-1]
        x1 = width - boxes[:, 2]
        x2 = width - boxes[:, 0]
        boxes = boxes.copy()
        boxes[:, 0], boxes[:, 2] = x1, x2
    return img, masks, boxes


def _crop_once(img, masks, boxes, labels, crop_h, crop_w, rnd,
               keep_ratio=0.3, max_tries=1000):
    """Random crop keeping the boxes that retain > keep_ratio of their area;
    None after max_tries."""
    ori_h, ori_w = img.shape[:2]
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    for _ in range(max_tries):
        x0 = rnd.randint(0, ori_w - crop_w)
        y0 = rnd.randint(0, ori_h - crop_h)
        ix1 = np.maximum(boxes[:, 0], x0)
        iy1 = np.maximum(boxes[:, 1], y0)
        ix2 = np.minimum(boxes[:, 2], x0 + crop_w)
        iy2 = np.minimum(boxes[:, 3], y0 + crop_h)
        inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
        keep = (inter / areas) > keep_ratio
        if keep.any():
            new_boxes = np.stack([ix1, iy1, ix2, iy2], axis=1)[keep]
            new_boxes[:, [0, 2]] -= x0
            new_boxes[:, [1, 3]] -= y0
            return (img[y0:y0 + crop_h, x0:x0 + crop_w],
                    masks[keep][:, y0:y0 + crop_h, x0:x0 + crop_w],
                    new_boxes.astype(np.float32), labels[keep])
    return None


def random_crop(img, masks, boxes, labels, rnd: random.Random, crop_ratio=(0.6, 1.0)):
    if rnd.randint(0, 1):
        return img, masks, boxes, labels
    ori_h, ori_w = img.shape[:2]
    crop_h = int(rnd.uniform(*crop_ratio) * ori_h)
    crop_w = int(rnd.uniform(*crop_ratio) * ori_w)
    return _crop_once(img, masks, boxes, labels, crop_h, crop_w, rnd) or (None,) * 4


def pad_to_square_train(img, masks, boxes, rnd: random.Random):
    """Mean padding at a random place along the short side."""
    h, w = img.shape[:2]
    if h == w:
        return img, masks, boxes
    size = max(h, w)
    out = np.empty((size, size, 3), np.float32)
    out[:] = NORM_MEAN
    pad_masks = np.zeros((masks.shape[0], size, size), np.float32)
    boxes = boxes.copy()
    if h < w:
        y0 = rnd.randint(0, w - h)
        out[y0:y0 + h] = img
        pad_masks[:, y0:y0 + h] = masks
        boxes[:, [1, 3]] += y0
    else:
        x0 = rnd.randint(0, h - w)
        out[:, x0:x0 + w] = img
        pad_masks[:, :, x0:x0 + w] = masks
        boxes[:, [0, 2]] += x0
    return out, pad_masks, boxes


def multi_scale_resize(img, masks, boxes, rnd: random.Random, resize_range=(8, 24)):
    """Resize the square image and its masks to a random multiple of 32."""
    cv2 = import_cv2()
    ori = img.shape[0]
    new = rnd.randint(*resize_range) * 32
    img = cv2.resize(img, (new, new))
    boxes = boxes * (new / ori)
    m = cv2.resize(masks.transpose(1, 2, 0), (new, new))
    masks = m[:, :, None].transpose(2, 0, 1) if m.ndim == 2 else m.transpose(2, 0, 1)
    return img, masks, boxes


def fit_to_size(img, masks, boxes, labels, train_size, rnd: random.Random):
    """Pad (at a random place) or crop the square image to train_size."""
    size = img.shape[0]
    if size == train_size:
        return img, masks, boxes, labels
    if size < train_size:
        out = np.empty((train_size, train_size, 3), np.float32)
        out[:] = NORM_MEAN
        pad_masks = np.zeros((masks.shape[0], train_size, train_size), np.float32)
        y0 = rnd.randint(0, train_size - size)
        x0 = rnd.randint(0, train_size - size)
        out[y0:y0 + size, x0:x0 + size] = img
        pad_masks[:, y0:y0 + size, x0:x0 + size] = masks
        boxes = boxes.copy()
        boxes[:, [1, 3]] += y0
        boxes[:, [0, 2]] += x0
        return out, pad_masks, boxes, labels
    return _crop_once(img, masks, boxes, labels, train_size, train_size, rnd) \
        or (None,) * 4


def train_aug(img, masks, boxes, labels, train_size: int,
              rnd: random.Random) -> Optional[Tuple]:
    """BGR image, masks [N, H, W], boxes [N, 4] in pixels, labels [N] ->
    (normalized RGB image [S, S, 3], masks [N, S, S], boxes [N, 4] in 0..1,
    labels [N]), or None."""
    img = img.astype(np.float32)
    img = photometric_distort(img, rnd)
    img, masks, boxes = random_mirror(img, masks, boxes.astype(np.float32), rnd)
    img, masks, boxes, labels = random_crop(img, masks, boxes, labels, rnd)
    if img is None:
        return None
    img, masks, boxes = pad_to_square_train(img, masks, boxes, rnd)
    img, masks, boxes = multi_scale_resize(img, masks, boxes, rnd)
    img, masks, boxes, labels = fit_to_size(img, masks, boxes, labels, train_size, rnd)
    if img is None:
        return None

    h, w = img.shape[:2]
    boxes[:, [0, 2]] = np.clip(boxes[:, [0, 2]], 0, w - 1)
    boxes[:, [1, 3]] = np.clip(boxes[:, [1, 3]], 0, h - 1)
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    keep = areas > 20
    boxes, masks, labels = boxes[keep], masks[keep], labels[keep]
    if boxes.shape[0] == 0:
        return None

    boxes[:, [0, 2]] /= w
    boxes[:, [1, 3]] /= h
    return normalize_to_rgb(img), masks, boxes, labels
