"""Core box geometry on torch tensors.

Same conventions as the reference geometry layer: SSD variances 0.1/0.2,
+0.5 anchor centering, IoU without the +1 area term. Every function takes
leading batch dimensions and keeps fixed shapes.
"""
from __future__ import annotations

import math
from itertools import product

import numpy as np
import torch

# SSD-style box-encoding variances.
VARIANCES = (0.1, 0.2)


def box_iou(box_a: torch.Tensor, box_b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes: [..., A, 4] x [..., B, 4] -> [..., A, B]."""
    a = box_a[..., :, None, :]
    b = box_b[..., None, :, :]
    max_xy = torch.minimum(a[..., 2:], b[..., 2:])
    min_xy = torch.maximum(a[..., :2], b[..., :2])
    inter = (max_xy - min_xy).clamp(min=0.0)
    inter_area = inter[..., 0] * inter[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter_area / (area_a + area_b - inter_area)


def make_anchors(img_size: int, aspect_ratios, scales) -> np.ndarray:
    """Dense grid anchors over the 5 FPN levels (strides 8..128), float32
    [num_anchors, 4] in normalized (cx, cy, w, h). Feature sizes are
    ceil(img_size / stride); rows (j) then cols (i), ratios innermost."""
    out = []
    for stride, scale in zip((8, 16, 32, 64, 128), scales):
        size = math.ceil(img_size / stride)
        for j, i in product(range(size), range(size)):
            x = (i + 0.5) / size
            y = (j + 0.5) / size
            for ar in aspect_ratios:
                r = math.sqrt(ar)
                out.append((x, y, scale * r / img_size, scale / r / img_size))
    return np.array(out, dtype=np.float32)


def encode(matched: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Matched gt boxes (normalized xyxy) against cxcywh anchors -> SSD
    offsets [..., 4]; widths and heights clamped at 1e-12 before the log."""
    g_cxcy = (matched[..., :2] + matched[..., 2:]) / 2 - anchors[..., :2]
    g_cxcy = g_cxcy / (VARIANCES[0] * anchors[..., 2:])
    g_wh = (matched[..., 2:] - matched[..., :2]) / anchors[..., 2:]
    g_wh = torch.log(g_wh.clamp(min=1e-12)) / VARIANCES[1]
    return torch.cat([g_cxcy, g_wh], dim=-1)


def decode(offsets: torch.Tensor, anchors: torch.Tensor, clip: bool = True) -> torch.Tensor:
    """SSD offsets [..., 4] against cxcywh anchors -> normalized xyxy boxes,
    clipped to [0, 1] when `clip`."""
    cxcy = anchors[..., :2] + offsets[..., :2] * VARIANCES[0] * anchors[..., 2:]
    wh = anchors[..., 2:] * torch.exp(offsets[..., 2:] * VARIANCES[1])
    x1y1 = cxcy - wh / 2
    x2y2 = wh + x1y1
    boxes = torch.cat([x1y1, x2y2], dim=-1)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    return boxes


def sanitize_coordinates(x1, x2, img_size, padding: int = 0):
    """Scale normalized coords to pixels, order them, clamp to the image."""
    x1 = x1 * img_size
    x2 = x2 * img_size
    lo = torch.minimum(x1, x2)
    hi = torch.maximum(x1, x2)
    lo = (lo - padding).clamp(min=0.0)
    hi = (hi + padding).clamp(max=img_size)
    return lo, hi


def crop(masks: torch.Tensor, boxes: torch.Tensor, padding: int = 1) -> torch.Tensor:
    """Zero mask pixels outside each box. masks [..., h, w, n]; boxes
    [..., n, 4] normalized xyxy."""
    h, w = masks.shape[-3], masks.shape[-2]
    x1, x2 = sanitize_coordinates(boxes[..., 0], boxes[..., 2], w, padding)
    y1, y2 = sanitize_coordinates(boxes[..., 1], boxes[..., 3], h, padding)
    cols = torch.arange(w, dtype=torch.float32, device=masks.device)[:, None]
    rows = torch.arange(h, dtype=torch.float32, device=masks.device)[:, None, None]
    x1, x2, y1, y2 = (t[..., None, None, :] for t in (x1, x2, y1, y2))
    keep = (cols >= x1) & (cols < x2) & (rows >= y1) & (rows < y2)
    return masks * keep.to(masks.dtype)


# Numpy counterparts, for the exported-artifact driver's host tail
# (ops/nms_numpy.py): the same arithmetic on numpy arrays, no torch.

def box_iou_numpy(box_a: np.ndarray, box_b: np.ndarray) -> np.ndarray:
    """box_iou on numpy arrays: [..., A, 4] x [..., B, 4] -> [..., A, B]."""
    a = box_a[..., :, None, :]
    b = box_b[..., None, :, :]
    max_xy = np.minimum(a[..., 2:], b[..., 2:])
    min_xy = np.maximum(a[..., :2], b[..., :2])
    inter = np.clip(max_xy - min_xy, 0.0, None)
    inter_area = inter[..., 0] * inter[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter_area / (area_a + area_b - inter_area)


def sanitize_coordinates_numpy(x1, x2, img_size, padding: int = 0):
    """sanitize_coordinates on numpy arrays."""
    x1 = x1 * img_size
    x2 = x2 * img_size
    lo = np.minimum(x1, x2)
    hi = np.maximum(x1, x2)
    lo = np.clip(lo - padding, 0.0, None)
    hi = np.minimum(hi + padding, img_size)
    return lo, hi


def crop_numpy(masks: np.ndarray, boxes: np.ndarray, padding: int = 1) -> np.ndarray:
    """crop of one image's masks [h, w, n] by its boxes [n, 4]."""
    h, w, _ = masks.shape
    x1, x2 = sanitize_coordinates_numpy(boxes[:, 0], boxes[:, 2], w, padding)
    y1, y2 = sanitize_coordinates_numpy(boxes[:, 1], boxes[:, 3], h, padding)
    rows = np.arange(w, dtype=np.float32)[None, :, None]
    cols = np.arange(h, dtype=np.float32)[:, None, None]
    keep = ((rows >= x1[None, None, :]) & (rows < x2[None, None, :]) &
            (cols >= y1[None, None, :]) & (cols < y2[None, None, :]))
    return masks * keep.astype(masks.dtype)


def decode_numpy(offsets: np.ndarray, anchors: np.ndarray, clip: bool = True) -> np.ndarray:
    """decode on numpy arrays."""
    cxcy = anchors[..., :2] + offsets[..., :2] * VARIANCES[0] * anchors[..., 2:]
    wh = anchors[..., 2:] * np.exp(offsets[..., 2:] * VARIANCES[1])
    x1y1 = cxcy - wh / 2
    x2y2 = wh + x1y1
    boxes = np.concatenate([x1y1, x2y2], axis=-1)
    if clip:
        boxes = np.clip(boxes, 0.0, 1.0)
    return boxes
