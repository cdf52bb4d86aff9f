"""Anchors, box decode, fast NMS and mask finalize, in plain float32.

Anchors: one per (level, row, column, ratio) of the five levels at strides
8..128, centred at +0.5, normalized (cx, cy, w, h) with w = scale * sqrt(r)
and h = scale / sqrt(r) over the image size. Boxes decode with the SSD
variances (0.1, 0.2) and are clipped to [0, 1].

Fast NMS (Bolya et al., 2019) over a batch: an anchor whose best class
score (background left out) passes the threshold keeps its whole score
column; the `pre_topk` anchors with the best such scores are the
candidates; each class keeps its `top_k` best candidates; a candidate is
suppressed when its IoU with a better-scored one of its class passes the
IoU threshold; the `max_detections` best survivors over all classes make
the slate. Every ranking is a stable descending sort (ties to the lower
index).

Mask finalize: sigmoid(proto @ coef), zeroed outside the box (one proto
pixel of padding), bilinearly upsampled (align_corners=False; rows, then
columns) to the output size and thresholded at 0.5.

Both compute in their inputs' dtype: float32 for the reference, bfloat16
for the control of the program's float32 postprocess.
"""
from __future__ import annotations

import math
from itertools import product
from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference import ops

NEG_INF = -1e10
VARIANCES = (0.1, 0.2)


class Slate(NamedTuple):
    ids: torch.Tensor
    scores: torch.Tensor
    boxes: torch.Tensor
    coefs: torch.Tensor
    valid: torch.Tensor


def anchors(img_size, ratios, base_scales) -> torch.Tensor:
    out = []
    for stride, base in zip((8, 16, 32, 64, 128), base_scales):
        scale = int(img_size / 544 * base)
        size = math.ceil(img_size / stride)
        for j, i in product(range(size), range(size)):
            for r in ratios:
                s = math.sqrt(r)
                out.append(((i + 0.5) / size, (j + 0.5) / size, scale * s / img_size,
                            scale / s / img_size))
    return torch.tensor(np.array(out, np.float32))


def decode(offsets, anc):
    cxcy = anc[..., :2] + offsets[..., :2] * VARIANCES[0] * anc[..., 2:]
    wh = anc[..., 2:] * torch.exp(offsets[..., 2:] * VARIANCES[1])
    x1y1 = cxcy - wh / 2
    return torch.cat([x1y1, wh + x1y1], dim=-1).clamp(0.0, 1.0)


def box_iou(a, b):
    a, b = a[..., :, None, :], b[..., None, :, :]
    inter = (torch.minimum(a[..., 2:], b[..., 2:]) - torch.maximum(a[..., :2], b[..., :2])
             ).clamp(min=0.0)
    inter = inter[..., 0] * inter[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a + area_b - inter)


def _top_k(x, k):
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _rows(x, idx):
    b = torch.arange(x.shape[0], device=x.device).view(-1, *([1] * (idx.dim() - 1)))
    return x[b, idx]


def fast_nms(class_p, box_p, coef_p, anc, score_thre, iou_thre, top_k, max_det, pre_topk):
    """class_p [B, A, C] softmax scores, box_p [B, A, 4], coef_p [B, A, 32]."""
    scores_all = class_p[..., 1:]
    bsz, n_anchors, _ = scores_all.shape
    if 0 < pre_topk < n_anchors:
        best, sel = _top_k(scores_all.amax(dim=-1), pre_topk)
        scores = torch.where((best > score_thre)[..., None], _rows(scores_all, sel), NEG_INF)
        boxes = decode(_rows(box_p, sel), anc[sel])
    else:
        sel = None
        scores = torch.where((scores_all.amax(dim=-1) > score_thre)[..., None], scores_all,
                             NEG_INF)
        boxes = decode(box_p, anc)
    scores = scores.transpose(1, 2)                              # [B, C-1, M]
    k = min(top_k, scores.shape[-1])
    cls_scores, idx = _top_k(scores, k)                          # [B, C-1, K]
    cls_boxes = _rows(boxes, idx)                                # [B, C-1, K, 4]
    anchor_idx = idx if sel is None else _rows(sel[..., None], idx)[..., 0]
    valid = cls_scores > NEG_INF / 2
    iou = box_iou(cls_boxes, cls_boxes)
    iou = torch.where(valid[..., None, :] & valid[..., :, None], iou, 0.0)
    iou_max = torch.triu(iou, diagonal=1).amax(dim=-2)
    keep = (iou_max <= iou_thre) & valid
    flat = torch.where(keep, cls_scores, NEG_INF).reshape(bsz, -1)
    top, flat_idx = _top_k(flat, max_det)
    ok = top > NEG_INF / 2
    det_boxes = torch.gather(cls_boxes.reshape(bsz, -1, 4), 1,
                             flat_idx[..., None].expand(-1, -1, 4))
    det_anchor = torch.gather(anchor_idx.reshape(bsz, -1), 1, flat_idx)
    return Slate((flat_idx // k).to(torch.int32), torch.where(ok, top, 0.0), det_boxes,
                 _rows(coef_p, det_anchor), ok)


def _interp(n_in, n_out, align_corners, device):
    """[n_out, n_in] bilinear weights."""
    i = torch.arange(n_out, dtype=torch.float64)
    src = (i * (n_in - 1) / max(n_out - 1, 1) if align_corners
           else (i + 0.5) * n_in / n_out - 0.5).clamp(0, n_in - 1)
    lo = src.floor().long()
    hi = (lo + 1).clamp(max=n_in - 1)
    w = torch.zeros(n_out, n_in, dtype=torch.float64)
    w[torch.arange(n_out), lo] += 1 - (src - lo)
    w[torch.arange(n_out), hi] += src - lo
    return w.float().to(device)


def crop(masks, boxes, padding=1):
    """masks [..., h, w, n], boxes [..., n, 4] normalized xyxy."""
    h, w = masks.shape[-3], masks.shape[-2]

    def span(a, b, size):
        a, b = a * size, b * size
        return (torch.minimum(a, b) - padding).clamp(min=0.0), \
            (torch.maximum(a, b) + padding).clamp(max=size)
    x1, x2 = span(boxes[..., 0], boxes[..., 2], w)
    y1, y2 = span(boxes[..., 1], boxes[..., 3], h)
    cols = torch.arange(w, dtype=torch.float32, device=masks.device)[:, None]
    rows = torch.arange(h, dtype=torch.float32, device=masks.device)[:, None, None]
    x1, x2, y1, y2 = (t[..., None, None, :] for t in (x1, x2, y1, y2))
    return masks * ((cols >= x1) & (cols < x2) & (rows >= y1) & (rows < y2)).to(masks.dtype)


def mask_finalize(proto, slate: Slate, out_size: int, do_crop: bool = True):
    """proto [B, ph, pw, 32] -> bool [B, D, out, out]."""
    return mask_values(proto, slate, out_size, do_crop) > 0.5


def mask_values(proto, slate: Slate, out_size: int, do_crop: bool = True):
    """The masks before the threshold: [B, D, out, out] in proto's dtype."""
    m = torch.sigmoid(ops.matmul(proto, slate.coefs.transpose(-1, -2)[:, None]))
    if do_crop:
        m = crop(m, slate.boxes)
    m = (m * slate.valid[:, None, None, :].to(m.dtype)).movedim(-1, 1)   # [B, D, ph, pw]
    wh = _interp(m.shape[-2], out_size, False, m.device).to(m.dtype)
    ww = _interp(m.shape[-1], out_size, False, m.device).to(m.dtype)
    return torch.matmul(torch.matmul(wh, m), ww.T)
