"""Detection postprocessing: box decode + fast NMS + mask assembly, with
fixed shapes and batched over images.

Scores below threshold are masked to NEG_INF, per-class top-k keeps a fixed
K, suppression is the upper-triangular IoU-max (the CUDA kernel of
ops/suppression.py on the card), and the result is a static
[max_detections] slate with a validity mask.

Every top-k here is `_top_k`: a stable descending sort, so equal values keep
the lower index first, as `lax.top_k` in the JAX reference does. That order
decides which NEG_INF entries fill a short candidate list.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from yolact_minimal_torch.ops.boxes import crop, decode
from yolact_minimal_torch.ops.resize import resize_bilinear_hw_last
from yolact_minimal_torch.ops.suppression import suppression_iou_max
from yolact_minimal_torch.utils.trace import count

NEG_INF = -1e10


class Detections(NamedTuple):
    ids: torch.Tensor     # [B, D] int32 class ids (0-based, background excluded)
    scores: torch.Tensor  # [B, D] float32 class confidence
    boxes: torch.Tensor   # [B, D, 4] normalized xyxy
    coefs: torch.Tensor   # [B, D, 32] mask coefficients
    valid: torch.Tensor   # [B, D] bool slate validity


def _top_k(x: torch.Tensor, k: int):
    """Top k along the last axis, ties broken toward the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, F], idx [B, ...] -> [B, ..., F]: rows of each image."""
    b = torch.arange(x.shape[0], device=x.device).view(-1, *([1] * (idx.dim() - 1)))
    return x[b, idx]


def _suppress_and_select(planes, coefs, cls_scores, idx, top_k: int,
                         iou_thre: float, max_detections: int) -> Detections:
    """Triangular IoU-max suppression + global top-k. planes x1/y1/x2/y2 and
    cls_scores / idx are [B, C-1, K]; idx holds anchor ids into coefs
    [B, A, 32]."""
    bsz, ncls, k = cls_scores.shape
    cls_valid = cls_scores > NEG_INF / 2
    flat = [p.reshape(bsz * ncls, k).contiguous() for p in planes]
    iou_max = suppression_iou_max(*flat, cls_valid.reshape(bsz * ncls, k).contiguous())
    keep = (iou_max.view(bsz, ncls, k) <= iou_thre) & cls_valid

    flat_scores = torch.where(keep, cls_scores, NEG_INF).reshape(bsz, -1)
    top_scores, flat_idx = _top_k(flat_scores, max_detections)
    valid = top_scores > NEG_INF / 2

    class_ids = (flat_idx // top_k).to(torch.int32)
    det_boxes = torch.stack([torch.gather(p.reshape(bsz, -1), 1, flat_idx)
                             for p in planes], dim=-1)
    anchor_idx = torch.gather(idx.reshape(bsz, -1), 1, flat_idx)
    det_coefs = _gather_rows(coefs, anchor_idx)
    return Detections(class_ids, torch.where(valid, top_scores, 0.0),
                      det_boxes, det_coefs, valid)


def detect_postprocess_batch(class_pred, box_pred, coef_pred, anchors,
                             score_thre: float, iou_thre: float, top_k: int,
                             max_detections: int, pre_topk: int = 1024) -> Detections:
    """Decode + threshold + fast NMS over a batch: class_pred [B, A, C]
    (softmaxed), box_pred [B, A, 4], coef_pred [B, A, 32], anchors [A, 4].

    The threshold is on the max-over-classes score: an anchor that passes
    for any class keeps its whole per-class score column. `pre_topk` ranks
    anchors once by max-class score and restricts the per-class top_k to
    those candidates (exact while at most `pre_topk` anchors pass); <= 0
    disables it."""
    scores_all = class_pred[..., 1:]                        # [B, A, C-1]
    bsz, num_anchors, _ = scores_all.shape

    if 0 < pre_topk < num_anchors:
        max_vals, sel = _top_k(scores_all.amax(dim=-1), pre_topk)   # [B, M]
        keep = max_vals > score_thre
        scores = torch.where(keep[..., None], _gather_rows(scores_all, sel),
                             NEG_INF).transpose(1, 2)
        boxes = decode(_gather_rows(box_pred, sel), anchors[sel], clip=True)
    else:
        sel = None
        keep = scores_all.amax(dim=-1) > score_thre          # [B, A]
        scores = torch.where(keep[..., None], scores_all, NEG_INF).transpose(1, 2)
        boxes = decode(box_pred, anchors, clip=True)
    count('nms.candidates', keep)

    k = min(top_k, scores.shape[-1])
    cls_scores, idx = _top_k(scores, k)                     # [B, C-1, K]
    cls_boxes = _gather_rows(boxes, idx)                    # [B, C-1, K, 4]
    planes = cls_boxes.unbind(-1)
    anchor_idx = idx if sel is None else _gather_rows(sel[..., None], idx)[..., 0]
    return _suppress_and_select(planes, coef_pred, cls_scores, anchor_idx,
                                k, iou_thre, max_detections)


def detect_postprocess(class_pred, box_pred, coef_pred, anchors, score_thre,
                       iou_thre, top_k, max_detections,
                       pre_topk: int = 1024) -> Detections:
    """One image (no batch dim) through detect_postprocess_batch."""
    dets = detect_postprocess_batch(class_pred[None], box_pred[None],
                                    coef_pred[None], anchors, score_thre,
                                    iou_thre, top_k, max_detections, pre_topk)
    return Detections(*(x[0] for x in dets))


def assemble_masks(proto: torch.Tensor, dets: Detections,
                   do_crop: bool = True) -> torch.Tensor:
    """Lincomb masks at prototype resolution: sigmoid(proto @ coefs^T),
    cropped to the boxes and zeroed for invalid slots. proto [B, ph, pw, C]
    -> [B, ph, pw, D] float."""
    masks = torch.sigmoid(torch.matmul(proto, dets.coefs.transpose(-1, -2)[..., None, :, :]))
    if do_crop:
        masks = crop(masks, dets.boxes)
    return masks * dets.valid[..., None, None, :].to(masks.dtype)


def finalize_masks_fixed(masks_proto: torch.Tensor, out_size: int) -> torch.Tensor:
    """Upsample proto-space masks [B, ph, pw, D] to square [B, D, S, S]
    (bilinear, align_corners=False) and binarize (> 0.5)."""
    masks = masks_proto.movedim(-1, -3)                    # [B, D, ph, pw]
    masks = resize_bilinear_hw_last(masks, out_size, out_size, align_corners=False)
    return masks > 0.5
