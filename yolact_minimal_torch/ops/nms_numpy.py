"""The detection postprocess in numpy: decode, fast NMS and mask assembly
of one image's raw outputs, with no torch.

The host tail of the exported-artifact driver (`detect_with_export.py`): the
artifact gives the raw per-anchor outputs and this module finishes the
detection, as the reference's ONNX and TensorRT drivers do with their numpy
postprocess. Its arithmetic is the JAX package's `ops/nms_numpy.py`. cv2
resizes the masks; it is imported at first use, so importing this module
needs no cv2.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from yolact_minimal_torch.ops.boxes import box_iou_numpy, crop_numpy, decode_numpy


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def fast_nms_numpy(boxes, coefs, scores, top_k: int, iou_thre: float,
                   max_detections: int):
    """Per-class top-k sort + triangular IoU-max suppression + global cap.
    boxes [N, 4], coefs [N, 32], scores [C-1, N] (already score-filtered)."""
    order = np.argsort(-scores, axis=1, kind='stable')[:, :top_k]
    cls_scores = np.take_along_axis(scores, order, axis=1)
    num_classes, k = order.shape
    cls_boxes = boxes[order.reshape(-1)].reshape(num_classes, k, 4)
    cls_coefs = coefs[order.reshape(-1)].reshape(num_classes, k, -1)

    iou = np.triu(box_iou_numpy(cls_boxes, cls_boxes), k=1)
    keep = iou.max(axis=1) <= iou_thre

    ids = np.tile(np.arange(num_classes)[:, None], (1, k))[keep]
    boxes_k, coefs_k, scores_k = cls_boxes[keep], cls_coefs[keep], cls_scores[keep]
    final = np.argsort(-scores_k, kind='stable')[:max_detections]
    return boxes_k[final], coefs_k[final], ids[final], scores_k[final]


def detect_postprocess_numpy(class_pred, box_pred, coef_pred, anchors,
                             score_thre: float, iou_thre: float, top_k: int,
                             max_detections: int):
    """One image's raw outputs (no batch dim): class_pred [A, C] softmaxed,
    box_pred [A, 4], coef_pred [A, 32] -> (boxes, coefs, ids, scores) sorted
    by score, or four Nones when no anchor passes `score_thre`."""
    scores = class_pred[:, 1:].T                       # drop background
    keep = scores.max(axis=0) > score_thre
    if not keep.any():
        return None, None, None, None
    boxes = decode_numpy(box_pred[keep], anchors[keep], clip=True)
    return fast_nms_numpy(boxes, coef_pred[keep], scores[:, keep],
                          top_k, iou_thre, max_detections)


def after_nms_numpy(ids, scores, boxes, coefs, proto, img_h: int, img_w: int,
                    visual_thre: Optional[float] = None, do_crop: bool = True
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Masks of the kept detections: sigmoid(proto @ coefs^T), cropped to
    the boxes, upsampled bilinearly by cv2 to the padded square, binarized at
    0.5 and cut to the image -> (ids int32, scores float32, pixel boxes
    int32, bool masks [K, img_h, img_w])."""
    if ids is None or len(ids) == 0:
        return (np.zeros(0, np.int32), np.zeros(0, np.float32),
                np.zeros((0, 4), np.int32), np.zeros((0, img_h, img_w), bool))
    if visual_thre is not None:
        keep = scores >= visual_thre
        if not keep.any():
            return (np.zeros(0, np.int32), np.zeros(0, np.float32),
                    np.zeros((0, 4), np.int32),
                    np.zeros((0, img_h, img_w), bool))
        ids, scores, boxes, coefs = ids[keep], scores[keep], boxes[keep], coefs[keep]

    import cv2
    masks = _sigmoid(proto @ coefs.T)                 # [ph, pw, D]
    if do_crop:
        masks = crop_numpy(masks, boxes)

    ori = max(img_h, img_w)
    up = cv2.resize(masks, (ori, ori), interpolation=cv2.INTER_LINEAR)
    if up.ndim == 2:
        up = up[:, :, None]
    up = np.transpose(up, (2, 0, 1)) > 0.5
    up = up[:, :img_h, :] if img_h < img_w else up[:, :, :img_w]

    boxes_pix = (boxes * ori).astype(np.int32)
    return ids.astype(np.int32), scores.astype(np.float32), boxes_pix, up
