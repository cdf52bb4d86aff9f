"""Traditional (greedy, per-class) NMS on the host: the --traditional_nms
path.

The port's own copy of the JAX package's `ops/traditional_nms.py`: per
class, keep the anchors scoring above the threshold, pixel-scale their boxes
(the C++ kernel uses the +1 pixel area convention), run greedy suppression,
then keep the global top `max_detections` by a stable sort on -score. There
is no top_k or preselect cap on this path. The greedy loop is
`csrc/nms.cc`, built by g++ at first use (`ops/_build.py::load_host`) and
called through ctypes; importing this module builds nothing.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np

from yolact_minimal_torch.ops import _build

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load_host('nms')
    lib.greedy_nms.restype = ctypes.c_int
    lib.greedy_nms.argtypes = [_F32P, _F32P, ctypes.c_int, ctypes.c_float, _I32P]
    return lib


def greedy_nms(boxes: np.ndarray, scores: np.ndarray, iou_thresh: float) -> np.ndarray:
    """Kept indices (descending score) for pixel-scale xyxy boxes [N, 4]."""
    boxes = np.ascontiguousarray(boxes, dtype=np.float32)
    scores = np.ascontiguousarray(scores, dtype=np.float32)
    n = boxes.shape[0]
    if boxes.shape != (n, 4) or scores.shape != (n,):
        raise ValueError(f'greedy_nms takes boxes [N, 4] and scores [N], got {boxes.shape} '
                         f'and {scores.shape}')
    lib = _library()
    keep = np.empty(n, dtype=np.int32)
    count = lib.greedy_nms(boxes.ctypes.data_as(_F32P), scores.ctypes.data_as(_F32P), n,
                           float(iou_thresh), keep.ctypes.data_as(_I32P))
    return keep[:count].copy()


def traditional_nms(boxes: np.ndarray, coefs: np.ndarray, scores: np.ndarray,
                    img_size: int, score_thre: float, iou_thre: float,
                    max_detections: int
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-class greedy NMS over one image's decoded predictions: boxes [A, 4]
    normalized xyxy, coefs [A, 32], scores [C-1, A] -> (boxes, coefs,
    class ids, scores), sorted by score and capped at max_detections."""
    num_classes = scores.shape[0]
    pix_boxes = boxes * img_size

    idx_all, cls_all, scr_all = [], [], []
    for c in range(num_classes):
        cls_scores = scores[c]
        mask = cls_scores > score_thre
        if not mask.any():
            continue
        cand = np.nonzero(mask)[0]
        keep = greedy_nms(pix_boxes[cand], cls_scores[cand], iou_thre)
        idx_all.append(cand[keep])
        cls_all.append(np.full(len(keep), c, np.int32))
        scr_all.append(cls_scores[cand][keep])

    if not idx_all:
        return (np.zeros((0, 4), np.float32), np.zeros((0, coefs.shape[1]), np.float32),
                np.zeros(0, np.int32), np.zeros(0, np.float32))

    idx = np.concatenate(idx_all)
    cls = np.concatenate(cls_all)
    scr = np.concatenate(scr_all)
    order = np.argsort(-scr, kind='stable')[:max_detections]
    return boxes[idx[order]], coefs[idx[order]], cls[order], scr[order]
