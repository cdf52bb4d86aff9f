"""COCO-style mAP and the detection-json writer (the port's own copy).

Greedy per-class pred -> gt matching at IoU thresholds 0.50:0.05:0.95,
per-class AP over monotone-smoothed 101-point interpolated P/R curves, and
a COCO-format results-json writer (boxes xywh rounded to 0.1, masks RLE).
Tie-breaking is the reference's: predictions in score order, the first
strictly better gt wins, each gt is used once. Host-side numpy throughout.
"""
from __future__ import annotations

import json
from collections import OrderedDict
from typing import Dict, List

import numpy as np

from yolact_minimal_torch.config import COCO_LABEL_MAP
from yolact_minimal_torch.data.coco_io import mask_to_rle
from yolact_minimal_torch.utils.progress import ascii_table

IOU_THRESHOLDS = [x / 100 for x in range(50, 100, 5)]


class APDataObject:
    """Accumulates (score, is_true) points and gt counts for one
    (iou_threshold, class) cell (reference common_utils.py:107-171)."""

    def __init__(self):
        self.data_points: List = []
        self.num_gt_positives = 0

    def push(self, score: float, is_true: bool):
        self.data_points.append((score, is_true))

    def add_gt_positives(self, n: int):
        self.num_gt_positives += n

    def is_empty(self) -> bool:
        return not self.data_points and self.num_gt_positives == 0

    def get_ap(self) -> float:
        if self.num_gt_positives == 0:
            return 0.0
        pts = sorted(self.data_points, key=lambda x: -x[0])
        flags = np.array([p[1] for p in pts], dtype=bool)
        tp = np.cumsum(flags)
        fp = np.cumsum(~flags)
        precisions = tp / (tp + fp)
        recalls = tp / self.num_gt_positives

        # monotone smoothing: precision[i] = max(precision[i:])
        precisions = np.maximum.accumulate(precisions[::-1])[::-1]

        # 101-point interpolation, nearest precision at/after each recall x
        x = np.arange(101) / 100.0
        idx = np.searchsorted(recalls, x, side='left')
        y = np.zeros(101)
        ok = idx < len(precisions)
        y[ok] = precisions[idx[ok]]
        return float(y.mean())


def make_ap_data(num_classes: int) -> Dict:
    return {t: [[APDataObject() for _ in range(num_classes)]
                for _ in IOU_THRESHOLDS] for t in ('box', 'mask')}


def prep_metrics(ap_data: Dict, ids_p, scores_p, boxes_p, masks_p,
                 gt_boxes, gt_classes, gt_masks, height, width):
    """Accumulate one image (reference prep_metrics, common_utils.py:174-216).

    Args:
      ids_p: [D] int class ids; scores_p [D]; boxes_p [D, 4] pixel xyxy;
      masks_p [D, h, w] binary; gt_boxes [G, 4] normalized xyxy;
      gt_classes [G] int; gt_masks [G, h, w] binary.
    """
    gt_boxes = np.asarray(gt_boxes, np.float32).reshape(len(gt_classes), 4) \
        * np.array([width, height, width, height], np.float32)
    gtm = np.asarray(gt_masks).reshape(
        len(gt_classes), height * width).astype(np.float32)
    pm = np.asarray(masks_p).reshape(
        len(ids_p), height * width).astype(np.float32)

    # One full-matrix BLAS gemm for mask IoU: measured faster than per-class
    # blocks (fancy-index copies + small-gemm overhead) and ~8x faster than a
    # packbits+popcount formulation at 544px.
    inter_m = pm @ gtm.T
    union_m = pm.sum(1)[:, None] + gtm.sum(1)[None, :] - inter_m
    mask_iou = np.where(union_m > 0, inter_m / np.maximum(union_m, 1e-9), 0.0)

    bp, gb = boxes_p.astype(np.float32), gt_boxes
    ix1 = np.maximum(bp[:, None, 0], gb[None, :, 0])
    iy1 = np.maximum(bp[:, None, 1], gb[None, :, 1])
    ix2 = np.minimum(bp[:, None, 2], gb[None, :, 2])
    iy2 = np.minimum(bp[:, None, 3], gb[None, :, 3])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    area_p = (bp[:, 2] - bp[:, 0]) * (bp[:, 3] - bp[:, 1])
    area_g = (gb[:, 2] - gb[:, 0]) * (gb[:, 3] - gb[:, 1])
    box_iou = inter / np.maximum(area_p[:, None] + area_g[None, :] - inter, 1e-9)

    # Greedy pred->gt matching, vectorized over the 10 IoU thresholds (and
    # the gt axis) — the reference's triple python loop (common_utils.py:
    # 185-216) was the eval bottleneck (SURVEY Hard part #6). Semantics are
    # preserved exactly: predictions in the given (score-sorted) order, the
    # first gt attaining the row maximum wins (np.argmax tie-break == the
    # reference's strict `>` scan), IoU must exceed the threshold strictly,
    # each gt is consumed once per (kind, threshold) cell.
    ids_np = np.asarray(ids_p, dtype=np.int64)
    gts_np = np.asarray(gt_classes, dtype=np.int64)
    thres = np.asarray(IOU_THRESHOLDS, dtype=np.float64)
    n_thre = len(IOU_THRESHOLDS)
    for _class in np.union1d(ids_np, gts_np):
        pred_idx = np.nonzero(ids_np == _class)[0]
        gt_cols = np.nonzero(gts_np == _class)[0]
        num_gt = len(gt_cols)
        for kind in ('box', 'mask'):
            ap_objs = [ap_data[kind][ti][_class] for ti in range(n_thre)]
            for ap_obj in ap_objs:
                ap_obj.add_gt_positives(num_gt)
            if len(pred_idx) == 0:
                continue
            used = np.zeros((n_thre, num_gt), bool)
            iou = box_iou if kind == 'box' else mask_iou
            sub = iou[np.ix_(pred_idx, gt_cols)]          # [P, Gc]
            for i, row in zip(pred_idx, sub):
                score = float(scores_p[i])
                if num_gt:
                    ok = (~used) & (row[None, :] > thres[:, None])
                    hit = ok.any(axis=1)
                    best_j = np.where(ok, row[None, :], -1.0).argmax(axis=1)
                    used[hit, best_j[hit]] = True
                else:
                    hit = np.zeros(n_thre, bool)
                for ti in range(n_thre):
                    ap_objs[ti].push(score, bool(hit[ti]))


def calc_map(ap_data: Dict, num_classes: int, step=None):
    """Aggregate to the reference's report (common_utils.py:219-255):
    returns (table_str, box_row, mask_row) with 'all' + per-threshold mAPs."""
    aps = [{'box': [], 'mask': []} for _ in IOU_THRESHOLDS]
    for c in range(num_classes):
        for ti in range(len(IOU_THRESHOLDS)):
            for kind in ('box', 'mask'):
                obj = ap_data[kind][ti][c]
                if not obj.is_empty():
                    aps[ti][kind].append(obj.get_ap())

    all_maps = {'box': OrderedDict(), 'mask': OrderedDict()}
    for kind in ('box', 'mask'):
        all_maps[kind]['all'] = 0.0
        for ti, thre in enumerate(IOU_THRESHOLDS):
            vals = aps[ti][kind]
            all_maps[kind][int(thre * 100)] = (sum(vals) / len(vals) * 100
                                               if vals else 0.0)
        vs = list(all_maps[kind].values())
        all_maps[kind]['all'] = sum(vs) / (len(vs) - 1)

    row1 = list(all_maps['box'].keys())
    row1.insert(0, f'{step // 1000}k' if step else '')
    row2 = ['box'] + [round(v, 2) for v in all_maps['box'].values()]
    row3 = ['mask'] + [round(v, 2) for v in all_maps['mask'].values()]
    return ascii_table([row1, row2, row3]), row2, row3


class MakeJson:
    """COCO-format detection-json writer (reference common_utils.py:66-104)."""

    def __init__(self, label_map=None):
        self.bbox_data: List[dict] = []
        self.mask_data: List[dict] = []
        label_map = label_map or COCO_LABEL_MAP
        self.coco_cats = {real_id - 1: coco_id
                          for coco_id, real_id in label_map.items()}

    def add_bbox(self, image_id: int, category_id: int, bbox, score: float):
        bbox = [bbox[0], bbox[1], bbox[2] - bbox[0], bbox[3] - bbox[1]]
        bbox = [round(float(x) * 10) / 10 for x in bbox]
        self.bbox_data.append({'image_id': int(image_id),
                               'category_id': self.coco_cats[int(category_id)],
                               'bbox': bbox, 'score': float(score)})

    def add_mask(self, image_id: int, category_id: int,
                 segmentation: np.ndarray, score: float):
        rle = mask_to_rle(segmentation.astype(np.uint8))
        self.mask_data.append({'image_id': int(image_id),
                               'category_id': self.coco_cats[int(category_id)],
                               'segmentation': rle, 'score': float(score)})

    def dump(self, out_dir: str = 'results'):
        import os
        os.makedirs(out_dir, exist_ok=True)
        for data, name in ((self.bbox_data, 'bbox_detections.json'),
                           (self.mask_data, 'mask_detections.json')):
            with open(f'{out_dir}/{name}', 'w') as f:
                json.dump(data, f)
