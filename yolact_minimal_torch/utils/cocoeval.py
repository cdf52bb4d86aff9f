"""The COCO evaluation protocol, bbox and segm (the port's own copy; no
pycocotools).

Greedy score-ordered matching per (image, category) at IoU thresholds
0.50:0.05:0.95 with crowd regions as ignore, 101-point interpolated AP,
area-range breakdowns and the 12-number summary, over the detection jsons
that `utils/map_eval.MakeJson` writes: the eval CLI's `--coco_api`.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from yolact_minimal_torch.data.coco_io import COCO, mask_to_rle, rle_to_mask

IOU_THRS = np.round(np.arange(0.5, 1.0, 0.05), 2)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    'all': (0.0, 1e10),
    'small': (0.0, 32.0 ** 2),
    'medium': (32.0 ** 2, 96.0 ** 2),
    'large': (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _bbox_iou(det_boxes: np.ndarray, gt_boxes: np.ndarray,
              gt_crowd: np.ndarray) -> np.ndarray:
    """IoU for xywh boxes; against crowd gts the union is the det area
    (intersection-over-detection, the COCO ignore-region convention)."""
    d = det_boxes.astype(np.float64)
    g = gt_boxes.astype(np.float64)
    ix1 = np.maximum(d[:, None, 0], g[None, :, 0])
    iy1 = np.maximum(d[:, None, 1], g[None, :, 1])
    ix2 = np.minimum(d[:, None, 0] + d[:, None, 2], g[None, :, 0] + g[None, :, 2])
    iy2 = np.minimum(d[:, None, 1] + d[:, None, 3], g[None, :, 1] + g[None, :, 3])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    area_d = d[:, 2] * d[:, 3]
    area_g = g[:, 2] * g[:, 3]
    union = area_d[:, None] + area_g[None, :] - inter
    union = np.where(gt_crowd[None, :], area_d[:, None], union)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _segm_iou(det_rles: Sequence[dict], gt_rles: Sequence[dict],
              gt_crowd: np.ndarray) -> np.ndarray:
    dm = np.stack([rle_to_mask(r).reshape(-1) for r in det_rles]).astype(np.float64)
    gm = np.stack([rle_to_mask(r).reshape(-1) for r in gt_rles]).astype(np.float64)
    inter = dm @ gm.T
    area_d = dm.sum(1)
    area_g = gm.sum(1)
    union = area_d[:, None] + area_g[None, :] - inter
    union = np.where(gt_crowd[None, :], area_d[:, None], union)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


class COCOEvaluator:
    """evaluate() + accumulate() + summarize() over one iou_type."""

    def __init__(self, gt: COCO, detections: List[dict], iou_type: str = 'bbox'):
        assert iou_type in ('bbox', 'segm')
        self.gt = gt
        self.iou_type = iou_type
        self.cat_ids = sorted(gt.cats) if gt.cats else sorted(
            {a['category_id'] for a in gt.anns.values()})
        self.img_ids = sorted(gt.imgs)
        self.dets = defaultdict(list)
        for d in detections:
            self.dets[(d['image_id'], d['category_id'])].append(d)
        self._eval_imgs: Dict = {}
        self.stats: Optional[np.ndarray] = None

    # -- per-(image, category) matching -------------------------------------
    def _evaluate_img(self, img_id: int, cat_id: int):
        gts = [a for a in self.gt.imgToAnns.get(img_id, [])
               if a['category_id'] == cat_id]
        dts = sorted(self.dets.get((img_id, cat_id), []),
                     key=lambda d: -d['score'])[:MAX_DETS[-1]]
        if not gts and not dts:
            return None

        gt_crowd = np.array([bool(g.get('iscrowd', 0)) for g in gts], bool)
        gt_area = np.array([g.get('area', g['bbox'][2] * g['bbox'][3])
                            for g in gts], np.float64)
        # crowd/ignored gts matched last: stable-sort by crowd flag
        order = np.argsort(gt_crowd, kind='stable')
        gts = [gts[i] for i in order]
        gt_crowd = gt_crowd[order]
        gt_area = gt_area[order]

        if gts and dts:
            if self.iou_type == 'bbox':
                iou = _bbox_iou(np.array([d['bbox'] for d in dts]),
                                np.array([g['bbox'] for g in gts]), gt_crowd)
            else:
                iou = _segm_iou([d['segmentation'] for d in dts],
                                [self._gt_rle(g) for g in gts], gt_crowd)
        else:
            iou = np.zeros((len(dts), len(gts)))

        T, D, G = len(IOU_THRS), len(dts), len(gts)
        dt_match = np.zeros((T, D), np.int64)        # matched gt index + 1
        dt_ignore = np.zeros((T, D), bool)
        gt_match = np.zeros((T, G), np.int64)
        for ti, thr in enumerate(IOU_THRS):
            for di in range(D):
                best, best_gi = min(thr, 1 - 1e-10), -1
                for gi in range(G):
                    if gt_match[ti, gi] and not gt_crowd[gi]:
                        continue
                    # stop crossing into crowd gts once matched to a real one
                    if best_gi >= 0 and not gt_crowd[best_gi] and gt_crowd[gi]:
                        break
                    if iou[di, gi] < best:
                        continue
                    best, best_gi = iou[di, gi], gi
                if best_gi >= 0:
                    dt_match[ti, di] = best_gi + 1
                    dt_ignore[ti, di] = gt_crowd[best_gi]
                    gt_match[ti, best_gi] = di + 1
        if self.iou_type == 'bbox':
            dt_area = np.array([d['bbox'][2] * d['bbox'][3] for d in dts])
        else:
            dt_area = np.array([rle_to_mask(d['segmentation']).sum()
                                for d in dts], np.float64)
        return dict(scores=np.array([d['score'] for d in dts]),
                    dt_match=dt_match, dt_ignore=dt_ignore,
                    dt_area=dt_area, gt_crowd=gt_crowd, gt_area=gt_area)

    def _gt_rle(self, g) -> dict:
        seg = g['segmentation']
        if isinstance(seg, dict):
            return seg
        # polygons: rasterize through the annotation index
        return mask_to_rle(self.gt.annToMask(g))

    # -- accumulation ---------------------------------------------------------
    def evaluate(self):
        for img_id in self.img_ids:
            for cat_id in self.cat_ids:
                r = self._evaluate_img(img_id, cat_id)
                if r is not None:
                    self._eval_imgs[(img_id, cat_id)] = r

    def accumulate(self):
        T, R = len(IOU_THRS), len(RECALL_THRS)
        K, A, M = len(self.cat_ids), len(AREA_RANGES), len(MAX_DETS)
        self.precision = -np.ones((T, R, K, A, M))
        self.recall = -np.ones((T, K, A, M))

        for ki, cat_id in enumerate(self.cat_ids):
            results = [self._eval_imgs[(i, cat_id)] for i in self.img_ids
                       if (i, cat_id) in self._eval_imgs]
            if not results:
                continue
            for ai, (lo, hi) in enumerate(AREA_RANGES.values()):
                for mi, max_det in enumerate(MAX_DETS):
                    scores, matches, ignores = [], [], []
                    n_gt = 0
                    for r in results:
                        gt_ig = r['gt_crowd'] | (r['gt_area'] < lo) | (r['gt_area'] > hi)
                        n_gt += int((~gt_ig).sum())
                        sel = slice(0, max_det)
                        s = r['scores'][sel]
                        m = r['dt_match'][:, sel]
                        # a det is ignored if matched to an ignored gt, or
                        # unmatched but outside the area range
                        matched_ig = np.zeros_like(m, bool)
                        for ti in range(T):
                            for di in range(m.shape[1]):
                                gi = m[ti, di] - 1
                                if gi >= 0:
                                    matched_ig[ti, di] = bool(gt_ig[gi])
                        out_of_range = ((r['dt_area'][sel] < lo) |
                                        (r['dt_area'][sel] > hi))
                        unmatched = m == 0
                        ig = matched_ig | (unmatched & out_of_range[None, :])
                        scores.append(s)
                        matches.append(m)
                        ignores.append(ig)
                    if n_gt == 0:
                        continue
                    scores = np.concatenate(scores)
                    matches = np.concatenate(matches, axis=1)
                    ignores = np.concatenate(ignores, axis=1)
                    order = np.argsort(-scores, kind='mergesort')
                    matches = matches[:, order]
                    ignores = ignores[:, order]

                    tps = (matches > 0) & ~ignores
                    fps = (matches == 0) & ~ignores
                    tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                    for ti in range(T):
                        tp, fp = tp_sum[ti], fp_sum[ti]
                        rc = tp / n_gt
                        pr = tp / np.maximum(tp + fp, 1e-12)
                        self.recall[ti, ki, ai, mi] = rc[-1] if len(rc) else 0
                        # monotone precision envelope
                        for i in range(len(pr) - 1, 0, -1):
                            pr[i - 1] = max(pr[i - 1], pr[i])
                        idx = np.searchsorted(rc, RECALL_THRS, side='left')
                        q = np.zeros(R)
                        ok = idx < len(pr)
                        q[ok] = pr[idx[ok]]
                        self.precision[ti, :, ki, ai, mi] = q

    def _summary(self, ap: bool, iou: Optional[float] = None,
                 area: str = 'all', max_det: int = 100) -> float:
        ai = list(AREA_RANGES).index(area)
        mi = MAX_DETS.index(max_det)
        if ap:
            s = self.precision[:, :, :, ai, mi]
            if iou is not None:
                s = s[[int(np.argwhere(np.isclose(IOU_THRS, iou))[0][0])]]
        else:
            s = self.recall[:, :, ai, mi]
            if iou is not None:
                s = s[[int(np.argwhere(np.isclose(IOU_THRS, iou))[0][0])]]
        s = s[s > -1]
        return float(s.mean()) if s.size else -1.0

    def summarize(self, quiet: bool = False) -> np.ndarray:
        spec = [
            (1, None, 'all', 100), (1, 0.5, 'all', 100), (1, 0.75, 'all', 100),
            (1, None, 'small', 100), (1, None, 'medium', 100), (1, None, 'large', 100),
            (0, None, 'all', 1), (0, None, 'all', 10), (0, None, 'all', 100),
            (0, None, 'small', 100), (0, None, 'medium', 100), (0, None, 'large', 100),
        ]
        self.stats = np.array([self._summary(bool(a), i, ar, m)
                               for a, i, ar, m in spec])
        if not quiet:
            names = ['AP', 'AP50', 'AP75', 'APs', 'APm', 'APl',
                     'AR1', 'AR10', 'AR100', 'ARs', 'ARm', 'ARl']
            kind = 'bbox' if self.iou_type == 'bbox' else 'segm'
            for n, v in zip(names, self.stats):
                print(f' {kind} {n:>5}: {v:.3f}')
        return self.stats


def evaluate_detections(gt_ann_file: str, bbox_json: str, mask_json: str):
    """Run the full COCO-protocol summary on dumped detection jsons
    (the reference's eval.py:86-104 flow)."""
    import json
    gt = COCO(gt_ann_file)
    with open(bbox_json) as f:
        bbox_dets = json.load(f)
    with open(mask_json) as f:
        mask_dets = json.load(f)

    print('\nEvaluating BBoxes:')
    be = COCOEvaluator(gt, bbox_dets, 'bbox')
    be.evaluate(); be.accumulate(); be.summarize()

    print('\nEvaluating Masks:')
    me = COCOEvaluator(gt, mask_dets, 'segm')
    me.evaluate(); me.accumulate(); me.summarize()
    return be.stats, me.stats
