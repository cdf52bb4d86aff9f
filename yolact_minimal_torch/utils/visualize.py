"""Detection visualization (host-side; cv2 is imported inside `draw_img`):
semantic-color mask overlay, per-class boxes and score labels, cutout export
and the realtime fps overlay."""
from __future__ import annotations

import os
import os.path as osp
from typing import Optional

import numpy as np

from yolact_minimal_torch.config import COLORS


def draw_img(ids_p, scores_p, boxes_p, masks_p, img_origin, cfg,
             img_name: Optional[str] = None, fps: Optional[float] = None,
             out_dir: str = 'results/images') -> np.ndarray:
    """Overlay masks/boxes/labels on the original image; optionally export
    cutouts. Inputs are host numpy; boxes in pixels, masks binary at image
    resolution."""
    import cv2
    if ids_p is None or len(ids_p) == 0:
        return img_origin

    ids_p = np.asarray(ids_p)
    scores_p = np.asarray(scores_p)
    boxes_p = np.asarray(boxes_p).astype(int)
    masks_p = np.asarray(masks_p).astype(np.uint8)
    num = len(ids_p)
    fused = img_origin

    if not cfg.hide_mask:
        # Color each pixel by (sum of instance ids + 1) mapped into
        # [1, len(COLORS) - 1], so overlaps get a distinct color and a
        # covered pixel never takes the background value 0.
        raw = (masks_p * (ids_p[:, None, None] + 1)).astype(int).sum(0)
        sem = np.where(raw > 0, 1 + (raw - 1) % (len(COLORS) - 1), 0)
        color_masks = COLORS[sem].astype(np.uint8)
        fused = cv2.addWeighted(color_masks, 0.4, img_origin, 0.6, gamma=0)

        if cfg.cutout and img_name is not None:
            os.makedirs(out_dir, exist_ok=True)
            total = (sem != 0)[:, :, None] * img_origin
            backdrop = ((sem == 0) * 255)[:, :, None].repeat(3, 2)
            cv2.imwrite(osp.join(out_dir, f'{img_name}_total_obj.jpg'),
                        (total + backdrop).astype(np.uint8))
            for i in range(num):
                one = masks_p[i][:, :, None] * img_origin
                back = ((masks_p[i] == 0) * 255)[:, :, None].repeat(3, 2)
                x1, y1, x2, y2 = boxes_p[i]
                cv2.imwrite(osp.join(out_dir, f'{img_name}_{i}.jpg'),
                            (one + back)[y1:y2, x1:x2].astype(np.uint8))

    font, scale, thick = cv2.FONT_HERSHEY_DUPLEX, 0.6, 1
    if not cfg.hide_bbox:
        for i in reversed(range(num)):
            x1, y1, x2, y2 = boxes_p[i]
            color = COLORS[(ids_p[i] + 1) % len(COLORS)].tolist()
            cv2.rectangle(fused, (x1, y1), (x2, y2), color, thick)
            name = cfg.class_names[ids_p[i]]
            text = name if cfg.hide_score else f'{name}: {scores_p[i]:.2f}'
            (tw, th), _ = cv2.getTextSize(text, font, scale, thick)
            cv2.rectangle(fused, (x1, y1), (x1 + tw, y1 + th + 5), color, -1)
            cv2.putText(fused, text, (x1, y1 + 15), font, scale,
                        (255, 255, 255), thick, cv2.LINE_AA)

    if cfg.real_time and fps is not None:
        text = f'fps: {fps:.2f}'
        (tw, th), _ = cv2.getTextSize(text, font, scale, thick)
        fused = fused.astype(np.float32)
        fused[0:th + 8, 0:tw + 8] *= 0.6
        fused = fused.astype(np.uint8)
        cv2.putText(fused, text, (0, th + 2), font, scale,
                    (255, 255, 255), thick, cv2.LINE_AA)
    return fused
