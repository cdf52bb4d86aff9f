"""COCO-style dataset, val and detect modes (the port's own copy).

Val items carry the image resized and normalized by `val_aug` and the gt at
the original scale: boxes normalized xyxy, binary masks, class indices.
Images are read through `utils/image_io.py` (cv2, else PIL), polygons are
rasterized by cv2 (`data/coco_io.py`). The train mode (augmentation, the
padded fixed-shape batches) is not ported yet.
"""
from __future__ import annotations

import glob
import os.path as osp
from typing import Optional, Tuple

import numpy as np

from yolact_minimal_torch.config import Config
from yolact_minimal_torch.data.augment import val_aug
from yolact_minimal_torch.data.coco_io import COCO
from yolact_minimal_torch.utils import image_io


class COCODetection:
    """Modes: val (resized image + original-scale gt, what `eval.py` reads),
    detect (a folder of images, what `detect.py` reads)."""

    def __init__(self, cfg: Config, mode: str = 'val'):
        if mode not in ('val', 'detect'):
            raise ValueError(f'COCODetection mode {mode!r}: the port has val and detect')
        self.cfg = cfg
        self.mode = mode
        if mode == 'val':
            self.image_path = cfg.val_imgs
            self.coco = COCO(cfg.val_ann)
            self.ids = list(self.coco.imgToAnns.keys())
        else:
            self.image_path = sorted(glob.glob(osp.join(cfg.image, '*.jpg')) +
                                     glob.glob(osp.join(cfg.image, '*.png')))
        self.continuous_id = cfg.continuous_id

    def __len__(self):
        if self.mode == 'val':
            n = len(self.ids)
            return n if self.cfg.val_num == -1 else min(self.cfg.val_num, n)
        return len(self.image_path)

    def _load_annotated(self, index: int) -> Tuple[np.ndarray, Optional[np.ndarray],
                                                   Optional[np.ndarray], Optional[np.ndarray],
                                                   int, int]:
        img_id = self.ids[index]
        anns = self.coco.loadAnns(self.coco.getAnnIds(imgIds=img_id))
        anns = [a for a in anns if not a['iscrowd']]
        file_name = self.coco.loadImgs(img_id)[0]['file_name']
        img = image_io.imread(osp.join(self.image_path, file_name))
        h, w = img.shape[:2]

        boxes, masks, labels = [], [], []
        for a in anns:
            x, y, bw, bh = a['bbox']
            boxes.append([x, y, x + bw, y + bh])
            masks.append(self.coco.annToMask(a))
            labels.append(self.continuous_id[a['category_id']] - 1)
        if not boxes:
            return img, None, None, None, h, w
        return (img, np.array(boxes, np.float32), np.stack(masks, 0),
                np.array(labels, np.int32), h, w)

    def get_val(self, index: int) -> dict:
        """Raises RuntimeError for an image with no non-crowd annotation."""
        img, boxes, masks, labels, h, w = self._load_annotated(index)
        if boxes is None:
            raise RuntimeError('No valid object in this image.')
        normed = val_aug(img, self.cfg.img_size)
        boxes = boxes / np.array([w, h, w, h], np.float32)
        return dict(image=normed, boxes=boxes, labels=labels, masks=masks,
                    height=h, width=w, image_id=self.ids[index])

    def get_detect(self, index: int) -> dict:
        name = self.image_path[index]
        img = image_io.imread(name)
        return dict(image=val_aug(img, self.cfg.img_size), origin=img,
                    name=osp.basename(name))
