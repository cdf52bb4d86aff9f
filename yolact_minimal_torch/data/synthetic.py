"""Synthetic COCO-format dataset generator.

The port's own copy of the JAX package's `data/synthetic.py`: simple
colored shapes (ellipses, rectangles, triangles) on noisy backgrounds, and a
matching COCO-style annotation json with polygon segmentations. With 48
images at 448 and seed 0 it writes the repository's custom_dataset/ byte
for byte. cv2 draws, traces and writes; it is imported by the functions
that use it.
"""
from __future__ import annotations

import json
import os
import os.path as osp
from typing import List, Tuple

import numpy as np


def _mask_to_polygon(mask: np.ndarray) -> List[List[float]]:
    """The outer contours of a binary mask with at least 3 points, each as
    a flat [x0, y0, x1, y1, ...] list."""
    import cv2

    contours, _ = cv2.findContours(mask.astype(np.uint8), cv2.RETR_EXTERNAL,
                                   cv2.CHAIN_APPROX_SIMPLE)
    polys = []
    for c in contours:
        c = c.reshape(-1, 2)
        if len(c) >= 3:
            polys.append(c.reshape(-1).astype(float).tolist())
    return polys


def generate_dataset(root: str, num_images: int = 8, img_size: int = 320,
                     num_classes: int = 4, seed: int = 0,
                     max_objects: int = 4) -> Tuple[str, str]:
    """Write images/ and annotations.json under `root`; returns (img_dir,
    ann_json)."""
    import cv2

    rng = np.random.RandomState(seed)
    img_dir = osp.join(root, 'images')
    os.makedirs(img_dir, exist_ok=True)

    images, annotations = [], []
    ann_id = 1
    for img_id in range(1, num_images + 1):
        img = rng.randint(40, 90, size=(img_size, img_size, 3)).astype(np.uint8)
        noise = rng.randint(0, 30, size=(img_size, img_size, 3)).astype(np.uint8)
        img = cv2.add(img, noise)

        n_obj = rng.randint(1, max_objects + 1)
        for _ in range(n_obj):
            cls = int(rng.randint(0, num_classes))      # 0-based shape class
            color = tuple(int(c) for c in rng.randint(120, 255, size=3))
            mask = np.zeros((img_size, img_size), np.uint8)
            cx, cy = rng.randint(60, img_size - 60, size=2)
            r1, r2 = rng.randint(25, 60, size=2)
            kind = cls % 3
            if kind == 0:
                cv2.ellipse(mask, (cx, cy), (r1, r2), rng.randint(0, 180),
                            0, 360, 1, -1)
            elif kind == 1:
                cv2.rectangle(mask, (cx - r1, cy - r2), (cx + r1, cy + r2), 1, -1)
            else:
                pts = np.array([[cx, cy - r2], [cx - r1, cy + r2],
                                [cx + r1, cy + r2]], np.int32)
                cv2.fillPoly(mask, [pts], 1)
            mask = np.clip(mask, 0, 1)
            if mask.sum() < 100:
                continue
            img[mask > 0] = color

            ys, xs = np.nonzero(mask)
            x1, x2 = int(xs.min()), int(xs.max())
            y1, y2 = int(ys.min()), int(ys.max())
            polys = _mask_to_polygon(mask)
            if not polys:
                continue
            annotations.append({
                'id': ann_id, 'image_id': img_id, 'category_id': cls + 1,
                'segmentation': polys, 'iscrowd': 0,
                'bbox': [x1, y1, x2 - x1 + 1, y2 - y1 + 1],
                'area': float(mask.sum()),
            })
            ann_id += 1

        name = f'{img_id:06d}.jpg'
        cv2.imwrite(osp.join(img_dir, name), img)
        images.append({'id': img_id, 'file_name': name,
                       'height': img_size, 'width': img_size})

    ann = {
        'images': images,
        'annotations': annotations,
        'categories': [{'id': i + 1, 'name': f'shape{i}'}
                       for i in range(num_classes)],
    }
    ann_path = osp.join(root, 'annotations.json')
    with open(ann_path, 'w') as f:
        json.dump(ann, f)
    return img_dir, ann_path
