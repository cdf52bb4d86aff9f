"""Offline dataset converters: Pascal-SBD and labelme -> COCO-format json.

The port's own copy of the JAX package's `data/converters.py`, on the
port's RLE codec (data/coco_io.py): neither pycocotools nor the labelme
package is needed. Shapes are rasterized with cv2 and the Pascal-SBD
`.mat` files read with scipy; both are imported by the functions that use
them, so importing this module needs neither.
"""
from __future__ import annotations

import glob
import json
import os.path as osp
from typing import Dict, List, Optional

import numpy as np

from yolact_minimal_torch.data.coco_io import mask_to_rle


def mask_to_bbox(mask: np.ndarray) -> List[int]:
    """[x, y, w, h] of the mask's nonzero pixels (w, h as max - min)."""
    ys, xs = np.nonzero(mask)
    if len(xs) == 0:
        return [0, 0, 0, 0]
    return [int(xs.min()), int(ys.min()),
            int(xs.max() - xs.min()), int(ys.max() - ys.min())]


def pascal_sbd_to_coco(folder_path: str, splits=('train', 'val')) -> List[str]:
    """Convert Pascal-SBD instance .mat annotations into COCO jsons.

    Expects {folder}/img/*.jpg, {folder}/inst/*.mat (GTinst with a
    Segmentation label image and per-instance Categories), and
    {folder}/{split}.txt name lists. Writes pascal_sbd_{split}.json and
    returns their paths.
    """
    import cv2
    import scipy.io

    out_paths = []
    image_id, ann_id = 1, 1
    for split in splits:
        with open(osp.join(folder_path, f'{split}.txt')) as f:
            names = f.read().strip().split('\n')

        images, annotations = [], []
        for name in names:
            mat = scipy.io.loadmat(osp.join(folder_path, 'inst', f'{name}.mat'))
            gt = mat['GTinst'][0][0]
            seg_img = gt[0]                       # instance-label image
            classes = [int(c[0]) for c in gt[2]]  # per-instance category ids

            for idx, cls in enumerate(classes):
                mask = (seg_img == idx + 1).astype(np.uint8)
                annotations.append({
                    'id': ann_id, 'image_id': image_id, 'category_id': cls,
                    'segmentation': mask_to_rle(mask),
                    'area': float(mask.sum()),
                    'bbox': mask_to_bbox(mask), 'iscrowd': 0})
                ann_id += 1

            img = cv2.imread(osp.join(folder_path, 'img', f'{name}.jpg'))
            images.append({'id': image_id, 'width': img.shape[1],
                           'height': img.shape[0], 'file_name': f'{name}.jpg'})
            image_id += 1

        out = osp.join(folder_path, f'pascal_sbd_{split}.json')
        with open(out, 'w') as f:
            json.dump({'info': {'description': 'Pascal SBD'},
                       'images': images, 'annotations': annotations,
                       'categories': [{'id': i + 1} for i in range(20)]}, f)
        out_paths.append(out)
    return out_paths


def _labelme_shape_to_mask(img_hw, points, shape_type: Optional[str]) -> np.ndarray:
    """Rasterize a labelme shape: circle (center, a point on it), rectangle
    (two corners) or polygon (the default)."""
    import cv2

    mask = np.zeros(img_hw, np.uint8)
    pts = np.asarray(points, np.float64)
    if shape_type == 'circle':
        (cx, cy), (px, py) = pts
        r = int(round(np.hypot(px - cx, py - cy)))
        cv2.circle(mask, (int(round(cx)), int(round(cy))), r, 1, -1)
    elif shape_type == 'rectangle':
        (x1, y1), (x2, y2) = pts
        cv2.rectangle(mask, (int(round(x1)), int(round(y1))),
                      (int(round(x2)), int(round(y2))), 1, -1)
    else:
        cv2.fillPoly(mask, [np.round(pts).astype(np.int32)], 1)
    return mask


def labelme_to_coco(img_dir: str, label_file: str, img_type: str = 'jpg',
                    out_name: str = 'custom_ann.json') -> str:
    """Convert a folder of labelme jsons + a labels.txt (background first)
    into one COCO-format json in that folder; category ids are the 0-based
    line indices of labels.txt. Returns its path."""
    with open(label_file) as f:
        class_name_to_id = {line.strip(): i
                            for i, line in enumerate(f) if line.strip()}

    data: Dict = dict(images=[], annotations=[], categories=[
        dict(id=i, name=n) for n, i in class_name_to_id.items()])

    for image_id, lf in enumerate(sorted(glob.glob(osp.join(img_dir, '*.json')))):
        with open(lf) as f:
            item = json.load(f)
        if 'shapes' not in item:
            continue
        h, w = item['imageHeight'], item['imageWidth']
        data['images'].append(dict(
            file_name=osp.basename(lf).replace('json', img_type),
            height=h, width=w, id=image_id))

        for shape in item['shapes']:
            label = shape['label']
            if label not in class_name_to_id:
                raise KeyError(f'{label!r} not in {label_file}')
            mask = _labelme_shape_to_mask((h, w), shape['points'],
                                          shape.get('shape_type'))
            data['annotations'].append(dict(
                id=len(data['annotations']), image_id=image_id,
                category_id=class_name_to_id[label],
                segmentation=[np.asarray(shape['points']).flatten().tolist()],
                area=float(mask.sum()), bbox=mask_to_bbox(mask), iscrowd=0))

    out = osp.join(img_dir, out_name)
    with open(out, 'w') as f:
        json.dump(data, f)
    return out
