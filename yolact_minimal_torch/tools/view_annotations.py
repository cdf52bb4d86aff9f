"""Render the ground truth of a COCO-format dataset: masks, boxes and
category ids over each image, written as files.

    python -m yolact_minimal_torch.tools.view_annotations --img_dir DIR --ann FILE
        [--out_dir results/annotations] [--limit 20]

Writes OUT_DIR/<file_name> for the first LIMIT images that have
annotations, in image-id order. Needs cv2.
"""
import argparse
import os
import os.path as osp

import numpy as np

from yolact_minimal_torch.config import COLORS
from yolact_minimal_torch.data.coco_io import COCO


def main(argv=None):
    import cv2

    p = argparse.ArgumentParser(description='Overlay a COCO dataset\'s ground truth')
    p.add_argument('--img_dir', required=True)
    p.add_argument('--ann', required=True)
    p.add_argument('--out_dir', default='results/annotations')
    p.add_argument('--limit', type=int, default=20)
    args = p.parse_args(argv)

    coco = COCO(args.ann)
    os.makedirs(args.out_dir, exist_ok=True)
    for i, (img_id, anns) in enumerate(sorted(coco.imgToAnns.items())):
        if i >= args.limit:
            break
        info = coco.loadImgs(img_id)[0]
        img = cv2.imread(osp.join(args.img_dir, info['file_name']))
        masks = np.stack([coco.annToMask(a) for a in anns], 0)
        labels = np.array([a['category_id'] for a in anns])

        sem = (masks * labels[:, None, None]).astype(int).sum(0) % len(COLORS)
        overlay = cv2.addWeighted(COLORS[sem].astype(np.uint8), 0.4, img, 0.6, 0)
        for a in anns:
            x, y, w, h = [int(v) for v in a['bbox']]
            cv2.rectangle(overlay, (x, y), (x + w, y + h), (0, 255, 0), 1)
            cv2.putText(overlay, str(a['category_id']), (x, y + 12),
                        cv2.FONT_HERSHEY_DUPLEX, 0.5, (255, 255, 255), 1)
        out = osp.join(args.out_dir, info['file_name'])
        cv2.imwrite(out, overlay)
        print(f'wrote {out}')


if __name__ == '__main__':
    main()
