"""Detection CLI over a folder of images, with visualization.

    python -m yolact_minimal_torch.detect --weight weights/x_res50_coco.pth \
        --image DIR [--cfg res50_coco] [--device cuda|cpu]

Writes the drawn images to results/images/. The weight is a reference-format
`.pth` state_dict. Images are read and written with cv2 where it imports,
else PIL (utils/image_io.py); with neither the CLI stops before the detector
is built. Video input, --traditional_nms and --save_lincomb are not ported
yet.
"""
from __future__ import annotations

import argparse
import glob
import os
import os.path as osp
import time

from yolact_minimal_torch.config import cfg_name_from_weight, get_config
from yolact_minimal_torch.data.augment import val_aug
from yolact_minimal_torch.pipeline import load_detector
from yolact_minimal_torch.utils import image_io
from yolact_minimal_torch.utils.visualize import draw_img


def detect_one(detector, cfg, img_origin):
    """One BGR image -> the image with its detections drawn."""
    h, w = img_origin.shape[:2]
    dets, masks_proto, _ = detector(val_aug(img_origin, cfg.img_size)[None])
    det0 = type(dets)(*(x[0] for x in dets))
    ids, scores, boxes, masks = detector.postprocess_host(
        det0, masks_proto[0], h, w, visual_thre=cfg.visual_thre)
    return draw_img(ids, scores, boxes, masks, img_origin, cfg)


def main(argv=None):
    parser = argparse.ArgumentParser(description='YOLACT detection (PyTorch/CUDA port)')
    parser.add_argument('--weight', type=str, required=True)
    parser.add_argument('--image', type=str, required=True,
                        help='Folder of .jpg/.png images to detect.')
    parser.add_argument('--cfg', type=str, default=None)
    parser.add_argument('--device', type=str, default='cuda', choices=('cuda', 'cpu'))
    parser.add_argument('--img_size', type=int, default=544)
    parser.add_argument('--hide_mask', action='store_true')
    parser.add_argument('--hide_bbox', action='store_true')
    parser.add_argument('--hide_score', action='store_true')
    parser.add_argument('--cutout', action='store_true')
    parser.add_argument('--no_crop', action='store_true')
    parser.add_argument('--visual_thre', default=0.3, type=float)
    args = parser.parse_args(argv)

    name = args.cfg or cfg_name_from_weight(args.weight)
    cfg = get_config(name, mode='detect', **{
        k: v for k, v in vars(args).items() if k not in ('weight', 'cfg', 'device')})
    paths = sorted(glob.glob(osp.join(cfg.image, '*.jpg')) +
                   glob.glob(osp.join(cfg.image, '*.png')))
    try:        # before the detector is built: fail at once without an image library
        library = image_io.backend()
    except ImportError as e:
        raise SystemExit(str(e)) from None
    detector = load_detector(args.weight, cfg, device=args.device)

    if not paths:
        raise SystemExit(f'No .jpg/.png images in {cfg.image}')
    print(f'image library: {library}')
    os.makedirs('results/images', exist_ok=True)
    t0 = None
    for i, path in enumerate(paths):
        if i == 1:
            t0 = time.perf_counter()     # the first image includes warm-up
        try:
            img = image_io.imread(path)
        except (OSError, ValueError) as e:
            raise SystemExit(f'Cannot read {path}: {e}') from None
        out = detect_one(detector, cfg, img)
        image_io.imwrite(osp.join('results/images', osp.basename(path)), out)
        print(f'\rDetecting: {i + 1}/{len(paths)}', end='')
    if t0 is not None:
        print(f'\nfps: {(len(paths) - 1) / (time.perf_counter() - t0):.2f}', end='')
    print('\nFinished, saved in: results/images.')


if __name__ == '__main__':
    main()
