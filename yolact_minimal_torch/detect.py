"""Detection CLI over a folder of images or a video, with visualization.

    python -m yolact_minimal_torch.detect --weight weights/x_res50_coco.pth \
        (--image DIR [--save_lincomb] | --video V [--video_bs 8] [--real_time]) \
        [--traditional_nms] [--cfg res50_coco] [--device cuda|cpu]

Writes the drawn images to results/images/ and a drawn video to
results/videos/ (with --real_time it is shown in a window instead). The weight
is a `.ckpt` the JAX package wrote or a reference-format `.pth` state_dict.
The images come from `COCODetection(cfg, 'detect')`, read and written with cv2
where it imports, else PIL (utils/image_io.py); video frames go through the
device `video_bs` at a time (utils/video.py) and need cv2. Without the
library that the input needs the CLI stops before the detector is built.
--traditional_nms runs greedy per-class NMS on the host (pipeline.py);
--save_lincomb also writes results/images/lincomb_<name>, a grid of the
prototypes, for each image with a detection (needs cv2).
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
import time

from yolact_minimal_torch.config import cfg_name_from_weight, get_config
from yolact_minimal_torch.data import augment
from yolact_minimal_torch.data.coco import COCODetection
from yolact_minimal_torch.pipeline import load_detector
from yolact_minimal_torch.utils import image_io, video
from yolact_minimal_torch.utils.visualize import draw_img, draw_lincomb

NO_CV2_LINCOMB = '--save_lincomb needs cv2: the grid is coloured with cv2.applyColorMap'


def detect_one(detector, cfg, img_normed, img_origin, img_name=None):
    """One image, normalized by `val_aug` and as read (BGR) -> the image with
    its detections drawn. With
    `cfg.cutout`, the cutouts are written as `<img_name>_total_obj.jpg` and
    `<img_name>_<i>.jpg` under results/images/; with `cfg.save_lincomb`,
    `lincomb_<img_name>` where a slot is valid."""
    h, w = img_origin.shape[:2]
    dets, masks_proto, proto = detector(img_normed[None])
    det0 = type(dets)(*(x[0] for x in dets))
    if cfg.save_lincomb and img_name:
        valid = det0.valid.cpu().numpy()
        if valid.any():
            draw_lincomb(proto[0].cpu().numpy(), det0.coefs.cpu().numpy()[valid], img_name)
    ids, scores, boxes, masks = detector.postprocess_host(
        det0, masks_proto[0], h, w, visual_thre=cfg.visual_thre)
    return draw_img(ids, scores, boxes, masks, img_origin, cfg, img_name=img_name)


def detect_video(detector, cfg):
    """The frames of `cfg.video` through `Detector.__call__` `cfg.video_bs` at
    a time (the last batch padded), each drawn with its frame rate and written
    to results/videos/<name>, or shown with `cfg.real_time`. Returns (frames,
    frames a second)."""
    def draw(result, j, frame, fps):
        dets, masks_proto = result
        one = type(dets)(*(x[j] for x in dets))
        ids, scores, boxes, masks = detector.postprocess_host(
            one, masks_proto[j], frame.shape[0], frame.shape[1], visual_thre=cfg.visual_thre)
        return draw_img(ids, scores, boxes, masks, frame, cfg, fps=fps)

    out_dir = None if cfg.real_time else 'results/videos'
    frames, fps = video.run_video(cfg.video, out_dir, cfg.video_bs, cfg.img_size,
                                  lambda images: detector(images)[:2], draw)
    if out_dir is not None:
        print(f'Finished, {frames} frames at {fps:.2f} fps after the first batch, saved in: '
              f'{osp.join(out_dir, osp.basename(cfg.video))}')
    return frames, fps


def main(argv=None):
    parser = argparse.ArgumentParser(description='YOLACT detection (PyTorch/CUDA port)')
    parser.add_argument('--weight', type=str, required=True)
    parser.add_argument('--image', type=str, default=None,
                        help='Folder of .jpg/.png images to detect.')
    parser.add_argument('--video', type=str, default=None)
    parser.add_argument('--video_bs', type=int, default=8,
                        help='Frames a device batch in video mode.')
    parser.add_argument('--real_time', action='store_true',
                        help='Show the video in a window instead of writing it.')
    parser.add_argument('--cfg', type=str, default=None)
    parser.add_argument('--device', type=str, default='cuda', choices=('cuda', 'cpu'))
    parser.add_argument('--img_size', type=int, default=544)
    parser.add_argument('--hide_mask', action='store_true')
    parser.add_argument('--hide_bbox', action='store_true')
    parser.add_argument('--hide_score', action='store_true')
    parser.add_argument('--cutout', action='store_true')
    parser.add_argument('--save_lincomb', action='store_true',
                        help='Also write a grid of the prototypes for each image (needs cv2).')
    parser.add_argument('--traditional_nms', action='store_true',
                        help='Greedy per-class NMS on the host instead of fast NMS.')
    parser.add_argument('--no_crop', action='store_true')
    parser.add_argument('--visual_thre', default=0.3, type=float)
    args = parser.parse_args(argv)
    if (args.image is None) == (args.video is None):
        parser.error('give one of --image <folder> and --video <path>')
    if args.video_bs < 1:
        parser.error('--video_bs must be at least 1')

    name = args.cfg or cfg_name_from_weight(args.weight)
    cfg = get_config(name, mode='detect', **{
        k: v for k, v in vars(args).items() if k not in ('weight', 'cfg', 'device')})
    try:        # before the detector is built: fail at once without the library needed
        if args.video:
            video.import_cv2()
        else:
            library = image_io.backend()
            if args.save_lincomb:
                augment.import_cv2(NO_CV2_LINCOMB)
    except ImportError as e:
        raise SystemExit(str(e)) from None
    if args.video:
        detect_video(load_detector(args.weight, cfg, device=args.device), cfg)
        return
    dataset = COCODetection(cfg, mode='detect')
    detector = load_detector(args.weight, cfg, device=args.device)

    if not len(dataset):
        raise SystemExit(f'No .jpg/.png images in {cfg.image}')
    print(f'image library: {library}')
    os.makedirs('results/images', exist_ok=True)
    t0 = None
    for i in range(len(dataset)):
        if i == 1:
            t0 = time.perf_counter()     # the first image includes warm-up
        try:
            item = dataset.get_detect(i)
        except (OSError, ValueError) as e:
            raise SystemExit(f'Cannot read {dataset.image_path[i]}: {e}') from None
        out = detect_one(detector, cfg, item['image'], item['origin'], img_name=item['name'])
        image_io.imwrite(osp.join('results/images', item['name']), out)
        print(f'\rDetecting: {i + 1}/{len(dataset)}', end='')
    if t0 is not None:
        print(f'\nfps: {(len(dataset) - 1) / (time.perf_counter() - t0):.2f}', end='')
    print('\nFinished, saved in: results/images.')


if __name__ == '__main__':
    main()
