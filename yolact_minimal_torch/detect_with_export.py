"""Standalone driver for an artifact that `export.py` wrote.

    python -m yolact_minimal_torch.detect_with_export --artifact A.pt2 \
        (--image DIR | --video V) [--visual_thre 0.3] [--hide_mask] [--hide_bbox] \
        [--hide_score] [--no_crop] [--real_time] [--device cuda|cpu]

It runs the exported program and finishes detection with the numpy
postprocess (ops/nms_numpy.py), as the reference's ONNX and TensorRT drivers
do: no model is built and `models/` is not imported. Chunks are the
artifact's batch, the last one padded. While the program runs on one chunk a
reader thread decodes and `val_aug`s the next and a writer thread
postprocesses and draws the previous one. Drawn images go to
results/export_images/, a drawn video to results/export_videos/ (with
--real_time too, which draws the frame rate on each frame). Images are
read and written with cv2 or PIL (utils/image_io.py); the postprocess's mask
resize and video need cv2.
"""
from __future__ import annotations

import argparse
import glob
import os
import os.path as osp
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from yolact_minimal_torch.config import get_config
from yolact_minimal_torch.data.augment import val_aug
from yolact_minimal_torch.deploy import load_exported
from yolact_minimal_torch.ops.nms_numpy import after_nms_numpy, detect_postprocess_numpy
from yolact_minimal_torch.utils import image_io, video
from yolact_minimal_torch.utils.visualize import draw_img

IMAGE_DIR, VIDEO_DIR = 'results/export_images', 'results/export_videos'


def main(argv=None):
    p = argparse.ArgumentParser(description='YOLACT exported-artifact driver (PyTorch/CUDA port)')
    p.add_argument('--artifact', type=str, required=True)
    p.add_argument('--image', default=None, type=str, help='Folder of .jpg/.png images.')
    p.add_argument('--video', default=None, type=str)
    p.add_argument('--visual_thre', default=0.3, type=float)
    p.add_argument('--hide_mask', action='store_true')
    p.add_argument('--hide_bbox', action='store_true')
    p.add_argument('--hide_score', action='store_true')
    p.add_argument('--no_crop', action='store_true')
    p.add_argument('--real_time', action='store_true',
                   help='Draw the frame rate on each video frame.')
    p.add_argument('--device', type=str, default='cuda', choices=('cuda', 'cpu'))
    args = p.parse_args(argv)
    if (args.image is None) == (args.video is None):
        p.error('give one of --image <folder> and --video <path>')
    try:        # before the artifact is loaded: the mask resize needs cv2
        video.import_cv2()
        image_io.backend()
    except ImportError as e:
        raise SystemExit(str(e)) from None

    call, meta, anchors = load_exported(args.artifact, args.device)
    bs = meta['batch']
    cfg = get_config(meta['name'], mode='detect', img_size=meta['img_size'],
                     visual_thre=args.visual_thre, hide_mask=args.hide_mask,
                     hide_bbox=args.hide_bbox, hide_score=args.hide_score,
                     no_crop=args.no_crop, real_time=args.real_time,
                     image=args.image, video=args.video)

    def run_chunk(normed):
        """One call of the program on a chunk padded to its batch -> the four
        outputs as numpy arrays."""
        x = np.stack(normed).astype(np.float32)
        if len(x) < bs:
            x = np.concatenate([x, np.repeat(x[-1:], bs - len(x), 0)])
        return [o.cpu().numpy() for o in call(x)]

    def postprocess_one(outs, j, img_origin, img_name=None, fps=None):
        """The numpy tail and the drawing for element j of a chunk."""
        class_p, box_p, coef_p, proto = outs
        h, w = img_origin.shape[:2]
        boxes, coefs, ids, scores = detect_postprocess_numpy(
            class_p[j], box_p[j], coef_p[j], anchors, cfg.nms_score_thre,
            cfg.nms_iou_thre, cfg.top_k, cfg.max_detections)
        ids, scores, boxes_pix, masks = after_nms_numpy(
            ids, scores, boxes, coefs, proto[j], h, w,
            visual_thre=cfg.visual_thre, do_crop=not cfg.no_crop)
        return draw_img(ids, scores, boxes_pix, masks, img_origin, cfg,
                        img_name=img_name, fps=fps, out_dir=IMAGE_DIR)

    if args.video:
        # the file is written with or without --real_time, as the JAX
        # detect_with_export.py does; --real_time only adds the fps overlay
        frames, fps = video.run_video(args.video, VIDEO_DIR, bs, cfg.img_size, run_chunk,
                                      lambda outs, j, frame, fps: postprocess_one(
                                          outs, j, frame, fps=fps))
        print(f'Finished, {frames} frames at {fps:.2f} fps after the first batch, saved in: '
              f'{osp.join(VIDEO_DIR, osp.basename(args.video))}')
        return

    paths = sorted(glob.glob(osp.join(args.image, '*.jpg')) +
                   glob.glob(osp.join(args.image, '*.png')))
    if not paths:
        raise SystemExit(f'No .jpg/.png images in {args.image}')
    os.makedirs(IMAGE_DIR, exist_ok=True)
    chunks = [paths[i:i + bs] for i in range(0, len(paths), bs)]

    def read_chunk(chunk):
        imgs = [image_io.imread(pth) for pth in chunk]
        return imgs, [val_aug(im, cfg.img_size) for im in imgs]

    def finish_chunk(chunk, imgs, outs):
        for j, pth in enumerate(chunk):
            name = osp.basename(pth)
            image_io.imwrite(osp.join(IMAGE_DIR, name),
                             postprocess_one(outs, j, imgs[j], img_name=name))

    reader, writer = ThreadPoolExecutor(1), ThreadPoolExecutor(1)
    done, t0, pending = 0, None, None
    fut = reader.submit(read_chunk, chunks[0])
    try:
        for ci, chunk in enumerate(chunks):
            imgs, normed = fut.result()
            if ci + 1 < len(chunks):
                fut = reader.submit(read_chunk, chunks[ci + 1])
            outs = run_chunk(normed)
            if pending is not None:
                pending.result()
            pending = writer.submit(finish_chunk, chunk, imgs, outs)
            done += len(chunk)
            if t0 is None:
                t0, warm = time.perf_counter(), done      # the first chunk includes warm-up
            fps = (done - warm) / (time.perf_counter() - t0) if done > warm else 0.0
            print(f'\rDetecting: {done}/{len(paths)}, fps: {fps:.2f}', end='')
        pending.result()
    finally:
        reader.shutdown(wait=True)
        writer.shutdown(wait=True)
    print(f'\nFinished, saved in: {IMAGE_DIR}')


if __name__ == '__main__':
    main()
