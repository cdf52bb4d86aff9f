"""Evaluation CLI: COCO-style box and mask mAP.

    python -m yolact_minimal_torch.eval --weight W [--img_size 544]
        [--val_num N] [--val_bs B] [--coco_api] [--strict] [--traditional_nms]
        [--cfg NAME] [--val_imgs DIR] [--val_ann FILE] [--device cuda|cpu]

W is a `.ckpt` that the JAX package wrote or a reference-format `.pth`; the
config name is read from its file name unless --cfg gives it. The CLI
prints the table that the JAX package's eval.py prints for the same weights
and images. Images go to the device in batches of cfg.val_bs (the tail
padded with its last image, which is not scored); the network, decode and
NMS run there, and the host upsamples each image's masks and scores it. With
--traditional_nms the NMS and the masks run on the host (pipeline.py).

It needs cv2: polygon annotations are rasterized with cv2.fillPoly. Without
cv2 it stops before the detector is built. --data_parallel is not ported
yet.
"""
from __future__ import annotations

import argparse
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from yolact_minimal_torch.config import cfg_name_from_weight, get_config
from yolact_minimal_torch.data.coco import COCODetection
from yolact_minimal_torch.data.coco_io import require_cv2
from yolact_minimal_torch.ops.nms import Detections
from yolact_minimal_torch.pipeline import load_detector
from yolact_minimal_torch.utils import image_io, timer
from yolact_minimal_torch.utils.map_eval import MakeJson, calc_map, make_ap_data, prep_metrics
from yolact_minimal_torch.utils.progress import ProgressBar


def evaluate(detector, cfg, step=None, max_images: int = -1):
    """Runs validation on `detector` (pipeline.Detector, on its device);
    returns (table, box_row, mask_row), or three Nones with cfg.coco_api
    (the jsons go to results/ and are scored by utils/cocoeval.py)."""
    dataset = COCODetection(cfg, mode='val')
    n = len(dataset) if max_images == -1 else min(max_images, len(dataset))
    bs = max(1, int(cfg.val_bs))
    progress = ProgressBar(40, n)
    timer.reset()

    ap_data = make_ap_data(len(cfg.class_names))
    make_json = MakeJson(cfg.continuous_id) if cfg.coco_api else None

    # image decode and resize in threads, ahead of the device
    pool = ThreadPoolExecutor(4)
    try:
        return _eval_loop(detector, cfg, dataset, n, bs, progress, ap_data,
                          make_json, pool, step)
    finally:
        pool.shutdown(wait=False, cancel_futures=True)


def _dispatch(detector, imgs: np.ndarray):
    """Queue one batch on the detector's device, and behind it the copy of
    its slate and masks_proto to the host. Returns (Detections, masks_proto,
    event): on the card the tensors are pinned host buffers that are ready
    once the event has completed; on the CPU, or where the detector hands
    back host tensors already (--traditional_nms), the event is None."""
    images = torch.from_numpy(imgs)
    if detector.device.type != 'cuda':
        dets, masks_proto, _ = detector(images)
        return dets, masks_proto, None
    images = images.pin_memory().to(detector.device, non_blocking=True)
    dets, masks_proto, _ = detector(images)
    if masks_proto.device.type == 'cpu':
        return dets, masks_proto, None
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)
            for t in (*dets, masks_proto)]
    event = torch.cuda.Event()
    event.record()
    return Detections(*host[:-1]), host[-1], event


def _eval_loop(detector, cfg, dataset, n, bs, progress, ap_data, make_json,
               pool, step):
    ahead = 2 * bs + 2
    futures = {i: pool.submit(dataset.get_val, i) for i in range(min(n, ahead))}
    state = dict(done=0, prev=None)

    def drain(pending):
        """Host tail of one batch already queued: wait for its copy, then
        upsample and score each image. It runs after the next batch has been
        queued, so the device computes that batch meanwhile."""
        items, (dets, masks_proto, event) = pending
        with timer.counter('fetch'):
            if event is not None:
                event.synchronize()
        for j, item in enumerate(items):
            det0 = type(dets)(*(x[j] for x in dets))
            with timer.counter('after_nms'):
                ids, scores, boxes, masks = detector.postprocess_host(
                    det0, masks_proto[j], item['height'], item['width'])

            with timer.counter('metric'):
                if len(ids) != 0:
                    if cfg.coco_api:
                        for k in range(len(ids)):
                            b = boxes[k]
                            if (b[3] - b[1]) * (b[2] - b[0]) > 0:
                                make_json.add_bbox(item['image_id'], ids[k], b, scores[k])
                                make_json.add_mask(item['image_id'], ids[k], masks[k], scores[k])
                    else:
                        prep_metrics(ap_data, ids, scores, boxes, masks,
                                     item['boxes'], item['labels'], item['masks'],
                                     item['height'], item['width'])
        state['done'] += len(items)

        now = time.perf_counter()
        if state['prev'] is not None:
            timer.add_batch_time(now - state['prev'])
            t_t, t_fn, t_an, t_me = timer.get_times(
                ['batch', 'fetch', 'after_nms', 'metric'])
            print(f'\rTesting: {progress.get_bar(state["done"])} '
                  f'{state["done"]}/{n}, '
                  f'total fps: {bs / max(t_t, 1e-9):.2f} | '
                  f't_t: {t_t:.3f} | t_fetch: {t_fn:.3f} | '
                  f't_after_nms: {t_an:.3f} | t_metric: {t_me:.3f}', end='')
        state['prev'] = now

    pending = None
    for batch_start in range(0, n, bs):
        if batch_start == bs:
            timer.start()   # the first batch includes the warm-up
        items = []
        for i in range(batch_start, min(batch_start + bs, n)):
            try:
                items.append(futures.pop(i).result())
            except RuntimeError as e:
                # a crowd-only or unannotated image: skipped, unless --strict
                if cfg.strict:
                    raise
                print(f'\nWarning: skipping val image {i}: {e}')
            if i + ahead < n:
                futures[i + ahead] = pool.submit(dataset.get_val, i + ahead)
        if not items:
            continue
        imgs = np.stack([it['image'] for it in items], 0)
        if len(items) < bs:   # pad the tail batch to the batch size
            imgs = np.concatenate(
                [imgs, np.repeat(imgs[-1:], bs - len(items), axis=0)], 0)

        # queue this batch first, then drain the previous one
        queued = _dispatch(detector, imgs)
        if pending is not None:
            drain(pending)
        pending = (items, queued)

    if pending is not None:
        drain(pending)
    print()
    if cfg.coco_api:
        make_json.dump()
        print("Json files dumped, saved in: 'results/', start evaluating.")
        from yolact_minimal_torch.utils.cocoeval import evaluate_detections
        evaluate_detections(cfg.val_ann, 'results/bbox_detections.json',
                            'results/mask_detections.json')
        return None, None, None

    table, box_row, mask_row = calc_map(ap_data, len(cfg.class_names), step=step)
    print(table)
    return table, box_row, mask_row


def main(argv=None):
    parser = argparse.ArgumentParser(description='YOLACT evaluation (PyTorch/CUDA port)')
    parser.add_argument('--weight', type=str, required=True)
    parser.add_argument('--img_size', type=int, default=544)
    parser.add_argument('--val_num', type=int, default=-1)
    parser.add_argument('--val_bs', type=int, default=None,
                        help='Device batch size for eval (default: cfg.val_bs).')
    parser.add_argument('--coco_api', action='store_true')
    parser.add_argument('--strict', action='store_true',
                        help='Stop on crowd-only val images instead of skipping them.')
    parser.add_argument('--traditional_nms', action='store_true',
                        help='Greedy per-class NMS on the host instead of fast NMS.')
    parser.add_argument('--cfg', type=str, default=None,
                        help='Override config name (else parsed from weight).')
    parser.add_argument('--data_parallel', type=int, default=0, help='Not ported yet.')
    parser.add_argument('--val_imgs', type=str, default=None,
                        help='Override the validation image directory.')
    parser.add_argument('--val_ann', type=str, default=None,
                        help='Override the validation annotation json.')
    parser.add_argument('--device', type=str, default='cuda', choices=('cuda', 'cpu'))
    args = parser.parse_args(argv)
    if args.data_parallel:
        raise SystemExit('--data_parallel is not ported to yolact_minimal_torch yet')

    name = args.cfg or cfg_name_from_weight(args.weight)
    overrides = {} if args.val_bs is None else {'val_bs': args.val_bs}
    if args.val_imgs:
        overrides['val_imgs'] = args.val_imgs
    if args.val_ann:
        overrides['val_ann'] = args.val_ann
    cfg = get_config(name, mode='val', img_size=args.img_size,
                     val_num=args.val_num, coco_api=args.coco_api,
                     strict=args.strict, traditional_nms=args.traditional_nms,
                     **overrides)
    cfg.print_cfg()
    try:        # before the detector is built
        image_io.backend()
        require_cv2()
    except ImportError as e:
        raise SystemExit(str(e)) from None

    # float32 convolutions in float32, as the JAX package computes them:
    # TF32 would move random-init scores past their near-ties
    torch.backends.cudnn.allow_tf32 = False
    detector = load_detector(args.weight, cfg, device=args.device)
    evaluate(detector, cfg, max_images=cfg.val_num)


if __name__ == '__main__':
    main()
