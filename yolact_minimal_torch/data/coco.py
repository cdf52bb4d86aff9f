"""COCO-style dataset, fixed-shape train batches and the train loader (the
port's own copy).

Train items are augmented by `train_aug` (needs cv2); their gt masks are
downsampled to prototype (S/4) and seg (S/8) size with cv2's bilinear and
binarized, and `assemble_train_batch` pads a batch's gt to `max_gt` rows
with a validity mask. `TrainLoader` shuffles each epoch with a shared seed,
builds batches in a pool of worker processes (or threads), seeds batch bi
of epoch e with `random.Random(f'{seed}-{e}-{bi}')`, and yields them in
order: the JAX package's loader, byte for byte. Val items carry the image
resized and normalized by `val_aug` and the gt at the original scale: boxes
normalized xyxy, binary masks, class indices. Images are read through
`utils/image_io.py` (cv2, else PIL), polygons are rasterized by cv2
(`data/coco_io.py`).
"""
from __future__ import annotations

import glob
import os.path as osp
import random
from collections import deque
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from yolact_minimal_torch.config import Config
from yolact_minimal_torch.data.augment import import_cv2, train_aug, val_aug
from yolact_minimal_torch.data.coco_io import COCO
from yolact_minimal_torch.utils import image_io


def downsample_mask_pyramid(masks: np.ndarray, img_size: int):
    """Binarized gt masks at prototype (S/4) and seg (S/8) size: cv2
    bilinear (the align_corners=False sampling of the reference's in-loss
    F.interpolate), then > 0.5."""
    cv2 = import_cv2()
    ph = pw = img_size // 4
    sh = sw = img_size // 8
    n = masks.shape[0]
    proto = np.empty((n, ph, pw), np.float32)
    seg = np.empty((n, sh, sw), np.float32)
    for i in range(n):
        m = masks[i].astype(np.float32)
        proto[i] = cv2.resize(m, (pw, ph), interpolation=cv2.INTER_LINEAR)
        seg[i] = cv2.resize(m, (sw, sh), interpolation=cv2.INTER_LINEAR)
    return (proto > 0.5).astype(np.float32), (seg > 0.5).astype(np.float32)


class COCODetection:
    """Modes: train (augmented fixed-size samples, what `train.py` reads),
    val (resized image + original-scale gt, what `eval.py` reads), detect (a
    folder of images, what `detect.py` reads)."""

    def __init__(self, cfg: Config, mode: str = 'val'):
        if mode not in ('train', 'val', 'detect'):
            raise ValueError(f'COCODetection mode {mode!r}: train, val or detect')
        self.cfg = cfg
        self.mode = mode
        if mode in ('train', 'val'):
            self.image_path = cfg.train_imgs if mode == 'train' else cfg.val_imgs
            self.coco = COCO(cfg.train_ann if mode == 'train' else cfg.val_ann)
            self.ids = list(self.coco.imgToAnns.keys())
        else:
            self.image_path = sorted(glob.glob(osp.join(cfg.image, '*.jpg')) +
                                     glob.glob(osp.join(cfg.image, '*.png')))
        self.continuous_id = cfg.continuous_id

    def __len__(self):
        if self.mode == 'train':
            return len(self.ids)
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
            if self.mode == 'train' and (x < 0 or y < 0 or bw < 4 or bh < 4):
                continue                                  # a degenerate box
            boxes.append([x, y, x + bw, y + bh])
            masks.append(self.coco.annToMask(a))
            labels.append(self.continuous_id[a['category_id']] - 1)
        if not boxes:
            return img, None, None, None, h, w
        return (img, np.array(boxes, np.float32), np.stack(masks, 0),
                np.array(labels, np.int32), h, w)

    def get_train(self, index: int, rnd: random.Random) -> Optional[dict]:
        """One augmented sample, or None where nothing survives."""
        img, boxes, masks, labels, _, _ = self._load_annotated(index)
        if boxes is None:
            return None
        out = train_aug(img, masks, boxes, labels, self.cfg.img_size, rnd)
        if out is None:
            return None
        img, masks, boxes, labels = out
        g = boxes.shape[0]
        if g > self.cfg.max_gt:
            keep = rnd.sample(range(g), self.cfg.max_gt)
            boxes, masks, labels = boxes[keep], masks[keep], labels[keep]
        proto, seg = downsample_mask_pyramid(masks, self.cfg.img_size)
        return dict(image=img, boxes=boxes, labels=labels, masks_proto=proto, masks_seg=seg)

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


def assemble_train_batch(samples: List[Optional[dict]], cfg: Config) -> Dict[str, np.ndarray]:
    """Pad each sample's gt to [B, max_gt, ...] with a validity mask; None
    entries (failed augmentations) are replaced by repeating valid samples,
    as the reference's collate does. Masks travel as uint8."""
    valid = [s for s in samples if s is not None]
    assert valid, 'Entire batch failed augmentation.'
    for i in range(len(samples) - len(valid)):
        valid.append(valid[i % len(valid)])
    b, g, s = len(valid), cfg.max_gt, cfg.img_size
    batch = dict(
        image=np.stack([v['image'] for v in valid]).astype(np.float32),
        boxes=np.zeros((b, g, 4), np.float32),
        labels=np.zeros((b, g), np.int32),
        valid=np.zeros((b, g), bool),
        masks_proto=np.zeros((b, g, s // 4, s // 4), np.uint8),
        masks_seg=np.zeros((b, g, s // 8, s // 8), np.uint8),
    )
    for i, v in enumerate(valid):
        n = v['boxes'].shape[0]
        batch['boxes'][i, :n] = v['boxes']
        batch['labels'][i, :n] = v['labels']
        batch['valid'][i, :n] = True
        batch['masks_proto'][i, :n] = v['masks_proto']
        batch['masks_seg'][i, :n] = v['masks_seg']
    return batch


# --- loader worker-process globals (spawn initializer) -----------------------
_worker_ds: Optional[COCODetection] = None


def _pool_init(cfg: Config):
    global _worker_ds
    _worker_ds = COCODetection(cfg, mode='train')


def _build_batch(ds: COCODetection, indices, seed_key: str) -> Dict[str, np.ndarray]:
    rnd = random.Random(seed_key)
    return assemble_train_batch([ds.get_train(int(i), rnd) for i in indices], ds.cfg)


def _pool_build(args):
    return _build_batch(_worker_ds, *args)


class TrainLoader:
    """Shuffled, sharded, prefetching iterator of train batches (numpy dicts).

    `batch_size` is the GLOBAL batch size: each of `process_count`
    processes yields its `batch_size / process_count` rows a step. Each
    epoch the indices are permuted by np.random.RandomState(seed + epoch)
    (the same in every process), sharded process_index::process_count, cut
    to the common per-process length and to whole batches, and built by a
    pool of `num_workers`
    spawned processes (`backend='process'`, the default for more than one
    worker: the augmentation holds the GIL) or threads, with num_workers +
    prefetch batches in flight; batch bi of epoch e draws from
    random.Random(f'{seed}-{e}-{bi}'). `close()` stops the pool."""

    def __init__(self, dataset: COCODetection, cfg: Config, batch_size: int,
                 num_workers: int = 8, seed: int = 0, process_index: int = 0,
                 process_count: int = 1, prefetch: int = 8, backend: Optional[str] = None):
        if batch_size % process_count:
            raise ValueError(f'global batch size {batch_size} must divide '
                             f'over {process_count} processes')
        self.ds = dataset
        self.cfg = cfg
        self.bs = batch_size // process_count          # this process's rows
        self.pidx, self.pcount = process_index, process_count
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.prefetch = prefetch
        self.epoch = 0
        self.backend = backend or ('process' if self.num_workers > 1 else 'thread')
        self._pool = None

    def _epoch_indices(self) -> np.ndarray:
        idx = np.random.RandomState(self.seed + self.epoch).permutation(len(self.ds))
        # the common per-process length: every process takes as many batches
        idx = idx[self.pidx::self.pcount][:len(idx) // self.pcount]
        n_batches = len(idx) // self.bs
        return idx[: n_batches * self.bs].reshape(n_batches, self.bs)

    def _get_pool(self):
        if self._pool is None:
            if self.backend == 'process':
                import multiprocessing as mp
                from concurrent.futures import ProcessPoolExecutor
                self._pool = ProcessPoolExecutor(
                    self.num_workers, mp_context=mp.get_context('spawn'),
                    initializer=_pool_init, initargs=(self.cfg,))
            else:
                from concurrent.futures import ThreadPoolExecutor
                self._pool = ThreadPoolExecutor(self.num_workers)
        return self._pool

    def _submit(self, pool, batch_indices, seed_key):
        if self.backend == 'process':
            return pool.submit(_pool_build, (batch_indices, seed_key))
        return pool.submit(_build_batch, self.ds, batch_indices, seed_key)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        self.epoch += 1
        plan = self._epoch_indices()
        pool = self._get_pool()
        window = self.num_workers + self.prefetch
        pending = deque(self._submit(pool, ix, f'{self.seed}-{self.epoch}-{bi}')
                        for bi, ix in enumerate(plan[:window]))
        for bi in range(len(plan)):
            batch = pending.popleft().result()
            nxt = bi + window
            if nxt < len(plan):
                pending.append(self._submit(pool, plan[nxt], f'{self.seed}-{self.epoch}-{nxt}'))
            yield batch

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    def __len__(self):
        return len(self._epoch_indices())
