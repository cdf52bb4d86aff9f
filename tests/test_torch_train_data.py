"""The port's training data path against the JAX package's: the same seed
gives the same augmented samples and the same padded batches, byte for
byte (cv2 does the colour conversions and resizes on both sides), and the
loader shuffles and seeds its epochs as the JAX TrainLoader does."""
import random

import numpy as np
import pytest
import torch

from yolact_minimal_tpu.config import get_config as jax_get_config
from yolact_minimal_tpu.data import augment as jax_augment
from yolact_minimal_tpu.data.coco import COCODetection as JaxCOCODetection
from yolact_minimal_tpu.data.coco import TrainLoader as JaxTrainLoader
from yolact_minimal_torch.config import get_config
from yolact_minimal_torch.data import augment
from yolact_minimal_torch.data.coco import COCODetection, TrainLoader, downsample_mask_pyramid

torch.set_num_threads(1)

IMG = 128
IMAGES = 8


def _datasets(img=IMG, max_gt=128):
    kw = dict(mode='train', img_size=img, max_gt=max_gt)
    ours = COCODetection(get_config('res50_custom', **kw), mode='train')
    ref = JaxCOCODetection(jax_get_config('res50_custom', **kw), mode='train')
    assert ours.ids == ref.ids and len(ours) == 48
    ours.ids, ref.ids = ours.ids[:IMAGES], ref.ids[:IMAGES]
    return ours, ref


def _equal(a: dict, b: dict, what):
    assert a.keys() == b.keys(), what
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, f'{what} {k}'
        assert np.array_equal(x, y), f'{what} {k}'


def test_train_loader_batches_are_the_jax_loaders_bytes():
    ours, ref = _datasets()
    kw = dict(batch_size=4, num_workers=2, seed=0, backend='thread')
    lo = TrainLoader(ours, ours.cfg, **kw)
    lr = JaxTrainLoader(ref, ref.cfg, **kw)
    try:
        for epoch in range(2):                   # epoch 2 reshuffles with its own seeds
            got, want = list(lo), list(lr)
            assert len(got) == len(want) == 2
            for i, (a, b) in enumerate(zip(got, want)):
                _equal(a, b, f'epoch {epoch} batch {i}')
                assert a['valid'].any(1).all()
    finally:
        lo.close()
        lr.close()


@pytest.mark.parametrize('seed', range(6))
def test_get_train_samples_equal_jax(seed):
    """One sample at a time through both pipelines, max_gt 2 so that the
    capacity subsample draws too; None (a failed augmentation) on both
    sides or on neither."""
    ours, ref = _datasets(max_gt=2)
    for index in range(IMAGES):
        a = ours.get_train(index, random.Random(f'{seed}-{index}'))
        b = ref.get_train(index, random.Random(f'{seed}-{index}'))
        assert (a is None) == (b is None)
        if a is not None:
            _equal(a, b, f'seed {seed} image {index}')
            assert a['boxes'].shape[0] <= 2


def test_augment_steps_equal_jax():
    rng = np.random.RandomState(0)
    img = rng.uniform(0, 255, size=(60, 90, 3)).astype(np.float32)
    masks = (rng.rand(3, 60, 90) > 0.5).astype(np.float32)
    boxes = np.array([[5, 5, 40, 30], [20, 10, 80, 55], [0, 0, 89, 59]], np.float32)
    labels = np.array([0, 1, 2], np.int32)
    for fn, args in ((augment.photometric_distort, (img,)),
                     (augment.random_mirror, (img, masks, boxes)),
                     (augment.random_crop, (img, masks, boxes, labels)),
                     (augment.pad_to_square_train, (img, masks, boxes)),
                     (augment.multi_scale_resize, (img[:60, :60], masks[:, :60, :60], boxes)),
                     (augment.fit_to_size, (img[:60, :60], masks[:, :60, :60], boxes, labels, 96)),
                     (augment.fit_to_size, (img[:60, :60], masks[:, :60, :60], boxes, labels, 32))):
        for seed in range(4):
            got = fn(*args, random.Random(seed))
            want = getattr(jax_augment, fn.__name__)(*args, random.Random(seed))
            got, want = (got if isinstance(got, tuple) else (got,),
                         want if isinstance(want, tuple) else (want,))
            for x, y in zip(got, want):
                assert (x is None) == (y is None)
                if x is not None:
                    assert np.array_equal(np.asarray(x), np.asarray(y)), fn.__name__


def test_downsample_mask_pyramid_equals_jax():
    from yolact_minimal_tpu.data.coco import downsample_mask_pyramid as jax_pyramid
    masks = (np.random.RandomState(1).rand(3, IMG, IMG) > 0.5).astype(np.float32)
    for x, y in zip(downsample_mask_pyramid(masks, IMG), jax_pyramid(masks, IMG)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
