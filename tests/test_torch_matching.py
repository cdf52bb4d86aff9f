"""The port's anchor matcher against the JAX package's on the same padded gt:
conf, the matched index and the matched box exactly; the encoded offsets
within 2 ulp-scale (1e-6 relative), since log and division round in
another library."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from yolact_minimal_tpu.ops import boxes as jax_boxes
from yolact_minimal_tpu.ops.matching import match as jax_match
from yolact_minimal_torch.ops.boxes import encode, make_anchors
from yolact_minimal_torch.ops.matching import match

torch.set_num_threads(1)

IMG = 128
ANCHORS = make_anchors(IMG, (1.0, 0.5, 2.0), tuple(int(IMG / 544 * s) for s in (24, 48, 96, 192, 384)))


def _random_gt(rng, b, g, n_valid, lo=0.15, hi=0.6):
    xy1 = rng.uniform(0, 0.4, size=(b, g, 2)).astype(np.float32)
    wh = rng.uniform(lo, hi, size=(b, g, 2)).astype(np.float32)
    boxes = np.concatenate([xy1, np.minimum(xy1 + wh, 1.0)], 2)
    labels = rng.randint(0, 4, size=(b, g)).astype(np.int32)
    valid = np.zeros((b, g), bool)
    for i, n in enumerate(n_valid):
        valid[i, :n] = True
    boxes[~valid] = rng.uniform(size=(int((~valid).sum()), 4))     # padded rows: garbage
    return boxes, labels, valid


def _both(boxes, labels, valid, pos=0.5, neg=0.4):
    ours = match(torch.from_numpy(boxes), torch.from_numpy(labels), torch.from_numpy(valid),
                 torch.from_numpy(ANCHORS), pos, neg)
    ref = jax_match(jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(valid),
                    jnp.asarray(ANCHORS), pos, neg)
    return ours, ref


def _hold(ours, ref):
    np.testing.assert_array_equal(ours.conf_gt.numpy(), np.asarray(ref.conf_gt))
    np.testing.assert_array_equal(ours.anchor_max_i.numpy(), np.asarray(ref.anchor_max_i))
    np.testing.assert_array_equal(ours.anchor_max_gt.numpy(), np.asarray(ref.anchor_max_gt))
    np.testing.assert_allclose(ours.offsets.numpy(), np.asarray(ref.offsets), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize('n_valid', [(12, 3, 1), (12, 12, 12), (2, 0, 7)])
def test_match_equals_jax_with_padded_rows(n_valid):
    rng = np.random.RandomState(sum(n_valid))
    boxes, labels, valid = _random_gt(rng, 3, 12, n_valid)
    ours, ref = _both(boxes, labels, valid)
    _hold(ours, ref)
    conf = ours.conf_gt.numpy()
    assert (conf > 0).any() and (conf == 0).any() and (conf == -1).any()
    # an image without gt matches nothing
    for i, n in enumerate(n_valid):
        if n == 0:
            assert (conf[i] == 0).all()


def test_two_gts_claiming_one_anchor_go_to_the_larger_index():
    rng = np.random.RandomState(3)
    boxes, labels, valid = _random_gt(rng, 2, 5, (5, 5))
    boxes[:, 3] = boxes[:, 1]                    # gt 3 duplicates gt 1: one best anchor
    labels[:, 1], labels[:, 3] = 0, 2
    ours, ref = _both(boxes, labels, valid)
    _hold(ours, ref)
    dec = jax_boxes.box_iou(jnp.asarray(boxes[0, 1:2]), jnp.asarray(np.concatenate(
        [ANCHORS[:, :2] - ANCHORS[:, 2:] / 2, ANCHORS[:, :2] + ANCHORS[:, 2:] / 2], 1)))
    best = int(np.argmax(np.asarray(dec)[0]))
    assert int(ours.anchor_max_i[0, best]) == 3 and int(ours.conf_gt[0, best]) == 3


def test_no_gt_above_the_threshold_leaves_only_forced_matches():
    rng = np.random.RandomState(5)
    boxes, labels, valid = _random_gt(rng, 2, 4, (4, 2), lo=0.004, hi=0.01)
    ours, ref = _both(boxes, labels, valid)
    _hold(ours, ref)
    # tiny boxes reach IoU 0.4 with no anchor: the positives are the forced ones,
    # at most one a gt, and nothing is neutral
    conf = ours.conf_gt.numpy()
    assert ((conf > 0).sum(1) <= valid.sum(1)).all() and (conf > 0).sum() > 0
    assert not (conf == -1).any()


def test_encode_equals_jax():
    rng = np.random.RandomState(7)
    boxes, _, _ = _random_gt(rng, 1, 50, (50,))
    matched = boxes[0, np.arange(len(ANCHORS)) % 50]
    ours = encode(torch.from_numpy(matched), torch.from_numpy(ANCHORS)).numpy()
    ref = np.asarray(jax_boxes.encode(jnp.asarray(matched), jnp.asarray(ANCHORS)))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)
