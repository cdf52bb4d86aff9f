"""The port's numpy postprocess (the exported-artifact driver's host tail,
`ops/nms_numpy.py` and the numpy helpers of `ops/boxes.py`) against the JAX
package's own numpy postprocess on the same seeded raw outputs: every result
equal. Then against the port's device postprocess, `ops/nms.py`, on the CPU:
the same number of detections and sorted scores within 1e-5 (the two decode
and sort with other libraries, in float32)."""
import numpy as np
import pytest
import torch

from yolact_minimal_tpu.ops import boxes as jax_boxes
from yolact_minimal_tpu.ops import nms_numpy as jax_nms
from yolact_minimal_torch.ops import boxes, nms_numpy
from yolact_minimal_torch.ops.nms import detect_postprocess_batch

torch.set_num_threads(1)

IMG = 128
ANCHORS = boxes.make_anchors(IMG, (1.0, 0.5, 2.0), (24, 48, 96, 192, 384))
SCORE_TOL = 1e-5


def _raw(seed, sharp=4.0):
    """One image's raw outputs: softmaxed class scores [A, 81] (logits scaled
    by `sharp`, so that some anchors pass the score threshold), box offsets,
    coefficients and a prototype map [IMG/4, IMG/4, 32]."""
    rng = np.random.RandomState(seed)
    a = len(ANCHORS)
    logits = rng.randn(a, 81).astype(np.float32) * sharp
    e = np.exp(logits - logits.max(1, keepdims=True))
    class_p = (e / e.sum(1, keepdims=True)).astype(np.float32)
    box_p = (rng.randn(a, 4) * 0.5).astype(np.float32)
    coef_p = np.tanh(rng.randn(a, 32)).astype(np.float32)
    proto = np.maximum(rng.randn(IMG // 4, IMG // 4, 32), 0).astype(np.float32)
    return class_p, box_p, coef_p, proto


def test_box_helpers_equal_jax():
    rng = np.random.RandomState(0)
    a = np.sort(rng.rand(3, 7, 4).astype(np.float32).reshape(3, 7, 2, 2), axis=2).reshape(3, 7, 4)
    b = np.sort(rng.rand(3, 5, 4).astype(np.float32).reshape(3, 5, 2, 2), axis=2).reshape(3, 5, 4)
    np.testing.assert_array_equal(boxes.box_iou_numpy(a, b), jax_boxes.box_iou_numpy(a, b))
    x1, x2 = rng.rand(9).astype(np.float32), rng.rand(9).astype(np.float32)
    for ours, ref in zip(boxes.sanitize_coordinates_numpy(x1, x2, 32, 1),
                         jax_boxes.sanitize_coordinates_numpy(x1, x2, 32, 1)):
        np.testing.assert_array_equal(ours, ref)
    masks = rng.rand(16, 24, 5).astype(np.float32)
    np.testing.assert_array_equal(boxes.crop_numpy(masks, a[0, :5]),
                                  jax_boxes.crop_numpy(masks, a[0, :5]))
    offsets = rng.randn(len(ANCHORS), 4).astype(np.float32)
    for clip in (True, False):
        np.testing.assert_array_equal(boxes.decode_numpy(offsets, ANCHORS, clip),
                                      jax_boxes.decode_numpy(offsets, ANCHORS, clip))


@pytest.mark.parametrize('seed', [0, 1, 2])
@pytest.mark.parametrize('visual_thre,do_crop', [(None, True), (0.3, True), (0.3, False)])
def test_numpy_tail_equals_jax(seed, visual_thre, do_crop):
    class_p, box_p, coef_p, proto = _raw(seed)
    args = (class_p, box_p, coef_p, ANCHORS, 0.05, 0.5, 200, 100)
    ours, ref = nms_numpy.detect_postprocess_numpy(*args), jax_nms.detect_postprocess_numpy(*args)
    assert len(ours[0]) > 20                        # detections to compare
    for name, o, r in zip(('boxes', 'coefs', 'ids', 'scores'), ours, ref):
        assert o.dtype == r.dtype, name
        np.testing.assert_array_equal(o, r, err_msg=name)
    boxes_, coefs, ids, scores = ours
    h, w = (100, 160) if seed % 2 else (150, 90)
    kw = dict(visual_thre=visual_thre, do_crop=do_crop)
    tail = nms_numpy.after_nms_numpy(ids, scores, boxes_, coefs, proto, h, w, **kw)
    jax_tail = jax_nms.after_nms_numpy(ids, scores, boxes_, coefs, proto, h, w, **kw)
    for name, o, r in zip(('ids', 'scores', 'pixel boxes', 'masks'), tail, jax_tail):
        assert o.dtype == r.dtype and o.shape == r.shape, name
        np.testing.assert_array_equal(o, r, err_msg=name)
    assert tail[3].shape[1:] == (h, w) and tail[3].any()


def test_numpy_tail_empty_cases_equal_jax():
    class_p, box_p, coef_p, proto = _raw(3, sharp=0.0)          # every score 1/81
    args = (class_p, box_p, coef_p, ANCHORS, 0.05, 0.5, 200, 100)
    assert nms_numpy.detect_postprocess_numpy(*args) == (None, None, None, None)
    assert jax_nms.detect_postprocess_numpy(*args) == (None, None, None, None)
    empty = nms_numpy.after_nms_numpy(None, None, None, None, proto, 40, 50)
    for o, r in zip(empty, jax_nms.after_nms_numpy(None, None, None, None, proto, 40, 50)):
        assert o.dtype == r.dtype and o.shape == r.shape
    boxes_, coefs, ids, scores = nms_numpy.detect_postprocess_numpy(*_raw(0)[:3], ANCHORS, 0.05,
                                                                    0.5, 200, 100)
    above = nms_numpy.after_nms_numpy(ids, scores, boxes_, coefs, proto, 40, 50, visual_thre=2.0)
    assert [t.shape for t in above] == [(0,), (0,), (0, 4), (0, 40, 50)]


@pytest.mark.parametrize('seed', [0, 1, 2, 3])
def test_numpy_tail_matches_device_postprocess(seed):
    """The check of the JAX package's test_numpy_postprocess_matches_device:
    the numpy tail and the batched postprocess on the same outputs."""
    class_p, box_p, coef_p, proto = _raw(seed)
    _, _, _, scores = nms_numpy.detect_postprocess_numpy(class_p, box_p, coef_p, ANCHORS,
                                                         0.05, 0.5, 200, 100)
    dets = detect_postprocess_batch(*(torch.from_numpy(t)[None] for t in (class_p, box_p, coef_p)),
                                    torch.from_numpy(ANCHORS), 0.05, 0.5, 200, 100)
    n_valid = int(dets.valid.sum())
    assert n_valid == len(scores) > 20
    np.testing.assert_allclose(np.sort(dets.scores[0, :n_valid].numpy()), np.sort(scores),
                               rtol=0, atol=SCORE_TOL)
