"""The port's detect pipeline against the JAX package: the batched
postprocess on the same head outputs, and Detector.__call__ / detect_fixed /
postprocess_host on one set of bridged weights."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolact_minimal_tpu.config import get_config as jax_config
from yolact_minimal_tpu.models.yolact import Yolact as JaxYolact
from yolact_minimal_tpu.ops.boxes import make_anchors
from yolact_minimal_tpu.ops.nms import detect_postprocess_batch as jax_postprocess
from yolact_minimal_tpu.pipeline import Detector as JaxDetector
from yolact_minimal_torch.config import get_config
from yolact_minimal_torch.ops.nms import detect_postprocess, detect_postprocess_batch
from yolact_minimal_torch.pipeline import Detector
from yolact_minimal_torch.utils.weights import from_jax_variables

torch.set_num_threads(1)

# Boxes and scores: decode's exp may differ by an ulp between libms.
ATOL = 1e-6
# Masks after an upsample: pixels within rounding of 0.5 may flip.
MISMATCH = 1e-4


def _head_outputs(rng, b, img_size, quantize=False):
    anchors = make_anchors(img_size, (1.0, 0.5, 2.0),
                           tuple(int(img_size / 544 * s) for s in (24, 48, 96, 192, 384)))
    a = len(anchors)
    logits = rng.normal(scale=3.0, size=(b, a, 81))
    if quantize:                    # many exactly equal scores: tie order matters
        logits = np.round(logits)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    class_p = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    if quantize:
        class_p = np.round(class_p * 50) / 50
    box_p = rng.normal(scale=0.5, size=(b, a, 4)).astype(np.float32)
    coef_p = np.tanh(rng.normal(size=(b, a, 32))).astype(np.float32)
    return class_p.astype(np.float32), box_p, coef_p, anchors


def _assert_slates_equal(ours, ref):
    np.testing.assert_array_equal(ours.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(ours.ids.numpy(), np.asarray(ref.ids))
    np.testing.assert_allclose(ours.scores.numpy(), np.asarray(ref.scores), rtol=0, atol=ATOL)
    np.testing.assert_allclose(ours.boxes.numpy(), np.asarray(ref.boxes), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(ours.coefs.numpy(), np.asarray(ref.coefs))


@pytest.mark.parametrize('pre_topk,thre,quantize', [
    (256, 0.05, False),     # max-class preselect, then per-class top-k
    (0, 0.05, False),       # preselect off
    (4096, 0.05, False),    # cap above the anchor count: off as well
    (256, 0.6, False),      # few candidates: NEG_INF fills the lists
    (256, 0.05, True),      # exact ties everywhere
])
def test_postprocess_matches_jax(rng, pre_topk, thre, quantize):
    class_p, box_p, coef_p, anchors = _head_outputs(rng, 2, 128, quantize)
    args = (thre, 0.5, 50, 100, pre_topk)
    ref = jax_postprocess(jnp.asarray(class_p), jnp.asarray(box_p), jnp.asarray(coef_p),
                          jnp.asarray(anchors), *args)
    ours = detect_postprocess_batch(torch.from_numpy(class_p), torch.from_numpy(box_p),
                                    torch.from_numpy(coef_p), torch.from_numpy(anchors),
                                    *args)
    assert ours.valid.any()
    _assert_slates_equal(ours, ref)
    one = detect_postprocess(torch.from_numpy(class_p[1]), torch.from_numpy(box_p[1]),
                             torch.from_numpy(coef_p[1]), torch.from_numpy(anchors), *args)
    for a, b in zip(one, ours):
        assert torch.equal(a, b[1])


IMG = 64
CFG_OVERRIDES = dict(img_size=IMG, nms_pre_topk=128)


@pytest.fixture(scope='module')
def detectors():
    """JAX and port Detectors on one random init. conf_layer is scaled x20
    so the softmax scores separate: with the raw init they sit near 1/81 and
    reorder under float noise."""
    cfg = jax_config('res50_coco', **CFG_OVERRIDES)
    init = jax.jit(lambda key: JaxYolact(cfg=cfg).init(
        key, jnp.zeros((1, IMG, IMG, 3), jnp.float32), train=False))
    v = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(1)))
    v['params']['prediction_layers']['conf_layer']['kernel'] = \
        v['params']['prediction_layers']['conf_layer']['kernel'] * 20
    jdet = JaxDetector(cfg, v, static_weights=False)
    det = Detector(get_config('res50_coco', **CFG_OVERRIDES), from_jax_variables(v),
                   device='cpu')
    images = np.random.RandomState(2).normal(size=(2, IMG, IMG, 3)).astype(np.float32)
    return jdet, det, images


def test_call_matches_jax(detectors):
    jdet, det, images = detectors
    ref, ref_masks, ref_proto = jdet(jnp.asarray(images))
    ours, masks, proto = det(images)
    assert ours.valid.sum() > 10
    _assert_slates_equal_loose(ours, ref)
    np.testing.assert_allclose(proto.numpy(), np.asarray(ref_proto), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(ref_proto)).max())
    np.testing.assert_allclose(masks.numpy(), np.asarray(ref_masks), rtol=0, atol=1e-4)


def _assert_slates_equal_loose(ours, ref):
    """Slates from two forward passes: the network's float noise (~1e-6 of
    each output's scale) reaches scores, boxes and coefs."""
    np.testing.assert_array_equal(ours.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(ours.ids.numpy(), np.asarray(ref.ids))
    np.testing.assert_allclose(ours.scores.numpy(), np.asarray(ref.scores), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ours.boxes.numpy(), np.asarray(ref.boxes), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ours.coefs.numpy(), np.asarray(ref.coefs), rtol=0, atol=1e-5)


def test_detect_fixed_matches_jax(detectors):
    jdet, det, images = detectors
    ref, ref_masks = jdet.detect_fixed(jnp.asarray(images), IMG)
    ours, masks = det.detect_fixed(images, IMG)
    _assert_slates_equal_loose(ours, ref)
    assert masks.dtype == torch.bool and masks.shape == (2, 100, IMG, IMG)
    assert np.asarray(ref_masks).any()
    assert (masks.numpy() != np.asarray(ref_masks)).mean() < MISMATCH


@pytest.mark.parametrize('img_h,img_w', [(48, 64), (64, 40)])
def test_postprocess_host_matches_jax(detectors, img_h, img_w):
    # cv2.resize(INTER_LINEAR) in the JAX package, F.interpolate (bilinear,
    # align_corners=False, the same half-pixel formula) in the port
    jdet, det, images = detectors
    ref, ref_masks, _ = jdet(jnp.asarray(images))
    ours, masks, _ = det(images)
    r = jdet.postprocess_host(type(ref)(*(x[0] for x in ref)), ref_masks[0],
                              img_h, img_w, visual_thre=0.1)
    o = det.postprocess_host(type(ours)(*(x[0] for x in ours)), masks[0],
                             img_h, img_w, visual_thre=0.1)
    assert len(o[0]) > 0
    np.testing.assert_array_equal(o[0], r[0])
    np.testing.assert_allclose(o[1], r[1], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(o[2], r[2])
    assert o[3].shape == r[3].shape == (len(r[0]), img_h, img_w)
    assert (o[3] != r[3]).mean() < MISMATCH
