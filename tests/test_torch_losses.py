"""The port's four losses and compute_loss against the JAX package's on the
same seeded outputs and gt: each value within 1e-5 relative, and the
gradients of the total with respect to the five network outputs within
1e-5 of jax.grad (relative to each output's largest gradient). Both sum
float32 in another order, which moves a sum of ~1e3 terms by ~1e-7
relative. The lincomb subsample is random in both: its case num_pos <= K
holds exactly, and num_pos > K feeds the port the JAX package's own draw.
OHEM ranks need tie-free scores: every row is drawn independently."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yolact_minimal_tpu.ops import losses as JL
from yolact_minimal_tpu.ops.matching import match as jax_match
from yolact_minimal_torch.config import get_config
from yolact_minimal_torch.ops import losses as L
from yolact_minimal_torch.ops.boxes import make_anchors
from yolact_minimal_torch.ops.matching import match

torch.set_num_threads(1)

IMG = 128
CFG = get_config('res50_custom', mode='train', img_size=IMG, max_gt=8)
ANCHORS = make_anchors(IMG, CFG.aspect_ratios, CFG.scales)
RTOL = 1e-5


def _case(seed=0, b=2, g=8, n_valid=(8, 5)):
    rng = np.random.RandomState(seed)
    a, c = len(ANCHORS), CFG.num_classes
    ph, sh = IMG // 4, IMG // 8
    xy1 = rng.uniform(0, 0.5, size=(b, g, 2)).astype(np.float32)
    wh = rng.uniform(0.15, 0.45, size=(b, g, 2)).astype(np.float32)
    valid = np.zeros((b, g), bool)
    for i, n in enumerate(n_valid):
        valid[i, :n] = True
    gt = dict(boxes=np.concatenate([xy1, xy1 + wh], 2),
              labels=rng.randint(0, c - 1, size=(b, g)).astype(np.int32), valid=valid,
              masks_proto=(rng.rand(b, g, ph, ph) > 0.5).astype(np.uint8),
              masks_seg=(rng.rand(b, g, sh, sh) > 0.5).astype(np.uint8))
    outputs = (rng.normal(size=(b, a, c)).astype(np.float32),
               rng.normal(scale=0.5, size=(b, a, 4)).astype(np.float32),
               np.tanh(rng.normal(size=(b, a, 32))).astype(np.float32),
               np.maximum(rng.normal(size=(b, ph, ph, 32)), 0).astype(np.float32),
               rng.normal(size=(b, sh, sh, c - 1)).astype(np.float32))
    return outputs, gt


def _torch(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _matches(gt):
    ours = match(*(torch.from_numpy(gt[k]) for k in ('boxes', 'labels', 'valid')),
                 torch.from_numpy(ANCHORS), CFG.pos_iou_thre, CFG.neg_iou_thre)
    ref = jax_match(*(jnp.asarray(gt[k]) for k in ('boxes', 'labels', 'valid')),
                    jnp.asarray(ANCHORS), CFG.pos_iou_thre, CFG.neg_iou_thre)
    return ours, ref


def _close(ours, ref):
    np.testing.assert_allclose(float(ours.detach()), float(ref), rtol=RTOL)


def test_category_and_box_loss_equal_jax():
    outputs, gt = _case(1)
    ours, ref = _matches(gt)
    assert int((ours.conf_gt > 0).sum()) > 0
    _close(L.category_loss(torch.from_numpy(outputs[0]), ours.conf_gt, CFG.conf_alpha),
           JL.category_loss(jnp.asarray(outputs[0]), ref.conf_gt, CFG.conf_alpha))
    _close(L.box_loss(torch.from_numpy(outputs[1]), ours.offsets, ours.conf_gt > 0,
                      CFG.bbox_alpha),
           JL.box_loss(jnp.asarray(outputs[1]), ref.offsets, ref.conf_gt > 0, CFG.bbox_alpha))


@pytest.mark.parametrize('masks_to_train', [100, 3])
def test_lincomb_mask_loss_equals_jax(masks_to_train):
    """K = 100 keeps every positive (num_pos <= K, any draw); K = 3
    subsamples, and the port gets the priorities JAX draws from its key."""
    outputs, gt = _case(2)
    ours, ref = _matches(gt)
    pos = ours.conf_gt > 0
    num_pos = pos.sum(1)
    assert (num_pos <= 100).all() and (num_pos > masks_to_train).any() == (masks_to_train < 100)
    key = jax.random.PRNGKey(4)
    priorities = np.stack([np.asarray(jax.random.uniform(k, (len(ANCHORS),)))
                           for k in jax.random.split(key, pos.shape[0])])
    got = L.lincomb_mask_loss(pos, ours.anchor_max_i, torch.from_numpy(outputs[2]),
                              torch.from_numpy(outputs[3]), torch.from_numpy(gt['masks_proto']),
                              ours.anchor_max_gt, CFG.mask_alpha, masks_to_train,
                              priorities=torch.from_numpy(priorities))
    want = JL.lincomb_mask_loss(ref.conf_gt > 0, ref.anchor_max_i, jnp.asarray(outputs[2]),
                                jnp.asarray(outputs[3]), jnp.asarray(gt['masks_proto']),
                                ref.anchor_max_gt, key, CFG.mask_alpha, masks_to_train)
    _close(got, want)


def test_lincomb_subsample_draws_all_positives_or_a_k_subset():
    outputs, gt = _case(2)
    ours, _ = _matches(gt)
    pos = ours.conf_gt > 0
    args = (pos, ours.anchor_max_i, torch.from_numpy(outputs[2]), torch.from_numpy(outputs[3]),
            torch.from_numpy(gt['masks_proto']), ours.anchor_max_gt, CFG.mask_alpha)
    full = L.lincomb_mask_loss(*args, 100, generator=torch.Generator().manual_seed(0))
    again = L.lincomb_mask_loss(*args, 100, generator=torch.Generator().manual_seed(9))
    torch.testing.assert_close(full, again, rtol=1e-6, atol=0)       # all positives: no draw
    subs = [float(L.lincomb_mask_loss(*args, 3, generator=torch.Generator().manual_seed(s)))
            for s in range(6)]
    assert len(set(subs)) > 1                                         # a K-subset: draws differ


def test_semantic_seg_loss_equals_jax():
    outputs, gt = _case(3)
    gt['labels'][0, :3] = 1                       # overlapping masks of one class: the max
    _close(L.semantic_seg_loss(torch.from_numpy(outputs[4]), torch.from_numpy(gt['masks_seg']),
                               torch.from_numpy(gt['labels']), torch.from_numpy(gt['valid']),
                               CFG.semantic_alpha),
           JL.semantic_seg_loss(jnp.asarray(outputs[4]), jnp.asarray(gt['masks_seg']),
                                jnp.asarray(gt['labels']), jnp.asarray(gt['valid']),
                                CFG.semantic_alpha))


@pytest.mark.parametrize('seed', [0, 5])
def test_compute_loss_and_its_gradients_equal_jax(seed):
    outputs, gt = _case(seed)
    anchors = torch.from_numpy(ANCHORS)
    t_out = [torch.from_numpy(o).requires_grad_() for o in outputs]
    ours = L.compute_loss(CFG, t_out, _torch(gt), anchors,
                          generator=torch.Generator().manual_seed(0))
    assert int((match(*(torch.from_numpy(gt[k]) for k in ('boxes', 'labels', 'valid')),
                      anchors, 0.5, 0.4).conf_gt > 0).sum(1).max()) <= CFG.masks_to_train
    ours.total.backward()

    def total(*outs):
        return JL.compute_loss(CFG, outs, _jax(gt), jnp.asarray(ANCHORS),
                               jax.random.PRNGKey(1)).total

    ref = JL.compute_loss(CFG, [jnp.asarray(o) for o in outputs], _jax(gt),
                          jnp.asarray(ANCHORS), jax.random.PRNGKey(1))
    for got, want in zip(ours, ref):
        _close(got, want)
    grads = jax.grad(total, argnums=tuple(range(5)))(*(jnp.asarray(o) for o in outputs))
    for t, g in zip(t_out, grads):
        g = np.asarray(g)
        scale = float(np.abs(g).max())
        assert scale > 0
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=RTOL, atol=RTOL * scale)


def test_lincomb_grads_finite_with_cropped_zeros():
    """As tests/test_loss_gradients.py: crop() zeroes most of the mask, and
    the gradients stay finite."""
    rng = np.random.RandomState(0)
    b, a, g, ph = 1, 50, 4, 16
    pos = torch.from_numpy(rng.uniform(size=(b, a)) > 0.7)
    anchor_max_i = torch.from_numpy(rng.randint(0, g, size=(b, a)))
    boxes = torch.tensor([[0.3, 0.3, 0.5, 0.5]]).expand(b, a, 4)
    coef = torch.from_numpy(np.tanh(rng.normal(size=(b, a, 32))).astype(np.float32)).requires_grad_()
    proto = torch.from_numpy(rng.normal(size=(b, ph, ph, 32)).astype(np.float32)).requires_grad_()
    masks = torch.from_numpy((rng.uniform(size=(b, g, ph, ph)) > 0.5).astype(np.float32))
    loss = L.lincomb_mask_loss(pos, anchor_max_i, coef, proto, masks, boxes, 6.125, 100,
                               generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(loss)
    loss.backward()
    assert torch.isfinite(coef.grad).all() and torch.isfinite(proto.grad).all()


def test_log_clamped_values_and_grads():
    x = torch.tensor([0.0, 1e-45, 1e-20, 0.5, 1.0], requires_grad=True)
    y = L._log_clamped(x)
    assert float(y[0]) == -100.0 and float(y[3]) == np.float32(np.log(0.5))
    np.testing.assert_array_equal(y.detach().numpy(),
                                  np.asarray(JL._log_clamped(jnp.asarray(x.detach().numpy()))))
    y.sum().backward()
    assert torch.isfinite(x.grad).all()
    np.testing.assert_allclose(float(x.grad[3]), 2.0, rtol=1e-5)
    assert float(x.grad[0]) == 0.0
