"""Port geometry (yolact_minimal_torch.ops.boxes / ops.resize) against the
JAX package on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolact_minimal_tpu.ops import boxes as jboxes
from yolact_minimal_tpu.ops import resize as jresize
from yolact_minimal_torch.ops import boxes as tboxes
from yolact_minimal_torch.ops import resize as tresize

torch.set_num_threads(1)

# Elementwise float32 ops in the same order on both sides: equal up to
# libm differences in exp (a few ulp).
ATOL = 1e-6


def _rand_boxes(rng, *shape):
    xy = rng.uniform(0, 0.8, size=shape + (2,)).astype(np.float32)
    wh = rng.uniform(0.0, 0.4, size=shape + (2,)).astype(np.float32)
    return np.concatenate([xy, xy + wh], axis=-1)


def test_make_anchors_matches_at_544():
    cfg_scales = tuple(int(544 / 544 * s) for s in (24, 48, 96, 192, 384))
    ours = tboxes.make_anchors(544, (1.0, 0.5, 2.0), cfg_scales)
    ref = jboxes.make_anchors(544, (1.0, 0.5, 2.0), cfg_scales)
    assert ours.shape == (18525, 4)
    np.testing.assert_array_equal(ours, ref)


def test_box_iou(rng):
    a, b = _rand_boxes(rng, 2, 7), _rand_boxes(rng, 2, 9)
    ref = np.asarray(jboxes.box_iou(jnp.asarray(a), jnp.asarray(b)))
    ours = tboxes.box_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert ours.shape == (2, 7, 9)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize('clip', [True, False])
def test_decode(rng, clip):
    offsets = rng.normal(scale=2.0, size=(3, 50, 4)).astype(np.float32)
    anchors = np.abs(rng.uniform(0.05, 0.9, size=(50, 4))).astype(np.float32)
    ref = np.asarray(jboxes.decode(jnp.asarray(offsets), jnp.asarray(anchors), clip))
    ours = tboxes.decode(torch.from_numpy(offsets), torch.from_numpy(anchors), clip).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=ATOL)


@pytest.mark.parametrize('padding', [0, 1])
def test_sanitize_coordinates(rng, padding):
    x1 = rng.uniform(-0.2, 1.2, size=40).astype(np.float32)
    x2 = rng.uniform(-0.2, 1.2, size=40).astype(np.float32)
    ref = jboxes.sanitize_coordinates(jnp.asarray(x1), jnp.asarray(x2), 136, padding)
    ours = tboxes.sanitize_coordinates(torch.from_numpy(x1), torch.from_numpy(x2),
                                       136, padding)
    for r, o in zip(ref, ours):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_crop(rng):
    masks = rng.uniform(size=(24, 20, 6)).astype(np.float32)
    boxes = _rand_boxes(rng, 6)
    ref = np.asarray(jboxes.crop(jnp.asarray(masks), jnp.asarray(boxes)))
    ours = tboxes.crop(torch.from_numpy(masks), torch.from_numpy(boxes)).numpy()
    np.testing.assert_array_equal(ours, ref)
    # batched form: each image cropped by its own boxes
    both = tboxes.crop(torch.from_numpy(np.stack([masks, masks])),
                       torch.from_numpy(np.stack([boxes, boxes[::-1]]))).numpy()
    np.testing.assert_array_equal(both[0], ref)
    np.testing.assert_array_equal(
        both[1], np.asarray(jboxes.crop(jnp.asarray(masks), jnp.asarray(boxes[::-1]))))


@pytest.mark.parametrize('in_size,out_size,align', [
    (17, 34, False), (68, 136, True), (136, 544, False), (13, 50, True), (1, 4, False)])
def test_resize_tables(in_size, out_size, align):
    np.testing.assert_array_equal(tresize._interp_matrix(in_size, out_size, align),
                                  jresize._interp_matrix(in_size, out_size, align))
    for ours, ref in zip(tresize._gather_lerp(in_size, out_size, align),
                         jresize._gather_lerp(in_size, out_size, align)):
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize('align', [False, True])
def test_resize_bilinear_nchw(rng, align):
    # F.interpolate (port) vs the JAX interpolation-matrix einsum (NHWC):
    # the same two taps and weights, summed in another order.
    x = rng.normal(size=(2, 9, 11, 5)).astype(np.float32)
    ref = np.asarray(jresize.resize_bilinear(jnp.asarray(x), 18, 22, align))
    ours = tresize.resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2),
                                   18, 22, align).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize('align', [False, True])
def test_resize_hw_last(rng, align):
    x = rng.normal(size=(3, 16, 12)).astype(np.float32)
    ref = np.asarray(jresize.resize_bilinear_hw_last(jnp.asarray(x), 64, 48, align))
    ours = tresize.resize_bilinear_hw_last(torch.from_numpy(x), 64, 48, align).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
