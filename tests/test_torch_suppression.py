"""The suppression kernel's plain PyTorch version against the JAX package's
Pallas kernel (interpret mode) and its XLA form, NaN positions included."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolact_minimal_tpu.ops.nms import _plane_iou
from yolact_minimal_tpu.ops.pallas_nms import suppression_iou_max as pallas_iou_max
from yolact_minimal_torch.ops.suppression import (suppression_iou_max,
                                                  suppression_iou_max_plain)

torch.set_num_threads(1)


def _xla_iou_max(x1, y1, x2, y2, valid):
    iou = _plane_iou(x1, y1, x2, y2)
    iou = jnp.where(valid[:, None, :] & valid[:, :, None], iou, 0.0)
    return jnp.max(jnp.triu(iou, k=1), axis=1)


def _planes(rng, rows, k):
    """Random candidates with clipped zero-area boxes (x1 == x2 == 1), whole
    invalid rows and scattered invalid slots."""
    xy = rng.uniform(0, 0.8, size=(2, rows, k)).astype(np.float32)
    wh = rng.uniform(0.02, 0.4, size=(2, rows, k)).astype(np.float32)
    x1, y1 = xy
    x2, y2 = np.minimum(x1 + wh[0], 1), np.minimum(y1 + wh[1], 1)
    flat = rng.uniform(size=(rows, k)) < 0.05
    x1[flat], x2[flat], y1[flat], y2[flat] = 1.0, 1.0, 1.0, 1.0
    valid = rng.uniform(size=(rows, k)) > 0.2
    valid[1] = False
    return [np.ascontiguousarray(a) for a in (x1, y1, x2, y2)], valid


def _both(planes, valid):
    ours = suppression_iou_max(*(torch.from_numpy(p) for p in planes),
                               torch.from_numpy(valid)).numpy()
    jp = [jnp.asarray(p) for p in planes]
    return ours, jp, jnp.asarray(valid)


@pytest.mark.parametrize('rows,k', [(8, 128), (3, 200)])
def test_plain_matches_pallas_interpret_and_xla(rng, rows, k):
    planes, valid = _planes(rng, rows, k)
    ours, jp, jv = _both(planes, valid)
    xla = np.asarray(_xla_iou_max(*jp, jv))
    pallas = np.asarray(pallas_iou_max(*jp, jv, interpret=True))
    assert np.isnan(xla).any()              # the fixture reaches the NaN case
    for ref in (xla, pallas):
        # NaN and zero positions exactly; values within 1 ulp, since XLA's
        # CPU fusion may contract `a + b - x * y` into an fma where PyTorch
        # rounds each op (the JAX package's own kernel test uses the same
        # rtol against the XLA form)
        np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
        np.testing.assert_array_equal(ours == 0, ref == 0)
        np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(ours[1], 0.0)     # all-invalid row


def test_zero_area_pair_gives_nan():
    # two valid boxes clipped to the image corner: 0/0 in the IoU, which the
    # max keeps, so `iou_max <= thre` drops the second one
    x = np.ones((1, 4), np.float32)
    valid = np.array([[True, True, False, True]])
    ours, jp, jv = _both([x, x, x, x], valid)
    ref = np.asarray(_xla_iou_max(*jp, jv))
    np.testing.assert_array_equal(ref, [[0.0, np.nan, 0.0, np.nan]])
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(
        np.asarray(pallas_iou_max(*jp, jv, interpret=True)), ref)


def test_cpu_tensors_take_the_plain_version_without_counting(rng):
    planes, valid = _planes(rng, 4, 64)
    t = [torch.from_numpy(p) for p in planes]
    before = suppression_iou_max.launches
    out = suppression_iou_max(*t, torch.from_numpy(valid))
    assert suppression_iou_max.launches == before
    torch.testing.assert_close(out, suppression_iou_max_plain(*t, torch.from_numpy(valid)),
                               rtol=0, atol=0, equal_nan=True)


def test_wrapper_rejects_what_the_kernel_does_not_take(rng):
    planes, valid = _planes(rng, 2, 16)
    t = [torch.from_numpy(p) for p in planes]
    v = torch.from_numpy(valid)
    with pytest.raises(ValueError):
        suppression_iou_max(t[0].double(), *t[1:], v)
    with pytest.raises(ValueError):
        suppression_iou_max(*t, v.float())
    with pytest.raises(ValueError):
        suppression_iou_max(t[0].T, *t[1:], v)
