"""The mask-finalize kernel's plain PyTorch version against the JAX
package's Pallas kernel (interpret mode) and its XLA pair
assemble_masks + finalize_masks_fixed."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolact_minimal_tpu.ops.nms import Detections as JDets
from yolact_minimal_tpu.ops.nms import assemble_masks as j_assemble
from yolact_minimal_tpu.ops.nms import finalize_masks_fixed as j_finalize
from yolact_minimal_tpu.ops.pallas_masks import fused_mask_finalize
from yolact_minimal_torch.ops.mask_finalize import (_tables, mask_finalize, mask_finalize_plain,
                                                    output_windows)
from yolact_minimal_torch.ops.resize import _gather_lerp
from yolact_minimal_torch.ops.nms import Detections, assemble_masks

torch.set_num_threads(1)

# Pixels whose upsampled value lies within float-reassociation distance of
# 0.5 may flip between two summation orders; the JAX package holds its own
# Pallas kernel to the XLA pair at the same fraction.
MISMATCH = 1e-4


def _slate(rng, b=2, ph=16, pw=16, d=12):
    proto = rng.normal(size=(b, ph, pw, 32)).astype(np.float32)
    coefs = np.tanh(rng.normal(size=(b, d, 32))).astype(np.float32)
    xy1 = rng.uniform(0, 0.6, size=(b, d, 2)).astype(np.float32)
    wh = rng.uniform(0.1, 0.4, size=(b, d, 2)).astype(np.float32)
    boxes = np.concatenate([xy1, np.clip(xy1 + wh, 0, 1)], axis=2)
    valid = rng.rand(b, d) > 0.3
    valid[0, 0] = True
    return proto, coefs, boxes, valid


def _xla(proto, coefs, boxes, valid, out_size, do_crop):
    dets = JDets(ids=jnp.zeros(valid.shape, jnp.int32),
                 scores=jnp.ones(valid.shape, jnp.float32),
                 boxes=jnp.asarray(boxes), coefs=jnp.asarray(coefs),
                 valid=jnp.asarray(valid))
    mp = jax.vmap(functools.partial(j_assemble, do_crop=do_crop))(jnp.asarray(proto), dets)
    return np.asarray(jax.vmap(lambda m: j_finalize(m, out_size))(mp)), np.asarray(mp)


def _ours(proto, coefs, boxes, valid, out_size, do_crop):
    return mask_finalize(torch.from_numpy(proto), torch.from_numpy(coefs),
                         torch.from_numpy(boxes), torch.from_numpy(valid),
                         out_size, do_crop).numpy()


@pytest.mark.parametrize('do_crop', [True, False])
def test_plain_matches_xla_and_pallas_interpret(rng, do_crop):
    proto, coefs, boxes, valid = _slate(rng)
    ref, _ = _xla(proto, coefs, boxes, valid, 64, do_crop)
    ours = _ours(proto, coefs, boxes, valid, 64, do_crop)
    pallas = np.asarray(fused_mask_finalize(
        jnp.asarray(proto), jnp.asarray(coefs), jnp.asarray(boxes),
        jnp.asarray(valid), 64, do_crop, True)).astype(bool)
    assert ours.dtype == bool and ours.shape == ref.shape == (2, 12, 64, 64)
    assert ref.any()
    assert (ours != ref).mean() < MISMATCH
    assert (ours != pallas).mean() < MISMATCH
    assert not ours[~valid].any()                  # invalid slots stay empty


@pytest.mark.parametrize('ph,pw,out_size', [(16, 12, 40), (10, 10, 24), (8, 8, 8)])
def test_other_output_sizes_match_xla(rng, ph, pw, out_size):
    # out_size != 4*ph (the Pallas kernel's only case), non-square protos and
    # a downsample-free identity size: the 2-tap tables serve them all
    proto, coefs, boxes, valid = _slate(rng, b=1, ph=ph, pw=pw, d=6)
    ref, _ = _xla(proto, coefs, boxes, valid, out_size, True)
    ours = _ours(proto, coefs, boxes, valid, out_size, True)
    assert ours.shape == (1, 6, out_size, out_size)
    assert (ours != ref).mean() < MISMATCH


def test_all_invalid_slots_are_empty(rng):
    proto, coefs, boxes, _ = _slate(rng, b=1, d=8)
    valid = np.zeros((1, 8), bool)
    assert not _ours(proto, coefs, boxes, valid, 64, True).any()


def test_assemble_masks_matches_xla(rng):
    # proto-resolution masks: a 32-long dot, sigmoid, crop, validity
    proto, coefs, boxes, valid = _slate(rng)
    _, ref = _xla(proto, coefs, boxes, valid, 64, True)
    dets = Detections(None, None, torch.from_numpy(boxes), torch.from_numpy(coefs),
                      torch.from_numpy(valid))
    ours = assemble_masks(torch.from_numpy(proto), dets).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


def test_cpu_tensors_take_the_plain_version_without_counting(rng):
    args = [torch.from_numpy(a) for a in _slate(rng, b=1, d=4)]
    before = mask_finalize.launches
    out = mask_finalize(*args, 64)
    assert mask_finalize.launches == before
    assert torch.equal(out, mask_finalize_plain(*args, 64))


def test_wrapper_rejects_what_the_kernel_does_not_take(rng):
    proto, coefs, boxes, valid = (torch.from_numpy(a) for a in _slate(rng, b=1, d=4))
    with pytest.raises(ValueError):
        mask_finalize(proto.double(), coefs, boxes, valid, 64)
    with pytest.raises(ValueError):
        mask_finalize(proto, coefs[:, :3], boxes, valid, 64)
    with pytest.raises(ValueError):
        mask_finalize(proto, coefs, boxes, valid.float(), 64)
    with pytest.raises(ValueError):
        mask_finalize(proto.permute(0, 2, 1, 3), coefs, boxes, valid, 64)


# (proto side, output side): the main configuration, the card tests' sizes
# and one that is not a multiple of 4 (nor of 16)
WINDOW_SIZES = [(136, 544), (34, 136), (20, 72), (19, 75)]


@pytest.mark.parametrize('n,out_size', WINDOW_SIZES)
def test_window_tables_match_brute_force(n, out_size):
    lo, hi, _ = _gather_lerp(n, out_size, False)
    tabs, tile_rows = _tables(n, n, out_size, torch.device('cpu'))
    first_h, last_h, first_w, last_w = (t.numpy() for t in tabs[6:])
    taps = np.stack([lo, hi], 1)                                    # [out, 2]
    first = np.array([min([x for x in range(out_size) if taps[x].max() >= r], default=out_size)
                      for r in range(n)])
    last = np.array([max([x for x in range(out_size) if taps[x].min() <= r], default=-1)
                     for r in range(n)])
    for got in (first_h, first_w):
        np.testing.assert_array_equal(got, first)
    for got in (last_h, last_w):
        np.testing.assert_array_equal(got, last)
    # what the kernel relies on: a crop [r0, r1) reaches exactly the outputs
    # [first[r0], last[r1 - 1]] (none where first > last)
    for r0 in range(n):
        for r1 in range(r0 + 1, n + 1):
            reach = np.flatnonzero(((taps >= r0) & (taps < r1)).any(1))
            if reach.size:
                assert (reach[0], reach[-1]) == (first[r0], last[r1 - 1])
            else:
                assert first[r0] > last[r1 - 1]
    # every band of BAND_ROWS output rows fits the m tile
    assert tile_rows == max(hi[min(y + 31, out_size - 1)] - lo[y] + 1
                            for y in range(0, out_size, 32))


@pytest.mark.parametrize('do_crop', [True, False])
@pytest.mark.parametrize('n,out_size', [(16, 64), (19, 75), (34, 136)])
def test_output_window_holds_every_true_pixel(rng, n, out_size, do_crop):
    proto, coefs, boxes, valid = _slate(rng, b=2, ph=n, pw=n, d=16)
    # on the border, zero-area (inside, on the far corner, off the image),
    # the full image and beyond it
    boxes[0, :8] = [(0.0, 0.0, 0.3, 0.2), (0.8, 0.7, 1.0, 1.0), (0.5, 0.5, 0.5, 0.5),
                    (1.0, 1.0, 1.0, 1.0), (1.2, -0.3, 1.5, -0.1), (0.0, 0.0, 1.0, 1.0),
                    (-0.1, -0.1, 1.1, 1.1), (0.4, 0.0, 0.6, 1.0)]
    valid[0, :8] = True
    args = [torch.from_numpy(a) for a in (proto, coefs, boxes, valid)]
    masks = mask_finalize_plain(*args, out_size, do_crop).numpy()
    win = output_windows(args[2], args[3], n, n, out_size, do_crop).numpy()
    assert masks[0, 5].any()                      # the full-image box has a mask
    for b in range(2):
        for d in range(16):
            oy0, oy1, ox0, ox1 = win[b, d]
            inside = np.zeros((out_size, out_size), bool)
            inside[oy0:oy1, ox0:ox1] = True
            assert not masks[b, d][~inside].any(), (b, d, win[b, d])
    assert not win[~valid].any()                   # invalid slots: no window
    if do_crop:
        # padding keeps 1-2 proto pixels of a zero-area box, none off the image
        for d in (2, 3):
            assert 0 < win[0, d, 1] - win[0, d, 0] <= 3 * out_size // n + 1
        assert not win[0, 4].any()
        assert (win[0, 5] == (0, out_size, 0, out_size)).all()
    else:
        assert (win[valid] == (0, out_size, 0, out_size)).all()
