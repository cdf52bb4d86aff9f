"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card and the CUDA toolkit; without a card it
skips. On the card: python -m pytest tests/test_torch_cuda.py -m cuda
"""
import numpy as np
import pytest
import torch

from yolact_minimal_torch.config import get_config
from yolact_minimal_torch.ops.mask_finalize import mask_finalize, mask_finalize_plain
from yolact_minimal_torch.ops.suppression import (suppression_iou_max,
                                                  suppression_iou_max_plain)
from yolact_minimal_torch.ops.swin_mlp import mlp_block, mlp_block_plain
from yolact_minimal_torch.ops.window_attention import (window_attention,
                                                       window_attention_plain)

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (torch.cuda.is_available() is false)')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def test_suppression_kernel_equals_plain(card):
    g = torch.Generator(device=card).manual_seed(0)
    rows, k = 160, 200
    xy = torch.rand(2, rows, k, device=card, generator=g) * 0.8
    wh = torch.rand(2, rows, k, device=card, generator=g) * 0.4
    x1, y1 = xy[0].contiguous(), xy[1].contiguous()
    x2, y2 = (x1 + wh[0]).clamp(max=1), (y1 + wh[1]).clamp(max=1)
    flat = torch.rand(rows, k, device=card, generator=g) < 0.05
    for t in (x1, y1, x2, y2):
        t[flat] = 1.0                           # zero-area boxes: NaN pairs
    valid = torch.rand(rows, k, device=card, generator=g) > 0.2
    valid[3] = False
    before = suppression_iou_max.launches
    got = suppression_iou_max(x1, y1, x2, y2, valid)
    torch.cuda.synchronize()
    assert suppression_iou_max.launches == before + 1
    ref = suppression_iou_max_plain(x1, y1, x2, y2, valid)
    assert torch.isnan(ref).any()
    # exact, NaN positions included: the kernel rounds every op as PyTorch does
    torch.testing.assert_close(got, ref, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize('do_crop', [True, False])
@pytest.mark.parametrize('ph,out_size', [(34, 136), (20, 72)])
def test_mask_kernel_matches_plain(card, do_crop, ph, out_size):
    rng = np.random.RandomState(0)
    b, d = 2, 16
    proto = torch.from_numpy(rng.normal(size=(b, ph, ph, 32)).astype(np.float32)).to(card)
    coefs = torch.from_numpy(np.tanh(rng.normal(size=(b, d, 32))).astype(np.float32)).to(card)
    xy = rng.uniform(0, 0.6, size=(b, d, 2))
    boxes = np.concatenate([xy, np.clip(xy + rng.uniform(0.1, 0.4, size=(b, d, 2)), 0, 1)], 2)
    boxes = torch.from_numpy(boxes.astype(np.float32)).to(card)
    valid = torch.from_numpy(rng.rand(b, d) > 0.3).to(card)
    before = mask_finalize.launches
    got = mask_finalize(proto, coefs, boxes, valid, out_size, do_crop)
    torch.cuda.synchronize()
    assert mask_finalize.launches == before + 1
    ref = mask_finalize_plain(proto, coefs, boxes, valid, out_size, do_crop)
    assert got.dtype == torch.bool and got.shape == ref.shape
    assert ref.any()
    # summation order differs: pixels within rounding of 0.5 may flip
    assert (got != ref).float().mean().item() < 1e-4
    assert not got[~valid].any()


def test_detector_runs_both_kernels(card):
    from yolact_minimal_torch.pipeline import Detector
    det = Detector(get_config('res50_coco', img_size=128, nms_score_thre=0.002))
    images = torch.randn(2, 128, 128, 3, generator=torch.Generator().manual_seed(0))
    s0, m0 = suppression_iou_max.launches, mask_finalize.launches
    dets, masks = det.detect_fixed(images, 128)
    torch.cuda.synchronize()
    assert suppression_iou_max.launches > s0 and mask_finalize.launches > m0
    assert masks.shape == (2, 100, 128, 128) and bool(dets.valid.all())


# The swin kernels against their plain versions, as a share of max |plain|.
# float32: sums in another order. bf16: the same rounding places, so at most
# one ulp (2^-7 of the magnitude) where a float32 value rounds the other way.
SWIN_TOLS = [(torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)]


def _assert_close_rel(got, ref, tol):
    got, ref = got.float(), ref.float()
    assert (got - ref).abs().max().item() <= tol * ref.abs().max().item()


@pytest.mark.parametrize('dtype,tol', SWIN_TOLS)
@pytest.mark.parametrize('heads,nw', [(3, 16), (24, 9)])
@pytest.mark.parametrize('masked', [False, True])
def test_window_attention_kernel_matches_plain(card, dtype, tol, heads, nw, masked):
    from yolact_minimal_torch.models.swin import shifted_window_regions
    rng = np.random.RandomState(0)
    c, side = heads * 32, int(nw ** 0.5) * 7
    qkv = torch.from_numpy(rng.randn(3 * nw, 49, 3 * c).astype(np.float32)).to(card, dtype)
    bias = torch.from_numpy((rng.randn(heads, 49, 49) * 0.1).astype(np.float32)).to(card, dtype)
    region = torch.from_numpy(shifted_window_regions(side, side)).to(card) if masked else None
    before = window_attention.launches
    got = window_attention(qkv, bias, region, heads)
    torch.cuda.synchronize()
    assert window_attention.launches == before + 1
    ref = window_attention_plain(qkv, bias, region, heads)
    assert got.dtype == dtype and got.shape == ref.shape == (3 * nw, 49, c)
    _assert_close_rel(got, ref, tol)


@pytest.mark.parametrize('dtype,tol', SWIN_TOLS)
@pytest.mark.parametrize('c,rows', [(96, 1000), (192, 203), (384, 289), (768, 71)])
def test_swin_mlp_kernel_matches_plain(card, dtype, tol, c, rows):
    rng = np.random.RandomState(1)
    dev = lambda a: torch.from_numpy(a.astype(np.float32)).to(card)
    x = dev(rng.randn(rows, c)).to(dtype)
    params = (dev(rng.randn(c) * 0.1 + 1.0), dev(rng.randn(c) * 0.1),
              dev(rng.randn(4 * c, c) * 0.05), dev(rng.randn(4 * c) * 0.05),
              dev(rng.randn(c, 4 * c) * 0.05), dev(rng.randn(c) * 0.05))
    before = mlp_block.launches
    got = mlp_block(x, *params)
    torch.cuda.synchronize()
    assert mlp_block.launches == before + 1
    ref = mlp_block_plain(x, *params)
    assert got.dtype == dtype and got.shape == ref.shape
    # rows are ragged against the kernel's 64- and 32-row blocks
    _assert_close_rel(got, ref, tol)
    with pytest.raises(ValueError, match='the kernel takes C in'):
        mlp_block(x[:, :64].contiguous(), *(dev(rng.randn(*s)) for s in
                                            ((64,), (64,), (256, 64), (256,), (64, 256), (64,))))


def test_swin_detector_runs_all_four_kernels(card):
    from yolact_minimal_torch.pipeline import Detector
    det = Detector(get_config('swin_tiny_coco', img_size=128, nms_score_thre=0.002))
    images = torch.randn(2, 128, 128, 3, generator=torch.Generator().manual_seed(0))
    counters = (suppression_iou_max, mask_finalize, window_attention, mlp_block)
    before = [f.launches for f in counters]
    dets, masks = det.detect_fixed(images, 128)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(counters, before)] == [1, 1, 12, 12]
    assert masks.shape == (2, 100, 128, 128) and bool(dets.valid.all())
