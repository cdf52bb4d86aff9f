"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card and the CUDA toolkit; without a card it
skips. On the card: python -m pytest tests/test_torch_cuda.py -m cuda
"""
import numpy as np
import pytest
import torch

from yolact_minimal_torch.config import get_config
from yolact_minimal_torch.ops.attn_block import attn_block, attn_block_plain
from yolact_minimal_torch.ops.mask_finalize import mask_finalize, mask_finalize_plain
from yolact_minimal_torch.ops.suppression import (suppression_iou_max,
                                                  suppression_iou_max_plain)
from yolact_minimal_torch.ops.swin_block import swin_block, swin_block_plain
from yolact_minimal_torch.ops.swin_mlp import kernel_geometry, mlp_block, mlp_block_plain
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


# (heads, windows B*nW, windows an image nW): three images of 16 and of 9
# windows; every head count at window counts that no grid of the bf16 kernel
# divides (its groups walk the windows of one head in steps of
# kernel_geometry(...).per_head); stage 0 (6400 windows at C = 96) and stage 3
# (144 at C = 768) of swin_tiny at 544, batch 16.
WINDOW_CASES = [(3, 48, 16), (24, 27, 9)] + \
    [(heads, bnw, 1) for heads in (3, 6, 12, 24) for bnw in (1, 2, 131, 133)] + \
    [(3, 6400, 400), (24, 144, 9)]


@pytest.mark.parametrize('dtype,tol', SWIN_TOLS)
@pytest.mark.parametrize('heads,bnw,nw', WINDOW_CASES)
@pytest.mark.parametrize('masked', [False, True])
def test_window_attention_kernel_matches_plain(card, dtype, tol, heads, bnw, nw, masked):
    from yolact_minimal_torch.models.swin import shifted_window_regions
    rng = np.random.RandomState(0)
    c, side = heads * 32, int(nw ** 0.5) * 7
    qkv = torch.from_numpy(rng.randn(bnw, 49, 3 * c).astype(np.float32)).to(card, dtype)
    bias = torch.from_numpy((rng.randn(heads, 49, 49) * 0.1).astype(np.float32)).to(card, dtype)
    region = torch.from_numpy(shifted_window_regions(side, side)).to(card) if masked else None
    before = window_attention.launches
    got = window_attention(qkv, bias, region, heads)
    torch.cuda.synchronize()
    assert window_attention.launches == before + 1
    ref = window_attention_plain(qkv, bias, region, heads)
    assert got.dtype == dtype and got.shape == ref.shape == (bnw, 49, c)
    _assert_close_rel(got, ref, tol)
    # a fixed unit order and no atomics: two launches, the same bits
    assert torch.equal(window_attention(qkv, bias, region, heads), got)


def test_window_attention_kernel_is_built_as_the_geometry_assumes(card):
    from yolact_minimal_torch.ops.window_attention import (BLOCKS_PER_SM, GROUPS_PER_BLOCK,
                                                           kernel_attributes)
    attrs = kernel_attributes()
    assert attrs['groups_per_block'] == GROUPS_PER_BLOCK
    assert attrs['blocks_per_sm'] == BLOCKS_PER_SM
    assert attrs['threads'] == 128 * GROUPS_PER_BLOCK
    # BLOCKS_PER_SM blocks fit a multiprocessor's shared memory and registers
    assert 0 < attrs['smem_bytes'] * BLOCKS_PER_SM <= 232448
    assert 0 < attrs['registers'] * attrs['threads'] * BLOCKS_PER_SM <= 65536


def _mlp_inputs(card, rng, rows, c, dtype):
    dev = lambda a: torch.from_numpy(a.astype(np.float32)).to(card)
    x = dev(rng.randn(rows, c)).to(dtype)
    params = (dev(rng.randn(c) * 0.1 + 1.0), dev(rng.randn(c) * 0.1),
              dev(rng.randn(4 * c, c) * 0.05), dev(rng.randn(4 * c) * 0.05),
              dev(rng.randn(c, 4 * c) * 0.05), dev(rng.randn(c) * 0.05))
    return x, params


# Row counts one either side of 64 and of 128 rows (the bf16 kernel's tiles:
# 128 rows at C = 96 and 192, 64 at 384 and 768; a block walks whole tiles,
# in clusters of one), one row, and stage 3's 4624 rows at C = 768.
MLP_ROWS = [(c, rows) for c, first in ((96, 1000), (192, 203), (384, 289), (768, 71))
            for rows in (first, 1, 63, 65, 127, 129)] + [(768, 4624)]


@pytest.mark.parametrize('dtype,tol', SWIN_TOLS)
@pytest.mark.parametrize('c,rows', MLP_ROWS)
def test_swin_mlp_kernel_matches_plain(card, dtype, tol, c, rows):
    rng = np.random.RandomState(1)
    dev = lambda a: torch.from_numpy(a.astype(np.float32)).to(card)
    x, params = _mlp_inputs(card, rng, rows, c, dtype)
    before = mlp_block.launches
    got = mlp_block(x, *params)
    torch.cuda.synchronize()
    assert mlp_block.launches == before + 1
    ref = mlp_block_plain(x, *params)
    assert got.dtype == dtype and got.shape == ref.shape
    # rows are ragged against the kernel's tiles
    _assert_close_rel(got, ref, tol)
    with pytest.raises(ValueError, match='the kernel takes C in'):
        mlp_block(x[:, :64].contiguous(), *(dev(rng.randn(*s)) for s in
                                            ((64,), (64,), (256, 64), (256,), (64, 256), (64,))))


@pytest.mark.parametrize('c,rows', [(96, 295936), (768, 4624), (384, 1)])
def test_swin_mlp_geometry_covers_the_rows(card, c, rows):
    geo = kernel_geometry(c, rows)
    assert geo['rows_per_tile'] * geo['tiles'] >= rows > geo['rows_per_tile'] * (geo['tiles'] - 1)
    assert 1 <= geo['blocks'] <= geo['tiles'] and geo['threads'] % 128 == 0
    assert 0 < geo['smem_bytes'] <= 232448 and 0 < geo['registers'] <= 255


@pytest.mark.parametrize('c', [96, 192, 384, 768])
def test_swin_mlp_kernel_is_deterministic(card, c):
    # no atomics and every sum in a fixed order: two launches, the same bits
    x, params = _mlp_inputs(card, np.random.RandomState(2), 1000, c, torch.bfloat16)
    k1, k2 = params[2].bfloat16(), params[4].bfloat16()
    args = (x, params[0], params[1], k1, params[3], k2, params[5])
    first = mlp_block(*args)
    second = mlp_block(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def _block_params(card, rng, c, heads, nw, dtype, masked, padded):
    """x, rowmask, ln1, wqkv, bqkv, bias, region, wproj, bproj, ln2, k1, b1,
    k2, b2 as swin_block takes them; 3 images of nw windows (no multiple of
    any tile), the last row and column of the map padding."""
    from yolact_minimal_torch.models.swin import pad_rowmask, shifted_window_regions
    dev = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(card)
    side = int(nw ** 0.5) * 7
    region = torch.from_numpy(shifted_window_regions(side, side)).to(card) if masked else None
    shift = 3 if masked else 0
    rowmask = dev(pad_rowmask(side - 2, side - 1, side, side, shift)) if padded else None
    return (dev(rng.randn(3 * nw, 49, c)).to(dtype), rowmask,
            dev(rng.randn(c) * 0.1 + 1.0), dev(rng.randn(c) * 0.1),
            dev(rng.randn(3 * c, c) * c ** -0.5), dev(rng.randn(3 * c) * 0.05),
            dev(rng.randn(heads, 49, 49) * 0.1).to(dtype), region,
            dev(rng.randn(c, c) * c ** -0.5), dev(rng.randn(c) * 0.05),
            dev(rng.randn(c) * 0.1 + 1.0), dev(rng.randn(c) * 0.1),
            dev(rng.randn(4 * c, c) * c ** -0.5), dev(rng.randn(4 * c) * 0.05),
            dev(rng.randn(c, 4 * c) * (4 * c) ** -0.5), dev(rng.randn(c) * 0.05))


@pytest.mark.parametrize('dtype,tol', SWIN_TOLS)
@pytest.mark.parametrize('heads,nw', [(3, 25), (24, 9)])
@pytest.mark.parametrize('masked', [False, True])
def test_attn_block_kernel_matches_plain(card, dtype, tol, heads, nw, masked):
    p = _block_params(card, np.random.RandomState(2), heads * 32, heads, nw, dtype, masked, False)
    args = (p[0], *p[4:10], heads)
    before = attn_block.launches
    got = attn_block(*args)
    torch.cuda.synchronize()
    assert attn_block.launches == before + 1
    ref = attn_block_plain(*args)
    assert got.dtype == dtype and got.shape == ref.shape == (3 * nw, 49, heads * 32)
    _assert_close_rel(got, ref, tol)
    with pytest.raises(ValueError, match='the kernel takes 49 tokens'):
        attn_block(p[0][:, :, :64].contiguous(), p[4][:192, :64].contiguous(), p[5][:192],
                   p[6][:2].contiguous(), None, p[8][:64, :64].contiguous(), p[9][:64], 2)


@pytest.mark.parametrize('dtype,tol', SWIN_TOLS)
@pytest.mark.parametrize('heads,nw', [(3, 25), (6, 4), (12, 4), (24, 9)])
@pytest.mark.parametrize('masked,padded', [(False, False), (True, True), (False, True)])
def test_swin_block_kernel_matches_plain(card, dtype, tol, heads, nw, masked, padded):
    p = _block_params(card, np.random.RandomState(3), heads * 32, heads, nw, dtype, masked, padded)
    before = swin_block.launches
    got = swin_block(*p, heads)
    torch.cuda.synchronize()
    assert swin_block.launches == before + 1
    ref = swin_block_plain(*p, heads)
    assert got.dtype == dtype and got.shape == ref.shape == (3 * nw, 49, heads * 32)
    _assert_close_rel(got, ref, tol)
    if padded:      # the rowmask matters on these inputs
        assert (swin_block_plain(p[0], None, *p[2:], heads).float() - ref.float()).abs().max() > 1e-3


@pytest.mark.parametrize('form,expected', [('composed', [1, 1, 12, 12, 0, 0]),
                                           ('attn_block', [1, 1, 0, 12, 12, 0]),
                                           ('whole', [1, 1, 0, 0, 0, 12]),
                                           (('whole', 'whole', 'composed', 'composed'),
                                            [1, 1, 8, 8, 0, 4])])
def test_swin_detector_runs_the_kernels_of_its_form(card, form, expected):
    from yolact_minimal_torch.pipeline import Detector
    det = Detector(get_config('swin_tiny_coco', img_size=128, nms_score_thre=0.002))
    det.model.backbone.set_block_forms(form)
    images = torch.randn(2, 128, 128, 3, generator=torch.Generator().manual_seed(0))
    counters = (suppression_iou_max, mask_finalize, window_attention, mlp_block, attn_block,
                swin_block)
    before = [f.launches for f in counters]
    dets, masks = det.detect_fixed(images, 128)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(counters, before)] == expected
    assert masks.shape == (2, 100, 128, 128) and bool(dets.valid.all())
