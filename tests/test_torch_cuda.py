"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card and the CUDA toolkit; without a card it
skips. On the card: python -m pytest tests/test_torch_cuda.py -m cuda
"""
import numpy as np
import pytest
import torch

from yolact_minimal_torch.config import get_config
from yolact_minimal_torch.ops import attn_block as attn_block_ops
from yolact_minimal_torch.ops.attn_block import attn_block, attn_block_plain
from yolact_minimal_torch.ops.mask_finalize import mask_finalize, mask_finalize_plain
from yolact_minimal_torch.ops.suppression import (suppression_iou_max,
                                                  suppression_iou_max_plain)
from yolact_minimal_torch.ops.swin_glue import (from_windows, from_windows_plain, to_windows,
                                                to_windows_plain)
from yolact_minimal_torch.ops.swin_block import (KERNEL_SHAPES, kernel_attributes,
                                                 launch_shapes, shared_bytes, swin_block,
                                                 swin_block_plain)
from yolact_minimal_torch.ops.swin_mlp import (kernel_geometry, mlp_block, mlp_block_plain,
                                               mlp_form)
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


def _suppression_inputs(rows, k, validity, boxes, rng):
    """[rows, k] planes and validity for the suppression kernel. 'zero_area':
    random boxes, 5 % of them flat (zero-area pairs give 0/0 = NaN);
    'inverted': 30 % with x2 < x1 or y2 < y1 (negative areas), some mirrored
    copies of another box (areas that cancel: NaN pairs without a flat box)."""
    xy = rng.uniform(0, 0.8, size=(2, rows, k))
    wh = rng.uniform(0, 0.4, size=(2, rows, k))
    x1, y1 = xy
    x2, y2 = np.minimum(x1 + wh[0], 1.0), np.minimum(y1 + wh[1], 1.0)
    if boxes == 'zero_area':
        flat = rng.rand(rows, k) < 0.05
        x1[flat] = x2[flat] = y1[flat] = y2[flat] = 1.0
        thin = rng.rand(rows, k) < 0.02             # zero width, elsewhere
        x2[thin] = x1[thin]
    else:
        flip_x, flip_y = rng.rand(2, rows, k) < 0.3
        x1[flip_x], x2[flip_x] = x2[flip_x], x1[flip_x].copy()
        y1[flip_y], y2[flip_y] = y2[flip_y], y1[flip_y].copy()
        mirror = rng.rand(rows, k) < 0.05          # box j's x extent reversed at j + 1
        mirror[:, -1] = False
        src = np.roll(mirror, 1, axis=1)
        x1[src], x2[src], y1[src], y2[src] = x2[mirror], x1[mirror], y1[mirror], y2[mirror]
    score = rng.rand(rows, k)
    valid = {'scattered': score > 0.2, 'all_valid': np.ones((rows, k), bool),
             'all_invalid': np.zeros((rows, k), bool),
             # the caller's rows: sorted by score, the passing ones first
             'prefix': np.arange(k)[None, :] < rng.randint(0, k + 1, size=(rows, 1))}[validity]
    planes = [np.ascontiguousarray(p, dtype=np.float32) for p in (x1, y1, x2, y2)]
    return planes, valid


@pytest.mark.parametrize('boxes', ['zero_area', 'inverted'])
@pytest.mark.parametrize('validity', ['scattered', 'all_valid', 'all_invalid', 'prefix'])
@pytest.mark.parametrize('rows,k', [(160, 200), (1, 1), (3, 37), (17, 2048)])
def test_suppression_kernel_equals_plain(card, rows, k, validity, boxes):
    rng = np.random.RandomState(rows * 7 + k)
    planes, valid = _suppression_inputs(rows, k, validity, boxes, rng)
    x1, y1, x2, y2 = (torch.from_numpy(p).to(card) for p in planes)
    valid = torch.from_numpy(valid).to(card)
    before = suppression_iou_max.launches
    got = suppression_iou_max(x1, y1, x2, y2, valid)
    torch.cuda.synchronize()
    assert suppression_iou_max.launches == before + 1
    ref = suppression_iou_max_plain(x1, y1, x2, y2, valid)
    if rows * k >= 160 * 200 and validity != 'all_invalid':
        assert torch.isnan(ref).any()
    # exact, NaN positions included: the kernel rounds every op as PyTorch does
    torch.testing.assert_close(got, ref, rtol=0, atol=0, equal_nan=True)
    assert not got[~valid].any()


@pytest.mark.parametrize('scale', [1.0, 1000.0, 2.0 ** -12])
def test_suppression_kernel_pair_quotients(card, scale):
    """Rows of two valid boxes: out[:, 1] is one pair's IoU, so every quotient
    the kernel divides shows, on 2^20 pairs a scale (2^-12 puts coordinates
    on both sides of the lower bound of the kernel's fast rows); half of the
    second boxes are jittered copies of the first (IoU near 1)."""
    rng = np.random.RandomState(int(np.log2(scale)) + 40)
    rows = 1 << 20
    xy = rng.uniform(0, 0.8, size=(2, rows, 2))
    wh = rng.uniform(0, 0.4, size=(2, rows, 2))
    near = rng.rand(rows) < 0.5
    xy[:, near, 1] = xy[:, near, 0] + rng.uniform(-0.01, 0.01, size=(2, int(near.sum())))
    wh[:, near, 1] = wh[:, near, 0] + rng.uniform(-0.01, 0.01, size=(2, int(near.sum())))
    planes = [torch.from_numpy(np.ascontiguousarray(p * scale, dtype=np.float32)).to(card)
              for p in (xy[0], xy[1], xy[0] + np.abs(wh[0]), xy[1] + np.abs(wh[1]))]
    valid = torch.ones(rows, 2, dtype=torch.bool, device=card)
    got = suppression_iou_max(*planes, valid)
    torch.cuda.synchronize()
    ref = suppression_iou_max_plain(*planes, valid)
    assert (ref[:, 1] > 0.5).float().mean() > 0.4
    torch.testing.assert_close(got, ref, rtol=0, atol=0, equal_nan=True)


def test_suppression_kernel_geometry(card):
    from yolact_minimal_torch.ops.suppression import kernel_geometry
    for rows, k in ((1280, 200), (17, 2048), (1, 1)):
        geo = kernel_geometry(rows, k, card.index or 0)
        # one block a row; csrc/suppression.cu::smem_bytes: 42 bytes a slot
        # and two 4-byte masks a chunk of 32
        assert geo['blocks'] == rows and geo['threads'] % 32 == 0
        assert geo['smem_bytes'] == 42 * k + 8 * ((k + 31) // 32)
        assert geo['blocks_per_sm'] >= 1 and 0 < geo['registers'] <= 255
        assert geo['spill_bytes'] == 0


# Boxes that the mask kernel's output windows treat as edge cases: on the
# image border, zero-area (inside, on the far corner, off the image) and the
# full image.
EDGE_BOXES = [(0.0, 0.0, 0.3, 0.2), (0.8, 0.7, 1.0, 1.0), (0.0, 0.5, 1.0, 0.6),
              (0.5, 0.5, 0.5, 0.5), (1.0, 1.0, 1.0, 1.0), (1.2, -0.3, 1.5, -0.1),
              (0.0, 0.0, 1.0, 1.0), (-0.1, -0.1, 1.1, 1.1)]


@pytest.mark.parametrize('slate', ['random', 'edges', 'all_invalid'])
@pytest.mark.parametrize('do_crop', [True, False])
@pytest.mark.parametrize('ph,out_size', [(34, 136), (20, 72), (136, 544), (19, 75)])
def test_mask_kernel_matches_plain(card, do_crop, ph, out_size, slate):
    # 544 = 34 x 16: every output row 16-byte aligned; 136, 72 and 75 are not
    # multiples of 16, so rows and bands end mid-chunk (75: odd, byte stores)
    rng = np.random.RandomState(0)
    b, d = 2, 16
    proto = torch.from_numpy(rng.normal(size=(b, ph, ph, 32)).astype(np.float32)).to(card)
    coefs = torch.from_numpy(np.tanh(rng.normal(size=(b, d, 32))).astype(np.float32)).to(card)
    xy = rng.uniform(0, 0.6, size=(b, d, 2))
    boxes = np.concatenate([xy, np.clip(xy + rng.uniform(0.1, 0.4, size=(b, d, 2)), 0, 1)], 2)
    valid = rng.rand(b, d) > 0.3
    if slate == 'edges':
        boxes[0, :len(EDGE_BOXES)] = EDGE_BOXES
        valid[0, :len(EDGE_BOXES)] = True
    elif slate == 'all_invalid':
        valid[:] = False
    boxes = torch.from_numpy(boxes.astype(np.float32)).to(card)
    valid = torch.from_numpy(valid).to(card)
    before = mask_finalize.launches
    got = mask_finalize(proto, coefs, boxes, valid, out_size, do_crop)
    torch.cuda.synchronize()
    assert mask_finalize.launches == before + 1
    ref = mask_finalize_plain(proto, coefs, boxes, valid, out_size, do_crop)
    assert got.dtype == torch.bool and got.shape == ref.shape
    assert ref.any() == (slate != 'all_invalid')
    # summation order differs: pixels within rounding of 0.5 may flip
    assert (got != ref).float().mean().item() < 1e-4
    assert not got[~valid].any()


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_detector_runs_both_kernels(card, dtype):
    from yolact_minimal_torch.pipeline import Detector
    det = Detector(get_config('res50_coco', img_size=128, nms_score_thre=0.002,
                              compute_dtype=dtype))
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


# Swin-L at window 12, 544, batch 16: (heads, windows B*nW, windows an image
# nW) of stages 0-3 (sides 136 / 68 / 34 / 17 padded to 144 / 72 / 36 / 24),
# then window counts that leave the 144-token kernel's groups idle or uneven.
WIDE_CASES = [(6, 2304, 144), (12, 576, 36), (24, 144, 9), (48, 64, 4)] + \
    [(heads, bnw, 1) for heads in (6, 48) for bnw in (1, 2, 7)]


@pytest.mark.parametrize('heads,bnw,nw', WIDE_CASES)
@pytest.mark.parametrize('masked', [False, True])
def test_window_attention_144_token_kernel_matches_plain(card, heads, bnw, nw, masked):
    from yolact_minimal_torch.models.swin import shifted_window_regions
    rng = np.random.RandomState(4)
    c, side = heads * 32, int(nw ** 0.5) * 12
    qkv = torch.from_numpy(rng.randn(bnw, 144, 3 * c).astype(np.float32)).to(card, torch.bfloat16)
    bias = torch.from_numpy((rng.randn(heads, 144, 144) * 0.1).astype(np.float32)).to(
        card, torch.bfloat16)
    region = torch.from_numpy(shifted_window_regions(side, side, 12, 6)).to(card) \
        if masked else None
    before = window_attention.launches
    got = window_attention(qkv, bias, region, heads)
    torch.cuda.synchronize()
    assert window_attention.launches == before + 1
    ref = window_attention_plain(qkv, bias, region, heads)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape == (bnw, 144, c)
    _assert_close_rel(got, ref, 2.0 ** -7)
    # a fixed unit order and no atomics: two launches, the same bits
    assert torch.equal(window_attention(qkv, bias, region, heads), got)
    # the float32 kernel on the same windows (one image's when masked, else at
    # most 64: it is slow)
    q32, b32 = qkv[:nw if masked else 64].float(), bias.float()
    before = window_attention.launches
    got = window_attention(q32, b32, region, heads)
    assert window_attention.launches == before + 1
    _assert_close_rel(got, window_attention_plain(q32, b32, region, heads), 1e-5)


def test_window_attention_144_token_kernel_is_built_as_the_geometry_assumes(card):
    from yolact_minimal_torch.ops.window_attention import (WIDE_GROUPS_PER_BLOCK,
                                                           kernel_attributes)
    attrs = kernel_attributes(wide=True)
    assert attrs['groups_per_block'] == WIDE_GROUPS_PER_BLOCK and attrs['blocks_per_sm'] == 1
    assert attrs['threads'] == 96 * WIDE_GROUPS_PER_BLOCK
    assert 0 < attrs['smem_bytes'] <= 232448 and attrs['spill_bytes'] == 0
    assert 0 < attrs['registers'] * attrs['threads'] <= 65536


def test_window_attention_144_token_backward_refuses_bf16(card):
    """No backward kernel at 144 tokens: bf16 refuses, float32 takes the
    plain recompute, as at 49 tokens."""
    from yolact_minimal_torch.models.swin import shifted_window_regions
    from yolact_minimal_torch.ops.window_attention import (window_attention_backward,
                                                           window_attention_backward_plain)
    rng = np.random.RandomState(5)
    heads, bnw = 12, 72
    dev = lambda a: torch.from_numpy(a.astype(np.float32)).to(card)
    qkv, bias = dev(rng.randn(bnw, 144, 3 * heads * 32)), dev(rng.randn(heads, 144, 144) * 0.1)
    grad = dev(rng.randn(bnw, 144, heads * 32))
    region = torch.from_numpy(shifted_window_regions(72, 72, 12, 6)).to(card)
    before = window_attention.backward_launches
    with pytest.raises(ValueError, match='no backward kernel for 144-token windows'):
        window_attention_backward(qkv.bfloat16(), bias.bfloat16(), region, heads,
                                  grad.bfloat16())
    q = qkv.bfloat16().requires_grad_()
    with pytest.raises(ValueError, match='no backward kernel for 144-token windows'):
        window_attention(q, bias.bfloat16(), region, heads).backward(grad.bfloat16())
    got = window_attention_backward(qkv, bias, region, heads, grad)
    want = window_attention_backward_plain(qkv, bias, region, heads, grad)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert window_attention.backward_launches == before


@pytest.mark.parametrize('dtype,tol', [('float32', 1e-4), ('bfloat16', 0.037)])
def test_swin_large_detect_fixed_matches_the_reference(card, dtype, tol):
    """swin_large_coco at 544, b2, on the benchmark's weights: the network's
    four outputs against the float32 plain reference (benchmark/reference/
    yolact_window.py) and against the port's own plain glue route in
    relative L2, float32 to 1e-4 (summation order) and bf16 to the benchmark
    cell's net_gap limit; 24 launches each of kernels 3 and 4 and of the two
    glue kernels in both dtypes; the slate and masks come back."""
    from benchmark.core import weights_window
    from benchmark.reference.yolact_window import Yolact as Reference
    from yolact_minimal_torch.pipeline import Detector
    import json
    from pathlib import Path
    model = json.loads((Path(__file__).resolve().parents[1] / 'benchmark' / 'configs' /
                        'swin_large_coco.json').read_text())['model']
    sd = weights_window.make_state_dict(model, False, 3, card)
    cfg = get_config('swin_large_coco', img_size=544, compute_dtype=dtype, nms_score_thre=0.002)
    det = Detector(cfg, state_dict=sd, device=card)
    images = torch.randn(2, 544, 544, 3, generator=torch.Generator().manual_seed(2))
    kept = []
    hook = det.model.register_forward_hook(lambda _m, _a, out: kept.append(out))
    counters = (window_attention, mlp_block, to_windows, from_windows)
    before = [f.launches for f in counters]
    dets, masks = det.detect_fixed(images.numpy(), 544)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(counters, before)] == [24, 24, 24, 24]
    assert masks.shape == (2, 100, 544, 544) and int(dets.valid.sum()) == 200
    # the plain glue's route, as training and the CPU take it
    from yolact_minimal_torch.models.swin import SwinBlock
    glue = SwinBlock._fused_glue
    SwinBlock._fused_glue = lambda self, x, rate: False
    try:
        det.detect_fixed(images.numpy(), 544)
    finally:
        SwinBlock._fused_glue = glue
    hook.remove()
    assert [f.launches - n for f, n in zip(counters, before)] == [48, 48, 24, 24]
    ref = Reference(model).to(card).eval()
    ref.load_state_dict(sd)
    with torch.no_grad():
        want = ref(images.to(card))
    for got, plain, w in zip(kept[0], kept[1], want):
        gap = float((got.float() - w).norm() / w.norm())
        assert gap <= tol, gap
        gap = float((got.float() - plain.float()).norm() / plain.float().norm())
        assert gap <= tol, gap


# The attention half's glue kernels at every stage map of Swin-T (window 7)
# and Swin-L (window 12) at 544: (C, window, side) by stage.
GLUE_STAGES = [(c, 7, side) for c, side in zip((96, 192, 384, 768), (136, 68, 34, 17))] + \
    [(c, 12, side) for c, side in zip((192, 384, 768, 1536), (136, 68, 34, 17))]
GLUE_MANTISSA = {torch.float32: 23, torch.bfloat16: 7}


def _ulps(got, ref, dtype):
    """|got - ref| in units of the last place of `dtype` at the larger of the
    two magnitudes, and at 1 under 1: a normalised row's values are O(1), and
    the float32 sums that make them err by a share of that scale, not of a
    value that cancels to near 0."""
    got, ref = got.double(), ref.double()
    _, exp = torch.frexp(torch.maximum(torch.maximum(got.abs(), ref.abs()),
                                       torch.ones_like(got)))
    ulp = torch.ldexp(torch.ones_like(got), exp - 1 - GLUE_MANTISSA[dtype])
    return (got - ref).abs() / ulp


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('batch', [16, 2])
@pytest.mark.parametrize('shifted', [False, True])
@pytest.mark.parametrize('c,window,side', GLUE_STAGES)
def test_swin_glue_kernels_match_plain(card, dtype, batch, shifted, c, window, side):
    """to_windows: padding rows zero bit for bit, every other value (norm1)
    in bf16 within one ulp of the plain version; in float32 within the swin
    kernels' float32 tolerance (two float32 LayerNorms that sum in another
    order and take rsqrt at 2 ulp differ by several ulps: the number is
    printed, with the share of bit-equal values); from_windows bit-equal to
    `shortcut + ` the plain reverse. One launch each."""
    from yolact_minimal_torch.models.swin import pad_rowmask
    g = torch.Generator(device=card).manual_seed(side * c + batch)
    x = (torch.randn(batch, side, side, c, device=card, generator=g) * 2 + 0.5).to(dtype)
    scale = 1 + 0.1 * torch.randn(c, device=card, generator=g)
    bias = 0.1 * torch.randn(c, device=card, generator=g)
    shift = window // 2 if shifted else 0
    before = to_windows.launches, from_windows.launches
    got = to_windows(x, scale, bias, window, shift)
    y = torch.randn(got.shape, device=card, generator=g).to(dtype)
    back = from_windows(y, x, window, shift)
    torch.cuda.synchronize()
    assert (to_windows.launches, from_windows.launches) == (before[0] + 1, before[1] + 1)
    ref = to_windows_plain(x, scale, bias, window, shift)
    assert got.shape == ref.shape and got.dtype == dtype and got.is_contiguous()
    hp = -(-side // window) * window
    mask = pad_rowmask(side, side, hp, hp, shift, window)
    if mask is not None:
        pad = torch.from_numpy(mask == 0).to(card).repeat(batch, 1)
        assert pad.any() and bool((got[pad] == 0).all()) and bool((ref[pad] == 0).all())
    ulps = _ulps(got, ref, dtype)
    print(f'to_windows C {c} window {window} side {side} b{batch} shift {shift} {dtype}: '
          f'{(ulps == 0).double().mean().item():.6f} of the values bit-equal, '
          f'at most {ulps.max().item():.3g} ulp')
    if dtype == torch.bfloat16:
        assert ulps.max().item() <= 1
    else:
        _assert_close_rel(got, ref, dict(SWIN_TOLS)[torch.float32])
    assert back.is_contiguous() and torch.equal(back, from_windows_plain(y, x, window, shift))


@pytest.mark.parametrize('dtype,tol', SWIN_TOLS)
def test_eval_swin_block_takes_the_glue_kernels(card, dtype, tol):
    """An eval SwinBlock of Swin-L's stage 1 (C = 384, window 12, shifted) on
    a map that pads: with no gradient wanted it launches the two glue kernels
    once each, and its output is the plain glue's (under autograd: the route
    it takes there) within the swin kernels' tolerance."""
    from yolact_minimal_torch.models.swin import SwinBlock
    torch.manual_seed(0)
    block = SwinBlock(384, 12, 6, 12, dtype).to(card).eval()
    for p in block.parameters():
        torch.nn.init.normal_(p, std=0.05)
    x = torch.randn(2, 34, 34, 384, generator=torch.Generator().manual_seed(1)).to(card, dtype)
    before = to_windows.launches, from_windows.launches
    with torch.no_grad():
        fused = block(x)
    torch.cuda.synchronize()
    assert (to_windows.launches, from_windows.launches) == (before[0] + 1, before[1] + 1)
    plain = block(x)
    assert plain.requires_grad
    assert (to_windows.launches, from_windows.launches) == (before[0] + 1, before[1] + 1)
    _assert_close_rel(fused, plain.detach(), tol)


def _mlp_inputs(card, rng, rows, c, dtype):
    dev = lambda a: torch.from_numpy(a.astype(np.float32)).to(card)
    x = dev(rng.randn(rows, c)).to(dtype)
    params = (dev(rng.randn(c) * 0.1 + 1.0), dev(rng.randn(c) * 0.1),
              dev(rng.randn(4 * c, c) * 0.05), dev(rng.randn(4 * c) * 0.05),
              dev(rng.randn(c, 4 * c) * 0.05), dev(rng.randn(c) * 0.05))
    return x, params


# Row counts ragged against the bf16 tiles, per form (ops/swin_mlp.py::
# mlp_form). The fused kernel (C = 96, 192): 128-row tiles, one either side
# of 64 and of 128, and one row. The wide form (C = 384, 768, 1536): one
# row, one either side of 128 (a partial last tile of 128 rows; of 64 rows
# too at 129, for fc1's 64 x 192 tiles at C = 384), 65 (a partial 64-row
# tile), and Swin-T's and Swin-L's stage rows at 544, batch 16.
MLP_ROWS = [(c, rows) for c, first in ((96, 1000), (192, 203))
            for rows in (first, 1, 63, 65, 127, 129)] + \
    [(c, rows) for c in (384, 768, 1536) for rows in (1, 65, 127, 129)] + \
    [(384, 18496), (384, 73984), (768, 4624), (768, 18496), (1536, 4624)]
# The wide form's launches a call, by profiler name
MLP_WIDE_LAUNCHES = {'ln': r'mlp_wide_ln_kernel<', 'fc1': r'mlp_wide_gemm_kernel<\d+,\s*false>',
                     'fc2': r'mlp_wide_gemm_kernel<\d+,\s*true>'}


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


@pytest.mark.parametrize('c,rows,launch', [(96, 295936, 'fused'), (192, 1, 'fused'),
                                           (384, 73984, 'fc1'), (384, 73984, 'fc2'),
                                           (768, 18496, 'fc1'), (768, 18496, 'fc2'),
                                           (1536, 4624, 'fc1'), (1536, 4624, 'fc2'),
                                           (768, 1, 'fc2')])
def test_swin_mlp_geometry_covers_the_rows(card, c, rows, launch):
    assert mlp_form(c, torch.bfloat16) == ('fused' if launch == 'fused' else 'wide')
    geo = kernel_geometry(c, rows, launch)
    row_tiles = geo['tiles'] // geo['col_tiles']
    assert row_tiles * geo['col_tiles'] == geo['tiles']
    assert geo['rows_per_tile'] * row_tiles >= rows > geo['rows_per_tile'] * (row_tiles - 1)
    n = {'fused': c, 'fc1': 4 * c, 'fc2': c}[launch]
    assert geo['cols_per_tile'] * geo['col_tiles'] == n
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert 1 <= geo['blocks'] <= min(geo['tiles'], 2 * sms) and geo['threads'] % 32 == 0
    assert 0 < geo['smem_bytes'] <= 232448 and 0 < geo['registers'] <= 255
    with pytest.raises(RuntimeError):
        kernel_geometry(c, rows, 'fused' if launch != 'fused' else 'fc1')


@pytest.mark.parametrize('c,rows', [(96, 1000), (192, 1000), (384, 1000), (768, 1000),
                                    (1536, 1000), (384, 73984), (768, 18496), (1536, 4624)])
def test_swin_mlp_kernel_is_deterministic(card, c, rows):
    # no atomics and every sum in a fixed order: two launches, the same bits
    x, params = _mlp_inputs(card, np.random.RandomState(2), rows, c, torch.bfloat16)
    k1, k2 = params[2].bfloat16(), params[4].bfloat16()
    args = (x, params[0], params[1], k1, params[3], k2, params[5])
    first = mlp_block(*args)
    second = mlp_block(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize('c,rows', [(384, 18496), (768, 4624), (768, 18496), (1536, 4624),
                                    (192, 1000)])
def test_swin_mlp_wide_form_launches_ln_then_two_gemms(card, c, rows):
    """One call of the wide form launches mlp_wide_ln_kernel once and the
    GEMM kernel twice (fc1 then fc2), as the benchmark's swin_mlp_wide_roofline
    counts it; the fused form launches its one kernel and none of these. The
    profiler can drop a trace's kernel events: a trace that holds fewer
    kernels than the call launched is taken again, up to three times."""
    import re
    x, params = _mlp_inputs(card, np.random.RandomState(3), rows, c, torch.bfloat16)
    args = (x, params[0], params[1], params[2].bfloat16(), params[3], params[4].bfloat16(),
            params[5])
    wide = mlp_form(c, torch.bfloat16) == 'wide'
    mlp_block(*args)
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            mlp_block(*args)
            torch.cuda.synchronize()
        names = [e.name for e in sorted(prof.events(), key=lambda e: e.time_range.start)
                 if e.device_type == torch.autograd.DeviceType.CUDA and 'mlp_' in e.name]
        if len(names) >= (3 if wide else 1):
            break
    got = {k: sum(bool(re.search(pat, n)) for n in names) for k, pat in MLP_WIDE_LAUNCHES.items()}
    fused = sum('mlp_bf16_sm90_kernel' in n for n in names)
    if wide:
        assert got == {'ln': 1, 'fc1': 1, 'fc2': 1} and fused == 0, names
        order = [k for n in names for k, pat in MLP_WIDE_LAUNCHES.items() if re.search(pat, n)]
        assert order == ['ln', 'fc1', 'fc2'], names
    else:
        assert got == {'ln': 0, 'fc1': 0, 'fc2': 0} and fused == 1, names


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
@pytest.mark.parametrize('heads,nw', [(3, 25), (6, 4), (12, 4), (24, 9)])
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


def _attn_tile_case_params(card, rng, c, bnw, masked):
    """attn_block's arguments in bf16 for bnw windows of width c, every
    window an image of its own (nW = 1), with or without the region ids of
    the shifted 7x7 map."""
    from yolact_minimal_torch.models.swin import shifted_window_regions
    dev = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(card)
    heads = c // 32
    region = torch.from_numpy(shifted_window_regions(7, 7)).to(card) if masked else None
    return (dev(rng.randn(bnw, 49, c)).bfloat16(),
            dev(rng.randn(3 * c, c) * c ** -0.5).bfloat16(), dev(rng.randn(3 * c) * 0.05),
            dev(rng.randn(heads, 49, 49) * 0.1).bfloat16(), region,
            dev(rng.randn(c, c) * c ** -0.5).bfloat16(), dev(rng.randn(c) * 0.05), heads)


# Window counts against the bf16 launch: at C = 96 tiles of 3 windows on a
# grid of one block a multiprocessor (132 on an H100): one window, 2 and 4
# (partial last tiles), a count whose tiles leave blocks idle and one whose
# tiles take a second round with a partial last tile; at C = 192, 384, 768
# phase 1's warpgroups a head (66, 33, 10 on 132 multiprocessors) one either
# side and several rounds of them, and phase 2's groups of row tiles (a last
# partial tile and group, more groups than blocks).
def _attn_window_counts(c):
    if c in attn_block_ops.TILED_WINDOWS:
        g = attn_block_ops.TILED_WINDOWS[c]
        return sorted({1, g - 1, g + 1, 100 * g - 1, 133 * g + 1})
    slots = (132 // (c // 32)) * attn_block_ops.HEAD_SHAPES[c][0]
    return sorted({1, slots - 1, slots + 1, 3 * slots + 2, 301})


ATTN_TILE_CASES = [(c, bnw) for c in (96, 192, 384, 768) for bnw in _attn_window_counts(c)]


@pytest.mark.parametrize('c,bnw', ATTN_TILE_CASES)
@pytest.mark.parametrize('masked', [False, True])
def test_attn_block_kernel_matches_plain_on_partial_tiles(card, c, bnw, masked):
    args = _attn_tile_case_params(card, np.random.RandomState(6), c, bnw, masked)
    before = attn_block.launches
    got = attn_block(*args)
    torch.cuda.synchronize()
    assert attn_block.launches == before + 1
    ref = attn_block_plain(*args)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape == (bnw, 49, c)
    assert torch.isfinite(got.float()).all()
    _assert_close_rel(got, ref, 2.0 ** -7)


@pytest.mark.parametrize('c', [96, 192, 384, 768])
def test_attn_block_kernel_is_deterministic(card, c):
    # a fixed tile order and no atomics: two launches, the same bits
    args = _attn_tile_case_params(card, np.random.RandomState(7), c, 301, True)
    first = attn_block(*args)
    second = attn_block(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize('c', [96, 192, 384, 768])
def test_attn_block_kernel_is_built_as_the_geometry_assumes(card, c):
    attrs = attn_block_ops.kernel_attributes(c)
    sizes = attn_block_ops.shared_bytes(c)
    if c in attn_block_ops.TILED_WINDOWS:
        threads = (128 * attn_block_ops.TILED_WINDOWS[c],)
    else:
        rw, cs = attn_block_ops.PROJ_SHAPES[c][:2]
        threads = (128 * attn_block_ops.HEAD_SHAPES[c][0], 128 * rw * cs)
    assert len(attrs) == len(sizes) == len(threads)
    for a, smem, n in zip(attrs.values(), sizes, threads):
        assert a['threads'] == n and a['smem_bytes'] == smem <= 232448
        assert 0 < a['registers'] * a['threads'] <= 65536


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


def _tile_case_params(card, rng, c, bnw, masked, padded, dtype=torch.bfloat16):
    """swin_block's arguments for bnw windows of width c, every window an
    image of its own (nW = 1): the rowmask of a 5x6 map padded to 7x7, the
    region ids of the shifted 7x7 map, each or both left out."""
    from yolact_minimal_torch.models.swin import pad_rowmask, shifted_window_regions
    dev = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(card)
    heads = c // 32
    region = torch.from_numpy(shifted_window_regions(7, 7)).to(card) if masked else None
    rowmask = dev(pad_rowmask(5, 6, 7, 7, 3 if masked else 0)) if padded else None
    return (dev(rng.randn(bnw, 49, c)).to(dtype), rowmask,
            dev(rng.randn(c) * 0.1 + 1.0), dev(rng.randn(c) * 0.1),
            dev(rng.randn(3 * c, c) * c ** -0.5).to(dtype), dev(rng.randn(3 * c) * 0.05),
            dev(rng.randn(heads, 49, 49) * 0.1).to(dtype), region,
            dev(rng.randn(c, c) * c ** -0.5).to(dtype), dev(rng.randn(c) * 0.05),
            dev(rng.randn(c) * 0.1 + 1.0), dev(rng.randn(c) * 0.1),
            dev(rng.randn(4 * c, c) * c ** -0.5).to(dtype), dev(rng.randn(4 * c) * 0.05),
            dev(rng.randn(c, 4 * c) * (4 * c) ** -0.5).to(dtype), dev(rng.randn(c) * 0.05))


# Window counts against the tiled bf16 kernel's tiles of G windows
# (KERNEL_SHAPES) and its grid of one block a multiprocessor (132 on an
# H100): one window, G - 1 and G + 1 (partial last tiles), a count whose
# tiles leave blocks idle and one whose tiles take a second round with a
# partial last tile. C = 768 (the flat form, 49 bnw rows in tiles of 128 for
# each product): 1, 2, 99 and 134 windows as before, stage 3's 144 and 301;
# every count leaves a partial last row tile (49 bnw is no multiple of 128),
# and from 99 windows on each product takes more than one round of blocks.
TILE_CASES = [(c, bnw) for c in sorted(KERNEL_SHAPES)
              for g in (KERNEL_SHAPES[c][0],)
              for bnw in sorted({1, max(g - 1, 1), g + 1, 100 * g - 1, 133 * g + 1})] + \
    [(768, bnw) for bnw in (1, 2, 99, 134, 144, 301)]


@pytest.mark.parametrize('c,bnw', TILE_CASES)
@pytest.mark.parametrize('masked,padded', [(False, False), (True, False), (False, True),
                                           (True, True)])
def test_swin_block_kernel_matches_plain_on_partial_tiles(card, c, bnw, masked, padded):
    p = _tile_case_params(card, np.random.RandomState(4), c, bnw, masked, padded)
    before = swin_block.launches
    got = swin_block(*p, c // 32)
    torch.cuda.synchronize()
    assert swin_block.launches == before + 1
    ref = swin_block_plain(*p, c // 32)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape == (bnw, 49, c)
    assert torch.isfinite(got.float()).all()
    _assert_close_rel(got, ref, 2.0 ** -7)


@pytest.mark.parametrize('c', [96, 192, 384, 768])
def test_swin_block_kernel_is_deterministic(card, c):
    # a fixed tile order and no atomics: two launches, the same bits
    p = _tile_case_params(card, np.random.RandomState(5), c, 301, True, True)
    first = swin_block(*p, c // 32)
    second = swin_block(*p, c // 32)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize('c', [96, 192, 384, 768])
def test_swin_block_kernel_is_built_as_the_geometry_assumes(card, c):
    # each launch's tile shape as the wrapper's copy states it, its threads,
    # its shared memory as shared_bytes lays it out, its registers
    attrs = kernel_attributes(c)
    shapes = launch_shapes(c)
    assert list(attrs) == list(shapes) and len(shared_bytes(c)) == len(shapes)
    for (name, a), smem in zip(attrs.items(), shared_bytes(c)):
        shape = shapes[name]
        assert a['shape'] == shape
        # a warpgroup a window (times the warpgroups that split it) or a
        # head's warpgroup; the LayerNorms and products 256
        threads = 128 * shape[0] * shape[1] if name == 'tiled' else \
            128 * shape[0] if name == 'heads' else 256
        assert a['threads'] == threads and a['smem_bytes'] == smem <= 232448
        assert 0 < a['registers'] * a['threads'] <= 65536


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('form,expected', [('composed', [1, 1, 12, 12, 0, 0, 12, 12]),
                                           ('attn_block', [1, 1, 0, 12, 12, 0, 0, 0]),
                                           ('whole', [1, 1, 0, 0, 0, 12, 0, 0]),
                                           (('whole', 'whole', 'composed', 'composed'),
                                            [1, 1, 8, 8, 0, 4, 8, 8]),
                                           (('whole', 'attn_block', 'composed', 'composed'),
                                            [1, 1, 8, 10, 2, 2, 8, 8])])
def test_swin_detector_runs_the_kernels_of_its_form(card, form, expected, dtype):
    from yolact_minimal_torch.pipeline import Detector
    det = Detector(get_config('swin_tiny_coco', img_size=128, nms_score_thre=0.002,
                              compute_dtype=dtype))
    det.model.backbone.set_block_forms(form)
    images = torch.randn(2, 128, 128, 3, generator=torch.Generator().manual_seed(0))
    counters = (suppression_iou_max, mask_finalize, window_attention, mlp_block, attn_block,
                swin_block, to_windows, from_windows)
    before = [f.launches for f in counters]
    dets, masks = det.detect_fixed(images, 128)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(counters, before)] == expected
    assert masks.shape == (2, 100, 128, 128) and bool(dets.valid.all())


@pytest.mark.parametrize('name', ['res50_custom', 'res101_custom'])
def test_evaluate_on_the_card_equals_the_cpu(card, tmp_path, name):
    # float32, TF32 off (the card fixture): the eval tables of the card and
    # the CPU on one seeded .ckpt and the first 4 images of custom_dataset/,
    # and the slates behind them (ids and valid flags equal, scores and boxes
    # within 1e-6, masks parting in under 1e-4 of their pixels)
    from pathlib import Path

    from yolact_minimal_torch.eval import evaluate
    from yolact_minimal_torch.pipeline import Detector, load_detector
    from yolact_minimal_torch.utils.checkpoint import save_checkpoint
    from yolact_minimal_torch.utils.weights import to_jax_variables
    data = Path(__file__).resolve().parents[1] / 'custom_dataset'
    cfg = get_config(name, mode='val', img_size=256, val_num=4,
                     val_imgs=str(data / 'images'), val_ann=str(data / 'annotations.json'))
    path = str(tmp_path / f'seeded_{name}_0.ckpt')
    save_checkpoint(path, to_jax_variables(Detector(cfg, device='cpu', seed=0).model.state_dict()))
    gpu, cpu = load_detector(path, cfg, device=card), load_detector(path, cfg, device='cpu')
    logs = ([], [])
    for det, log in zip((gpu, cpu), logs):
        def record(dets, masks_proto, h, w, visual_thre=None, post=det.postprocess_host,
                   log=log):
            out = post(dets, masks_proto, h, w, visual_thre)
            log.append((dets, out))
            return out
        det.postprocess_host = record
    before = suppression_iou_max.launches
    on_card = evaluate(gpu, cfg, max_images=4)
    assert suppression_iou_max.launches == before + 1       # one batch of 8, 4 padded
    assert on_card == evaluate(cpu, cfg, max_images=4)
    assert len(logs[0]) == len(logs[1]) == 4
    for i, ((d, out), (rd, rout)) in enumerate(zip(*logs)):
        np.testing.assert_array_equal(d.valid.numpy(), rd.valid.numpy(), err_msg=f'image {i}')
        np.testing.assert_array_equal(d.ids.numpy(), rd.ids.numpy(), err_msg=f'image {i}')
        np.testing.assert_allclose(d.scores.numpy(), rd.scores.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(d.boxes.numpy(), rd.boxes.numpy(), rtol=0, atol=1e-6)
        assert out[3].shape == rout[3].shape and (out[3] != rout[3]).mean() < 1e-4, i


# --- training: kernels 3 and 4 under autograd, and a train step ----------------

# swin_tiny at 544, train_bs 8: (windows B*nW, windows an image nW, heads,
# MLP rows B*h*w) of stages 0-3
TRAIN_STAGES = [(3200, 400, 3, 147968), (800, 100, 6, 36992), (200, 25, 12, 9248),
                (72, 9, 24, 2312)]


@pytest.mark.parametrize('dtype,tol', SWIN_TOLS)
@pytest.mark.parametrize('bnw,nw,heads,rows', TRAIN_STAGES)
@pytest.mark.parametrize('masked', [False, True])
def test_window_attention_autograd_equals_plain(card, dtype, tol, bnw, nw, heads, rows, masked):
    """The kernel forward under autograd, and a backward that is the plain
    version's autograd: gradients equal to plain autograd's up to the
    forward tests' tolerance."""
    from yolact_minimal_torch.models.swin import shifted_window_regions
    rng = np.random.RandomState(2)
    c, side = heads * 32, int(nw ** 0.5) * 7
    qkv = torch.from_numpy(rng.randn(bnw, 49, 3 * c).astype(np.float32)).to(card, dtype)
    bias = torch.from_numpy((rng.randn(heads, 49, 49) * 0.1).astype(np.float32)).to(card, dtype)
    region = torch.from_numpy(shifted_window_regions(side, side)).to(card) if masked else None
    cot = torch.from_numpy(rng.randn(bnw, 49, c).astype(np.float32)).to(card, dtype)
    grads = []
    for fn in (window_attention, window_attention_plain):
        q, b = qkv.clone().requires_grad_(), bias.clone().requires_grad_()
        before = window_attention.launches
        out = fn(q, b, region, heads)
        out.backward(cot)
        torch.cuda.synchronize()
        assert window_attention.launches == before + (fn is window_attention)
        grads.append((out.detach(), q.grad, b.grad))
    for got, ref in zip(*grads):
        assert got.dtype == ref.dtype == dtype
        _assert_close_rel(got, ref, tol)


@pytest.mark.parametrize('dtype,tol', SWIN_TOLS)
@pytest.mark.parametrize('bnw,nw,heads,rows', TRAIN_STAGES)
def test_swin_mlp_autograd_equals_plain(card, dtype, tol, bnw, nw, heads, rows):
    rng = np.random.RandomState(3)
    c = heads * 32
    x, params = _mlp_inputs(card, rng, rows, c, dtype)
    params = list(params)
    params[2], params[4] = params[2].to(dtype), params[4].to(dtype)   # weights as swin casts them
    cot = torch.from_numpy(rng.randn(rows, c).astype(np.float32)).to(card, dtype)
    results = []
    for fn in (mlp_block, mlp_block_plain):
        leaves = [t.clone().requires_grad_() for t in [x] + params]
        before = mlp_block.launches
        out = fn(*leaves)
        out.backward(cot)
        torch.cuda.synchronize()
        assert mlp_block.launches == before + (fn is mlp_block)
        results.append([out.detach()] + [t.grad for t in leaves])
    for got, ref in zip(*results):
        assert got.dtype == ref.dtype
        _assert_close_rel(got, ref, tol)


def _train_block_case(card, dtype, bnw, nw, heads, seed):
    """Kernels 5 and 6's inputs at a training stage shape as models/swin.py
    hands them over (weights in the compute dtype), the shifted windows of a
    map padded by one row and column, and a cotangent."""
    from yolact_minimal_torch.models.swin import pad_rowmask, shifted_window_regions
    rng = np.random.RandomState(seed)
    c, side = heads * 32, int(nw ** 0.5) * 7
    dev = lambda *s, scale=1.0: torch.from_numpy(
        (rng.randn(*s) * scale).astype(np.float32)).to(card)
    region = torch.from_numpy(shifted_window_regions(side, side)).to(card)
    rowmask = torch.from_numpy(pad_rowmask(side - 1, side - 1, side, side, 3)).to(card)
    ln = (1 + dev(c, scale=0.1), dev(c, scale=0.1))
    attn = (dev(3 * c, c, scale=c ** -0.5).to(dtype), dev(3 * c, scale=0.05),
            dev(heads, 49, 49, scale=0.1).to(dtype), dev(c, c, scale=c ** -0.5).to(dtype),
            dev(c, scale=0.05))
    mlp = (dev(4 * c, c, scale=c ** -0.5).to(dtype), dev(4 * c, scale=0.05),
           dev(c, 4 * c, scale=(4 * c) ** -0.5).to(dtype), dev(c, scale=0.05))
    return dev(bnw, 49, c).to(dtype), region, rowmask, ln, attn, mlp, dev(bnw, 49, c).to(dtype)


def _hold_block_autograd(wrapper, plain, call, inputs, cot, dtype, tol):
    """call(f, *inputs) with f the kernel's wrapper and then its plain
    version: the kernel forward within `tol` of the plain one, one launch;
    its backward, the plain version recomputed under autograd, equal to
    plain autograd's bit for bit, in each input's dtype."""
    results = []
    for fn in (wrapper, plain):
        leaves = [t.clone().requires_grad_() for t in inputs]
        before = wrapper.launches
        out = call(fn, *leaves)
        out.backward(cot)
        torch.cuda.synchronize()
        assert wrapper.launches == before + (fn is wrapper)
        results.append((out.detach(), [t.grad for t in leaves]))
    (out, grads), (ref, ref_grads) = results
    assert out.dtype == ref.dtype == dtype
    _assert_close_rel(out, ref, tol)
    for t, g, r in zip(inputs, grads, ref_grads):
        assert g.dtype == t.dtype and torch.equal(g, r)


@pytest.mark.parametrize('dtype,tol', SWIN_TOLS)
@pytest.mark.parametrize('bnw,nw,heads,rows', TRAIN_STAGES)
def test_attn_block_autograd_equals_plain(card, dtype, tol, bnw, nw, heads, rows):
    x, region, _, _, attn, _, cot = _train_block_case(card, dtype, bnw, nw, heads, 4)
    _hold_block_autograd(
        attn_block, attn_block_plain,
        lambda f, x, wq, bq, b, wp, bp: f(x, wq, bq, b, region, wp, bp, heads),
        (x,) + attn, cot, dtype, tol)


@pytest.mark.parametrize('dtype,tol', SWIN_TOLS)
@pytest.mark.parametrize('bnw,nw,heads,rows', TRAIN_STAGES)
def test_swin_block_autograd_equals_plain(card, dtype, tol, bnw, nw, heads, rows):
    x, region, rowmask, ln, attn, mlp, cot = _train_block_case(card, dtype, bnw, nw, heads, 5)
    _hold_block_autograd(
        swin_block, swin_block_plain, lambda f, x, l1s, l1b, wq, bq, b, wp, bp, *rest:
        f(x, rowmask, l1s, l1b, wq, bq, b, region, wp, bp, *rest, heads),
        (x,) + ln + attn + ln + mlp, cot, dtype, tol)


def _res50_train_case():
    """res50_custom at 128, train_bs 2, and one seeded batch of distinct
    rows (tests/test_torch_train_step.py's)."""
    cfg = get_config('res50_custom', mode='train', img_size=128, max_gt=4, train_bs=2,
                     base_lr=0.1)
    rng = np.random.RandomState(3)
    xy1 = rng.uniform(0, 0.5, size=(2, 4, 2)).astype(np.float32)
    wh = rng.uniform(0.2, 0.45, size=(2, 4, 2)).astype(np.float32)
    batch = dict(image=rng.randn(2, 128, 128, 3).astype(np.float32),
                 boxes=np.concatenate([xy1, xy1 + wh], 2),
                 labels=rng.randint(0, 4, size=(2, 4)).astype(np.int32),
                 valid=np.ones((2, 4), bool),
                 masks_proto=(rng.rand(2, 4, 32, 32) > 0.5).astype(np.uint8),
                 masks_seg=(rng.rand(2, 4, 16, 16) > 0.5).astype(np.uint8))
    return cfg, batch


def test_res50_train_step_on_the_card_equals_the_cpu(card):
    """One res50_custom float32 step at 128, train_bs 2, from one seeded
    init on the same batch, TF32 off: losses within 1e-4 relative; the
    running statistics within 1e-3 of their largest magnitude; each
    gradient and updated parameter (L2 norm) within twice the CPU float32
    step's own error plus 1e-5 of its norm, that error being its distance
    from the same step in float64. Training-mode BatchNorm at a random init
    amplifies float32 rounding (tests/test_torch_train_step.py): the CPU's
    float32 gradients lie 4e-4 (coefficient head) to 4.5e-2 (backbone
    BatchNorm) from float64's (measured), and the card rounds at other
    places, so card and CPU may each lie about that far from it."""
    from yolact_minimal_torch.train_state import create_train_state, train_step
    cfg, batch = _res50_train_case()
    runs = {}
    for where in ('cuda', 'cpu', 'cpu64'):
        state = create_train_state(cfg, 'cuda' if where == 'cuda' else 'cpu', seed=0)
        b = batch
        if where == 'cpu64':
            state.model.double()
            b = dict(batch, image=batch['image'].astype(np.float64))
        losses = train_step(state, b)
        runs[where] = ([float(t) for t in losses],
                       {k: p.grad.detach().cpu() for k, p in state.model.named_parameters()},
                       {k: v.detach().cpu() for k, v in state.model.state_dict().items()})
    np.testing.assert_allclose(runs['cuda'][0], runs['cpu'][0], rtol=1e-4)
    over, worst = [], (0.0, '')
    for i, what in ((1, 'gradient'), (2, 'updated')):
        for k, ref in runs['cpu'][i].items():
            got = runs['cuda'][i][k]
            if k.endswith('num_batches_tracked'):
                assert torch.equal(got, ref)
            elif k.endswith(('running_mean', 'running_var')):
                _assert_close_rel(got, ref, 1e-3)
            else:
                gap = (got - ref).norm().item()
                floor = (runs['cpu64'][i][k].float() - ref).norm().item()
                allowed = 2 * floor + 1e-5 * ref.norm().item()
                worst = max(worst, (gap / allowed, f'{what} {k}'))
                if gap > allowed:
                    over.append(f'{what} {k}: {gap:.3g} > {allowed:.3g} (norm '
                                f'{ref.norm().item():.3g})')
    print(f'largest gap / allowed: {worst[0]:.3f} ({worst[1]})')
    assert not over, '; '.join(over)


def test_res50_near_identity_train_step_on_the_card_equals_the_cpu(card):
    """The well-conditioned step of tests/test_torch_train_step.py (every
    bottleneck's bn3 scale at 0.02 of the seeded init) in float32, TF32
    off, on the card and on the CPU: losses within 1e-4 relative; the
    running statistics within 1e-4 of their largest magnitude; the
    gradients and the updates of each part of the network (backbone, fpn,
    proto_net, prediction_layers, semantic_seg_conv) within 1e-4 of the
    CPU's in L2 norm, each tensor within 1e-2 (a ReLU input that rounding
    moves across 0 changes the layers below it), an update's allowance
    plus the float32 spacing of its parameter. On the CPU this float32
    step lies within 5e-6 of its float64 one a part and 9.4e-5 a tensor
    (measured)."""
    from yolact_minimal_torch.train_state import create_train_state, train_step
    cfg, batch = _res50_train_case()
    runs = {}
    for where in ('cuda', 'cpu'):
        state = create_train_state(cfg, where, seed=0)
        with torch.no_grad():
            for name, p in state.model.named_parameters():
                if name.endswith('bn3.weight'):
                    p.mul_(0.02)
        before = {k: p.detach().cpu().clone() for k, p in state.model.named_parameters()}
        losses = train_step(state, batch)
        runs[where] = ([float(t) for t in losses],
                       {k: p.grad.detach().cpu() for k, p in state.model.named_parameters()},
                       {k: p.detach().cpu() - before[k]
                        for k, p in state.model.named_parameters()},
                       {k: v.detach().cpu() for k, v in state.model.state_dict().items()
                        if k.endswith(('running_mean', 'running_var'))},
                       {k: p.detach().cpu().numpy() for k, p in state.model.named_parameters()})
    np.testing.assert_allclose(runs['cuda'][0], runs['cpu'][0], rtol=1e-4)
    for k, ref in runs['cpu'][3].items():
        _assert_close_rel(runs['cuda'][3][k], ref, 1e-4)
    for i, what in ((1, 'gradient'), (2, 'update')):
        parts, worst = {}, (0.0, '')
        for k, ref in runs['cpu'][i].items():
            gap, norm = (runs['cuda'][i][k] - ref).norm().item(), ref.norm().item()
            # an update is resolved no finer than the float32 spacing of the
            # parameter that stores it
            slack = 0.0 if i == 1 else float(np.linalg.norm(np.spacing(runs['cpu'][4][k])))
            worst = max(worst, (gap / max(norm, 1e-30), k))
            assert gap <= 1e-2 * norm + slack, f'{what} {k}: {gap:.3g} of {norm:.3g}'
            sums = parts.setdefault(k.split('.')[0], np.zeros(3))
            sums += (gap * gap, norm * norm, slack * slack)
        print(f'{what}: parts', {part: f'{np.sqrt(d2 / n2):.3g}'
                                 for part, (d2, n2, _) in parts.items()},
              f'largest tensor {worst[0]:.3g} ({worst[1]})')
        over = {part: np.sqrt(d2 / n2) for part, (d2, n2, e2) in parts.items()
                if np.sqrt(d2) > 1e-4 * np.sqrt(n2) + np.sqrt(e2)}
        assert not over, f'{what}: {over}'


@pytest.mark.parametrize('name,dtype', [('res50_coco', 'float32'),
                                        ('swin_tiny_coco', 'bfloat16')])
def test_traditional_detector_on_the_card_equals_the_cpu_tail(card, name, dtype):
    """--traditional_nms on the card: the forward and decode there, then the
    host tail; the slate equals the tail of a CPU Detector on the same raw
    outputs, kernel 1 is not launched, and swin's blocks launch kernel 3
    once each."""
    from yolact_minimal_torch.pipeline import Detector, _to_host
    cfg = get_config(name, img_size=128, traditional_nms=True, nms_score_thre=0.012,
                     compute_dtype=dtype)
    det = Detector(cfg, seed=0)
    cpu = Detector(cfg, det.model.state_dict(), device='cpu')
    images = torch.randn(2, 128, 128, 3, generator=torch.Generator().manual_seed(1))
    recorded, infer_raw = [], det._infer_raw
    det._infer_raw = lambda x: recorded.append(infer_raw(x)) or recorded[-1]
    s0, w0 = suppression_iou_max.launches, window_attention.launches
    dets, masks_proto, proto = det(images)
    assert suppression_iou_max.launches == s0
    assert window_attention.launches - w0 == (12 if name.startswith('swin') else 0)
    assert int(dets.valid.sum()) > 0
    tail = cpu.traditional_tail(*_to_host(recorded[0]))
    for got, want in zip((*dets, masks_proto, proto), (*tail[0], *tail[1:])):
        assert got.device.type == 'cpu' and torch.equal(got, want)


# A remat step against the plain step on the card, per part of the network
# in L2: float32 within 1e-4, the card-against-CPU tolerance of the
# near-identity res50 step (measured 4.5e-7, as two plain steps differ:
# the bilinear backward sums with atomics); bf16 within 2^-7, one bf16 ulp,
# since a float32-sized change flips roundings that move the backbone's
# gradient by ~5e-3 (measured 4.6e-3 against plain in two runs and 0 in a
# third, and 4.85e-3 between two plain steps run before and after a remat
# one).
REMAT_PART_TOL = {'float32': 1e-4, 'bfloat16': 2.0 ** -7}


@pytest.mark.parametrize('dtype', ['bfloat16', 'float32'])
def test_remat_swin_step_on_the_card_equals_the_plain_step(card, dtype):
    """A swin_tiny_custom step at 128, train_bs 2, with cfg.remat against
    the plain step from the same seeded init on the same batch (the step
    generator seeded alike, drop_path on): the losses within 1e-4 relative,
    each gradient within 1e-2 of its norm and each part's (backbone, fpn,
    ...) within REMAT_PART_TOL of its norm in L2; kernels 3 and 4 launch
    twice as often (the recompute), kernel 3's backward kernel once a launch
    of the plain step in bf16 (the float32 backward recomputes plainly). And
    a res50 remat step's losses within 1e-3 relative of the plain step's,
    its BatchNorm counters risen by one."""
    from yolact_minimal_torch.train_state import create_train_state, train_step
    _, batch = _res50_train_case()
    runs = []
    for remat in (False, True):
        cfg = get_config('swin_tiny_custom', mode='train', img_size=128, max_gt=4, train_bs=2,
                         compute_dtype=dtype, remat=remat)
        state = create_train_state(cfg, card, seed=0)
        w0, m0, b0 = (window_attention.launches, mlp_block.launches,
                      window_attention.backward_launches)
        losses = train_step(state, batch)
        torch.cuda.synchronize()
        runs.append(([float(t) for t in losses],
                     {k: p.grad.detach().cpu().float() for k, p in state.model.named_parameters()},
                     (window_attention.launches - w0, mlp_block.launches - m0,
                      window_attention.backward_launches - b0)))
    (plain, grads, plain_launches), ours = runs
    backward = 12 if dtype == 'bfloat16' else 0
    assert plain_launches == (12, 1, backward) and ours[2] == (24, 2, backward)
    np.testing.assert_allclose(ours[0], plain, rtol=1e-4)
    parts = {}
    for k, ref in grads.items():
        gap, norm = (ours[1][k] - ref).norm().item(), ref.norm().item()
        assert gap <= 1e-2 * norm, f'gradient {k}: {gap:.3g} of {norm:.3g}'
        sums = parts.setdefault(k.split('.')[0], np.zeros(2))
        sums += (gap * gap, norm * norm)
    print(f'{dtype}: remat against plain, per part:',
          {part: f'{np.sqrt(g2 / n2):.3g}' for part, (g2, n2) in parts.items()})
    over = {part: np.sqrt(g2 / n2) for part, (g2, n2) in parts.items()
            if np.sqrt(g2) > REMAT_PART_TOL[dtype] * np.sqrt(n2)}
    assert not over, over
    cfg, batch = _res50_train_case()
    res50 = []
    for remat in (False, True):
        state = create_train_state(cfg.replace(remat=remat, compute_dtype=dtype), card, seed=0)
        res50.append([float(t) for t in train_step(state, batch)])
    np.testing.assert_allclose(res50[1], res50[0], rtol=1e-3)
    counts = {int(v) for k, v in state.model.state_dict().items()
              if k.endswith('num_batches_tracked')}
    assert counts == {1}


# --- the registered operators and an exported program ------------------------------

MIXED = ('whole', 'attn_block', 'composed', 'composed')


def _op_args(name, dev, dtype, grad=False):
    """Operator `name`'s inputs at stage 0's widths (C = 96, 3 heads) for two
    images of a 12 x 12 map padded to 14 x 14, shifted: 8 windows, 288 rows."""
    from yolact_minimal_torch.models.swin import pad_rowmask, shifted_window_regions
    g = torch.Generator().manual_seed(7)
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=g) * scale).to(dev)
    c, heads = 96, 3
    region = torch.from_numpy(shifted_window_regions(14, 14)).to(dev)
    rowmask = torch.from_numpy(pad_rowmask(12, 12, 14, 14, 3)).to(dev)
    bias = r(heads, 49, 49, scale=0.5).to(dtype)
    ln = (1 + r(c, scale=0.1), r(c, scale=0.1))
    mlp = (r(4 * c, c, scale=0.05).to(dtype), r(4 * c, scale=0.05),
           r(c, 4 * c, scale=0.05).to(dtype), r(c, scale=0.05))
    attn = (r(3 * c, c, scale=0.05).to(dtype), r(3 * c, scale=0.05), bias, region,
            r(c, c, scale=0.05).to(dtype), r(c, scale=0.05))
    leaf = lambda t: t.requires_grad_() if grad else t
    leaves = lambda ts: tuple(leaf(t) if t is not None and t.is_floating_point() else t
                              for t in ts)
    return {'window_attention': lambda: (leaf(r(8, 49, 3 * c).to(dtype)), leaf(bias.clone()),
                                         region, heads),
            'mlp_block': lambda: tuple(leaf(t) for t in (r(288, c).to(dtype),) + ln + mlp),
            'attn_block': lambda: leaves((r(8, 49, c).to(dtype),) + attn) + (heads,),
            'swin_block': lambda: (leaf(r(8, 49, c).to(dtype)), rowmask) +
            leaves(ln + attn + ln + mlp) + (heads,)}[name]()


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('name', ['window_attention', 'mlp_block', 'attn_block', 'swin_block'])
def test_registered_op_on_the_card_passes_opcheck(card, name, dtype):
    """Each operator's CUDA implementation against its fake (shape, dtype and
    strides of the output) and its schema, also with inputs that need a
    gradient. The operator launches the kernel once a call and gives the
    wrapper's bits."""
    wrapper = {'window_attention': window_attention, 'mlp_block': mlp_block,
               'attn_block': attn_block, 'swin_block': swin_block}[name]
    op = getattr(torch.ops.yolact_torch, name)
    cases = [(_op_args(name, card, dtype), ('test_schema', 'test_faketensor')),
             (_op_args(name, card, dtype, grad=True),
              ('test_schema', 'test_faketensor', 'test_autograd_registration'))]
    for args, utils in cases:
        result = torch.library.opcheck(op, args, test_utils=utils)
        assert set(result.values()) == {'SUCCESS'}, result
    args = cases[0][0]
    before = wrapper.launches
    out = op(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert torch.equal(out, wrapper(*args))


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('name', ['to_windows', 'from_windows'])
def test_glue_op_on_the_card_passes_opcheck(card, name, dtype):
    """Each glue operator's CUDA implementation against its fake and its
    schema (no backward: the kernels have none). The operator launches the
    kernel once a call and gives the wrapper's bits."""
    g = torch.Generator().manual_seed(8)
    x = torch.randn(2, 12, 12, 96, generator=g).to(card, dtype)
    scale, bias = (1 + torch.randn(96, generator=g) * 0.1).to(card), torch.zeros(96, device=card)
    y = torch.randn(8, 49, 96, generator=g).to(card, dtype)
    wrapper, args = {'to_windows': (to_windows, (x, scale, bias, 7, 3)),
                     'from_windows': (from_windows, (y, x, 7, 3))}[name]
    op = getattr(torch.ops.yolact_torch, name)
    result = torch.library.opcheck(op, args, test_utils=('test_schema', 'test_faketensor'))
    assert set(result.values()) == {'SUCCESS'}, result
    before = wrapper.launches
    out = op(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert torch.equal(out, wrapper(*args))


def test_bf16_swin_artifact_on_the_card_equals_its_live_model(card, tmp_path):
    """swin_tiny_coco at 128 px in bf16 and the 'mixed' forms: the artifact
    launches each swin kernel as the live forward does (the glue kernels in
    the 'composed' stages' 8 blocks) and gives its bits."""
    from yolact_minimal_torch import deploy
    from yolact_minimal_torch.pipeline import Detector
    cfg = get_config('swin_tiny_coco', img_size=128, compute_dtype='bfloat16')
    det = Detector(cfg, seed=0)
    det.model.backbone.set_block_forms(MIXED)
    path = deploy.export_model(cfg, det.model, str(tmp_path / 'swin.pt2'), batch=2)
    call, meta, _ = deploy.load_exported(path)
    assert meta['block_forms'] == list(MIXED) and meta['device'] == 'cuda'
    images = torch.randn(2, 128, 128, 3, generator=torch.Generator().manual_seed(1)).to(card)
    with torch.inference_mode():
        live = det.model(images)
    counters = (window_attention, mlp_block, attn_block, swin_block, to_windows, from_windows)
    before = [f.launches for f in counters]
    outs = call(images)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(counters, before)] == [8, 10, 2, 2, 8, 8]
    for a, b in zip(live, outs):
        assert torch.equal(a, b)


# --- data parallelism ----------------------------------------------------------------

def test_one_process_nccl_step_equals_the_plain_step(card):
    """The res50 float32 step of `_res50_train_case` in a one-process nccl
    world (parallel/mesh.py, as the train CLI joins one) against the step
    without a process group, from one seeded init: the losses within 1e-4
    relative, each part's gradient within REMAT_PART_TOL['float32'] of its
    norm (two plain float32 steps on the card differ by ~4.5e-7: the
    bilinear backward sums with atomics)."""
    import socket
    from yolact_minimal_torch.parallel import mesh
    from yolact_minimal_torch.train_state import create_train_state, train_step
    cfg, batch = _res50_train_case()
    runs = []
    for joined in (False, True):
        if joined:
            with socket.socket() as s:
                s.bind(('127.0.0.1', 0))
                port = s.getsockname()[1]
            assert mesh.initialize_distributed(f'127.0.0.1:{port}', 1, 0)
        try:
            if joined:
                assert mesh.dist.get_backend() == 'nccl' and mesh.process_count() == 1
            state = create_train_state(cfg, card, seed=0)
            losses = train_step(state, batch)
            torch.cuda.synchronize()
            runs.append(([float(t) for t in losses],
                         {k: p.grad.detach().cpu() for k, p in state.model.named_parameters()}))
        finally:
            mesh.destroy()
    (plain, grads), (ours, ours_grads) = runs
    np.testing.assert_allclose(ours, plain, rtol=1e-4)
    parts = {}
    for k, ref in grads.items():
        sums = parts.setdefault(k.split('.')[0], np.zeros(2))
        sums += ((ours_grads[k] - ref).norm().item() ** 2, ref.norm().item() ** 2)
    over = {part: np.sqrt(g2 / n2) for part, (g2, n2) in parts.items()
            if np.sqrt(g2) > REMAT_PART_TOL['float32'] * np.sqrt(n2)}
    assert not over, over


def test_mesh_of_one_detector_equals_the_plain_detector(card):
    """Detector(mesh=make_mesh(1)) on the card: the plain Detector's slate,
    masks and prototypes at tests/test_dp_eval.py's tolerances, kernel 1
    launched."""
    from yolact_minimal_torch.parallel.mesh import make_mesh
    from yolact_minimal_torch.pipeline import Detector
    cfg = get_config('res50_coco', img_size=128, nms_score_thre=0.012)
    plain = Detector(cfg, seed=0)
    dp = Detector(cfg, seed=0, mesh=make_mesh(1))
    assert dp.device == torch.device('cuda', 0) and len(dp.replicas) == 1
    images = torch.randn(2, 128, 128, 3, generator=torch.Generator().manual_seed(1))
    before = suppression_iou_max.launches
    ours, masks, proto = dp(images)
    assert suppression_iou_max.launches == before + 1
    ref, ref_masks, ref_proto = plain(images)
    assert int(ref.valid.sum()) > 0
    assert torch.equal(ours.ids, ref.ids) and torch.equal(ours.valid, ref.valid)
    torch.testing.assert_close(ours.scores, ref.scores, rtol=0, atol=1e-6)
    torch.testing.assert_close(ours.boxes, ref.boxes, rtol=0, atol=1e-6)
    torch.testing.assert_close(masks, ref_masks, rtol=0, atol=1e-5)
    torch.testing.assert_close(proto, ref_proto, rtol=0, atol=1e-5)
