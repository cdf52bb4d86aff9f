"""The benchmark's counts: kernel bounds at hand-worked shapes, each the
least work the launch needs, and the model's operations by
FlopCounterMode against a count of every product by hand."""
import pytest
import torch

from _util import small_cell

from benchmark.reference.layers import Conv, Linear
from benchmark.reference.yolact import Yolact
from benchmark.roofline import flops, kernels, peaks

SWIN = small_cell('swin_tiny_coco.detect_b16').config['model']
RES50 = small_cell('res50_coco.detect_b16').config['model']


def test_mask_finalize_bound_at_the_detect_cell():
    n_bytes, n_ops = kernels.mask_finalize(16, 100, 136, 136, 32, 544)
    # proto float32 once, coefs and boxes float32, valid bytes, the bool masks once
    assert n_bytes == 16 * 136 * 136 * 32 * 4 + 16 * 100 * (32 + 4) * 4 + 16 * 100 \
        + 16 * 100 * 544 * 544
    assert peaks.bound_s(n_bytes, n_ops, peaks.FLOAT32_FLOPS) * 1e3 == \
        pytest.approx(0.15272, abs=5e-6)


def test_swin_stage_geometry_at_544():
    st = kernels.swin_stages(SWIN, 16, 544)
    assert [s['side'] for s in st] == [136, 68, 34, 17]
    assert [s['padded'] for s in st] == [140, 70, 35, 21]
    assert [s['n_win'] for s in st] == [400, 100, 25, 9]
    assert [s['c'] for s in st] == [96, 192, 384, 768]
    assert kernels.swin_stages(RES50, 16, 544) is None


def test_window_attention_bound_at_stage_0():
    s = kernels.swin_stages(SWIN, 16, 544)[0]
    n_bytes, n_ops = kernels.window_attention(s['windows'], s['n_win'], s['heads'], s['c'], True)
    rows = 6400 * 49
    assert n_bytes == 2 * (rows * 288 + rows * 96 + 3 * 49 * 49) + 4 * 400 * 49
    assert n_ops == 2 * 2 * rows * 49 * 96        # q k^T and p v, a multiply-add two
    assert peaks.bound_s(n_bytes, n_ops) * 1e3 == pytest.approx(0.07192, abs=5e-6)
    unshifted, _ = kernels.window_attention(s['windows'], s['n_win'], s['heads'], s['c'], False)
    assert n_bytes - unshifted == 4 * 400 * 49


@pytest.mark.parametrize('stage', range(4))
def test_swin_mlp_bound_is_the_same_at_every_stage(stage):
    s = kernels.swin_stages(SWIN, 16, 544)[stage]
    n_bytes, n_ops = kernels.swin_mlp(s['rows'], s['c'])
    assert n_ops == 2 * 2 * s['rows'] * s['c'] * 4 * s['c']
    assert n_bytes == 2 * (2 * s['rows'] * s['c'] + 8 * s['c'] ** 2) + 4 * 7 * s['c']
    assert peaks.bound_s(n_bytes, n_ops) * 1e3 == pytest.approx(0.04412, abs=5e-6)


def _products_by_hand(model_spec, batch, size):
    """2 * multiply-adds of every convolution, linear layer and attention
    product of the reference's eval forward, from hooks on its modules."""
    with torch.device('meta'):
        model = Yolact(model_spec).eval()
    total = [0]

    def conv_hook(mod, args, out):
        k = mod.weight.shape[1] * mod.weight.shape[2] * mod.weight.shape[3]
        total[0] += 2 * out.numel() * k

    def linear_hook(mod, args, out):
        total[0] += 2 * out.numel() * mod.weight.shape[1]

    for m in model.modules():
        if isinstance(m, Conv):
            m.register_forward_hook(conv_hook)
        elif isinstance(m, Linear):
            m.register_forward_hook(linear_hook)
    with torch.device('meta'):
        model(torch.empty(batch, size, size, 3))
    if model_spec['backbone']['kind'] == 'swin':
        for s in kernels.swin_stages(model_spec, batch, size):
            total[0] += s['depth'] * 4 * s['windows'] * 49 * 49 * s['c']
    return total[0]


@pytest.mark.parametrize('spec', (RES50, SWIN), ids=('res50', 'swin'))
def test_model_operations_are_every_product_once(spec):
    assert flops.forward(spec, 2, 96) == _products_by_hand(spec, 2, 96)


def _first_conv(model_spec, batch, size):
    """The products of the network's first layer, whose input (the image)
    needs no gradient."""
    with torch.device('meta'):
        model = Yolact(model_spec, train_mode=True)
        first = next(m for m in model.modules() if isinstance(m, Conv))
        seen = []
        first.register_forward_hook(lambda m, a, out: seen.append(out.numel()))
        model(torch.empty(batch, size, size, 3))
    w = first.weight.shape
    return 2 * seen[0] * w[1] * w[2] * w[3]


@pytest.mark.parametrize('spec', (RES50, SWIN), ids=('res50', 'swin'))
def test_training_operations_are_the_forward_and_its_backward(spec):
    """Each product's backward takes it twice (to the weight, to the input),
    once only where the input is the image; recompute is not counted."""
    forward = flops._count(spec, 2, 96, False)
    train = flops.train_step(spec, 2, 96)
    semantic = 2 * 2 * 12 * 12 * 256 * (spec['num_classes'] - 1)     # 1x1 on P3 at 96 / 8
    assert train == 3 * (forward + semantic) - _first_conv(spec, 2, 96)
