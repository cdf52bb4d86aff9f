"""The port's swin at window 12 (Swin-L's) against the benchmark's plain
float32 reference (`benchmark/reference/yolact_window.py`, which imports
nothing of the port), on the CPU: the 144-token tables, the block forms
that cannot run it, the backbone and the YOLACT forward, and train_step's
first losses and gradients. Swin-L's published widths are held on the card
(tests/test_torch_cuda.py); here the depths are cut to (2, 2, 2, 2) and the
widths to C = 64 (heads of width 32 as published), at 128 px, where the
sides 32 / 16 / 8 / 4 pad to 36 / 24 / 12 / 12, so that padding, the shift
and the regions all happen."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.core import cell as cells, traffic, weights_window
from benchmark.reference import swin as ref_swin
from benchmark.reference.yolact_window import Yolact as Reference
from yolact_minimal_torch import config
from yolact_minimal_torch.config import get_config
from yolact_minimal_torch.models import swin
from yolact_minimal_torch.models.yolact import Yolact
from yolact_minimal_torch.utils import trace

torch.set_num_threads(1)

CPU = torch.device('cpu')
IMG = 128
SMALL = dict(embed_dim=64, depths=(2, 2, 2, 2), num_heads=(2, 4, 8, 16), window=12,
             drop_path_rate=0.3)
# float32 on both sides, the same operations in another summation order:
# each output within 1e-4 of its own largest magnitude, as the port's other
# float32 swin tests hold it.
REL_TOL = 1e-4


def _config_file():
    return json.loads((Path(__file__).resolve().parents[1] / 'benchmark' / 'configs' /
                       'swin_large_coco.json').read_text())


@pytest.fixture
def small(monkeypatch):
    """swin_large with SMALL's depths and widths, on the port's side and in
    the configuration file's `model` group."""
    monkeypatch.setitem(config.SWIN_SPECS, 'swin_large', SMALL)
    conf = _config_file()
    conf['model']['backbone'].update(embed_dim=SMALL['embed_dim'], depths=list(SMALL['depths']),
                                     num_heads=list(SMALL['num_heads']))
    return conf


def test_window_12_tables_equal_the_reference():
    idx = swin.relative_position_index(12)
    assert idx.shape == (144, 144) and idx.min() == 0 and idx.max() == 23 * 23 - 1
    np.testing.assert_array_equal(idx, ref_swin.relative_index(12).numpy())
    for hp, wp in ((36, 24), (144, 144), (12, 12)):
        regions = swin.shifted_window_regions(hp, wp, 12, 6)
        assert regions.shape == (hp // 12 * (wp // 12), 144) and regions.dtype == np.int32
        assert set(np.unique(regions)) <= set(range(9))
        np.testing.assert_array_equal(regions, ref_swin.region_ids(hp, wp, 12, 6).numpy())
    # a stage-3 map of Swin-L at 544: 17 x 17 padded to 24, rolled by 6
    mask = swin.pad_rowmask(17, 17, 24, 24, 6, 12)
    assert mask.shape == (4, 144) and mask.sum() == 17 * 17


@pytest.mark.parametrize('bnw,heads', [(2304, 6), (576, 12), (64, 48), (1, 6), (7, 48)])
def test_the_144_token_kernels_geometry_deals_each_window_once(bnw, heads):
    """Swin-L's stages at b16 and window counts that leave groups idle, on a
    card of 132 multiprocessors: every block of a head together walks each
    window once, and every block has a window."""
    from yolact_minimal_torch.ops.window_attention import wide_geometry
    geo = wide_geometry(bnw, heads, 132)
    assert geo.blocks == geo.per_head * heads <= max(132, heads)
    for head in range(heads):
        walked = sorted(w for b in range(head, geo.blocks, heads)
                        for g in range(geo.per_block) for w in geo.windows(b, g))
        assert walked == list(range(bnw))
    assert all(geo.windows(b, 0) for b in range(geo.blocks))


@pytest.mark.parametrize('forms', ['attn_block', 'whole',
                                   ('whole', 'composed', 'composed', 'composed'),
                                   ('composed', 'composed', 'composed', 'attn_block')])
def test_fused_block_forms_at_window_12_raise(forms):
    model = swin.Swin(**SMALL)
    with pytest.raises(ValueError, match='use .composed.'):
        model.set_block_forms(forms)
    model.set_block_forms('composed')
    assert model.block_forms() == ('composed',) * 4


def _pair(conf, train):
    cfg = get_config('swin_large_coco', mode='train' if train else 'detect', img_size=IMG)
    prog = Yolact(cfg, train_mode=train)
    sd = weights_window.make_state_dict(conf['model'], train, 7, CPU)
    prog.load_state_dict(sd, strict=True)
    ref = Reference(conf['model'], train_mode=train)
    ref.load_state_dict(sd, strict=True)
    return prog, ref


def _assert_rel(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert (g - w).abs().max() <= REL_TOL * w.abs().max()


def test_backbone_and_forward_equal_the_reference_in_float32(small):
    prog, ref = _pair(small, False)
    img = traffic.images(2, IMG, traffic.generator(3, CPU), CPU)
    with torch.no_grad():
        _assert_rel(prog.backbone.eval()(img), ref.backbone.eval()(img))
        _assert_rel(prog.eval()(img), ref.eval()(img))


def test_train_step_losses_and_gradients_equal_the_reference(small, monkeypatch):
    """The benchmark's train entry on this reference: the program's first
    three steps (losses, the first gradient, the change) against the
    reference's, stochastic depth drawn alike."""
    from benchmark.entries import train
    monkeypatch.setattr(train, 'weights', weights_window)
    monkeypatch.setattr(train, 'Reference', Reference)
    cell = cells.Cell(name='swin_large_coco.train', config=small,
                      traffic=cells.load_json(cells.HERE / 'traffic' / 'train_b64.json'),
                      limits={}, end_to_end=[], per_layer=[], chips=1,
                      overrides=dict(img_size=IMG, batch=2, compute_dtype='float32'))
    session = train.setup(cell, 2 ** 33 + 5, CPU)
    session.release()
    values = session.judge()
    assert values['loss_gap'] < 1e-5 and values['grad_gap'] < 1e-5, values
    assert values['update_gap'] < 1e-3, values


def test_pad_counters_count_the_rows_and_the_windows_rows(small):
    trace.reset()
    model = swin.Swin(**SMALL).eval()
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        model(torch.randn(2, IMG, IMG, 3))
    counts = trace.counts()
    trace.reset()
    sides, padded = (32, 16, 8, 4), (36, 24, 12, 12)
    assert counts['swin.rows'] == sum(2 * 2 * s * s for s in sides)
    assert counts['swin.window_rows'] == sum(2 * 2 * p * p for p in padded)
