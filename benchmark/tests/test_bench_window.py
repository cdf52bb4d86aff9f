"""The benchmark's pieces for a swin whose window comes from the
configuration (Swin-L at window 12): the reference and the weights at
window 7 against the Swin-T ones, kernel 3's bound at N tokens against
`kernels.window_attention` at 49, the three readers of the cell on
synthetic traces, and the `detect_window` entry at a size the CPU runs."""
import time

import pytest
import torch

from _util import small_cell
from test_bench_program_spans import Slice

from benchmark import calibrate_window, faults
from benchmark.core import cell as cells, judge, program_spans, traffic, weights, weights_window
from benchmark.core.run import run_cell
from benchmark.reference.yolact import Yolact as SwinTReference
from benchmark.reference.yolact_window import Yolact as Reference
from benchmark.roofline import kernels, peaks, windows

CPU = torch.device('cpu')
SWIN_T = small_cell('swin_tiny_coco.detect_b16').config['model']
SWIN_L = small_cell('swin_large_coco.detect_b16').config['model']
SMALL = dict(embed_dim=64, depths=(2, 2, 2, 2), num_heads=(2, 4, 8, 16), window=12,
             drop_path_rate=0.3)


@pytest.mark.parametrize('train', (False, True))
def test_the_window_reference_at_7_is_the_swin_t_reference(train):
    sd = weights.make_state_dict(SWIN_T, train, 11, CPU)
    assert all(torch.equal(sd[k], v) for k, v in
               weights_window.make_state_dict(SWIN_T, train, 11, CPU).items())
    ours, theirs = Reference(SWIN_T, train_mode=train), SwinTReference(SWIN_T, train_mode=train)
    ours.load_state_dict(sd, strict=True)
    theirs.load_state_dict(sd, strict=True)
    img = traffic.images(2, 96, traffic.generator(5, CPU), CPU)
    ours.train(train)
    theirs.train(train)
    with torch.no_grad():
        got = ours(img, torch.Generator().manual_seed(3))
        want = theirs(img, torch.Generator().manual_seed(3))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_the_bound_at_49_tokens_is_kernels_and_at_144_swin_l():
    for s in kernels.swin_stages(SWIN_T, 16, 544):
        assert windows.stage_tokens(s) == 49
        for shifted in (False, True):
            assert windows.window_attention(s['windows'], s['n_win'], s['heads'], s['c'],
                                            shifted, 49) == \
                kernels.window_attention(s['windows'], s['n_win'], s['heads'], s['c'], shifted)
    stages = kernels.swin_stages(SWIN_L, 16, 544)
    assert [s['padded'] for s in stages] == [144, 72, 36, 24]
    assert [s['windows'] for s in stages] == [2304, 576, 144, 64]
    assert [windows.stage_tokens(s) for s in stages] == [144] * 4
    s = stages[0]
    n_bytes, n_ops = windows.window_attention(s['windows'], s['n_win'], 6, 192, True, 144)
    rows = 2304 * 144
    assert n_bytes == 2 * (rows * 576 + rows * 192 + 6 * 144 * 144) + 4 * 144 * 144
    assert n_ops == 4 * rows * 144 * 192
    # byte-bound at every stage: 24 launches, 1.21 ms a call
    total = sum(peaks.bound_s(*windows.window_attention(s['windows'], s['n_win'], s['heads'],
                                                        s['c'], b % 2 == 1, 144))
                for s in stages for b in range(s['depth']))
    assert total * 1e3 == pytest.approx(1.21, abs=0.01)


def _stage_slice():
    """Two calls; in each, stage 0's span holds two launches of the
    144-token kernel (its unshifted then shifted block, 10 us each), stage 3's
    one, and kernel 4's three launches at C = 1536 (5 + 10 + 15 us)."""
    s = Slice(0, 1000)
    for c in (0, 500):
        s.op('bench.call', c, c + 500)
        s.op('bench.stage0', c + 10, c + 100)
        s.kernel('void window_attention_n144_bf16_kernel', c + 20, c + 20, c + 30)
        s.kernel('void window_attention_n144_bf16_kernel', c + 60, c + 60, c + 70)
        s.op('bench.stage3', c + 200, c + 300)
        s.kernel('void window_attention_n144_bf16_kernel', c + 210, c + 210, c + 220)
        s.kernel('void (anonymous namespace)::mlp_wide_ln_kernel', c + 230, c + 230, c + 235)
        s.kernel('void (anonymous namespace)::mlp_wide_gemm_kernel<false>', c + 240, c + 240,
                 c + 250)
        s.kernel('void (anonymous namespace)::mlp_wide_gemm_kernel<true>', c + 250, c + 250,
                 c + 265)
    return s.trace()


def test_the_readers_of_the_swin_l_cell():
    t = _stage_slice()
    stages = kernels.swin_stages(SWIN_L, 16, 544)
    ctx = {'calls': 2, 'batch': 16, 'stages': stages}
    bound = lambda s, shifted: peaks.bound_s(*windows.window_attention(
        s['windows'], s['n_win'], s['heads'], s['c'], shifted, 144))
    want = 100 * 2 * (bound(stages[0], False) + bound(stages[0], True) + bound(stages[3], False)) \
        / (6 * 10e-6)
    read = lambda name, ctx=ctx: cells.metric_reader(name).read(t, ctx)
    assert read('window_attention_n_roofline') == pytest.approx(want)
    assert read('window_attention_n_roofline', {'calls': 2, 'stages': None}) is None
    assert read('window_attention_roofline') is None           # the 49-token kernel's names
    s3 = stages[3]
    assert (s3['rows'], s3['c']) == (4624, 1536)
    mlp_bound = peaks.bound_s(*kernels.swin_mlp(s3['rows'], s3['c']))
    assert read('swin_mlp_wide_roofline') == pytest.approx(100 * 2 * mlp_bound / (2 * 30e-6))
    assert read('swin_mlp_roofline') is None                   # the fused kernel's names
    assert read('swin_mlp_wide_roofline', {'calls': 2, 'stages': None}) is None
    assert cells.metric_reader('swin_mlp_wide_roofline').read(Slice(0, 10).trace(), ctx) is None


def test_the_pad_share_reads_the_counters(monkeypatch):
    from yolact_minimal_torch.utils import trace as program_trace
    read = lambda: cells.metric_reader('window_pad_share.detect').read(Slice(0, 10).trace(), {})
    # Swin-L at 544: rows 2 * 136^2 + 2 * 68^2 + 18 * 34^2 + 2 * 17^2 an image, windows'
    # rows 2 * 144^2 + 2 * 72^2 + 18 * 36^2 + 2 * 24^2
    monkeypatch.setattr(program_trace, 'counts',
                        lambda: {'swin.rows': 16 * 67626, 'swin.window_rows': 16 * 76320})
    assert read() == pytest.approx(11.391, abs=1e-3)
    monkeypatch.setattr(program_trace, 'counts', lambda: {'swin.rows': 5})
    assert read() is None
    assert program_spans.counted('swin.window_rows') is None


@pytest.fixture
def small_cell_l(monkeypatch):
    """swin_large_coco.detect_b16 at 64 px, b2, with SMALL's depths and
    widths on both sides."""
    from yolact_minimal_torch import config
    monkeypatch.setitem(config.SWIN_SPECS, 'swin_large', SMALL)
    cell = small_cell('swin_large_coco.detect_b16', img_size=64)
    cell.config['model']['backbone'].update(embed_dim=64, depths=[2, 2, 2, 2],
                                            num_heads=[2, 4, 8, 16])
    return cell


def _run(cell):
    result, lines = run_cell(cell, 2 ** 31 + 17, 6.0, False, CPU, (time.perf_counter(), 0.0))
    assert len(lines) == 1 + len(cell.limits['checks'])
    return result


def test_the_entry_runs_correct_and_its_faults_and_control_fail(small_cell_l):
    result = _run(small_cell_l)
    assert result['correct'], result['checks']
    assert result['metrics']['detect_img_per_s']['value'] > 0
    for fault in ('half_batch', 'altered_answer'):
        with faults.FAULTS[fault]('detect'):
            assert not _run(small_cell_l)['correct'], fault
    values = calibrate_window.control_detect(small_cell_l, 2 ** 32 + 3, CPU)
    assert not all(c.ok for c in judge.checks(values, small_cell_l.limits['checks'])), values


def test_the_window_reference_weights_and_bound_load_nothing_of_the_program():
    from test_bench_reference import _loaded_after
    from benchmark.core import guard
    tops = _loaded_after('import benchmark.reference.yolact_window, benchmark.core.weights_window\n'
                         'import benchmark.roofline.windows\n')
    assert 'torch' in tops
    assert not tops & (set(guard.FORBIDDEN) | {'yolact_minimal_torch'})
