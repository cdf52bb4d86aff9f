"""Kernel 4's wide form in the swin detect cells: the share of its calls the
program routes there (`mlp_wide_share.detect`, from the program's counters)
and its roofline (`swin_mlp_wide_roofline`) over launches named as the
templated kernels are, at Swin-L's stage 2 and stage 3."""
import pytest

from _util import small_cell
from test_bench_program_spans import Slice

from benchmark.core import cell as cells, program_spans
from benchmark.roofline import kernels, peaks

SWIN_L = small_cell('swin_large_coco.detect_b16').config['model']


def _read(name, trace=None, ctx=None):
    return cells.metric_reader(name).read(trace or Slice(0, 10).trace(), ctx or {})


@pytest.mark.parametrize('blocks,wide,want', [(24, 20, 83.333), (24, 22, 91.667),
                                               (12, 2, 16.667), (12, 8, 66.667), (12, 0, 0.0)])
def test_the_wide_share_reads_the_counters(monkeypatch, blocks, wide, want):
    from yolact_minimal_torch.utils import trace as program_trace
    monkeypatch.setattr(program_trace, 'counts', lambda: {
        'swin.mlp_blocks': 16 * blocks, 'swin.mlp_wide_blocks': 16 * wide})
    assert _read('mlp_wide_share.detect') == pytest.approx(want, abs=1e-3)


def test_the_wide_share_is_none_without_the_counters(monkeypatch):
    from yolact_minimal_torch.utils import trace as program_trace
    monkeypatch.setattr(program_trace, 'counts', lambda: {'swin.rows': 5})
    assert _read('mlp_wide_share.detect') is None
    assert program_spans.counted('swin.mlp_wide_blocks') is None
    monkeypatch.setattr(program_trace, 'counts', lambda: {'swin.mlp_wide_blocks': 3})
    assert _read('mlp_wide_share.detect') is None


def _wide_slice():
    """Two calls; in each, stage 2's span holds two blocks of the wide form
    (LayerNorm 4 us, fc1 20 us, fc2 20 us) and a fused launch at stage 1."""
    s = Slice(0, 1000)
    for c in (0, 500):
        s.op('bench.call', c, c + 500)
        s.op('bench.stage1', c + 10, c + 40)
        s.kernel('void (anonymous namespace)::mlp_bf16_sm90_kernel<384>', c + 20, c + 20, c + 30)
        s.op('bench.stage2', c + 100, c + 300)
        for b in (0, 100):
            t = c + 110 + b
            s.kernel('void (anonymous namespace)::mlp_wide_ln_kernel<768>', t, t, t + 4)
            s.kernel('void (anonymous namespace)::mlp_wide_gemm_kernel<768, false>', t + 5,
                     t + 5, t + 25)
            s.kernel('void (anonymous namespace)::mlp_wide_gemm_kernel<768, true>', t + 25,
                     t + 25, t + 45)
    return s.trace()


def test_the_wide_roofline_reads_the_templated_launches():
    stages = kernels.swin_stages(SWIN_L, 16, 544)
    s2 = stages[2]
    assert (s2['rows'], s2['c']) == (18496, 768)
    ctx = {'calls': 2, 'batch': 16, 'stages': stages}
    bound = peaks.bound_s(*kernels.swin_mlp(s2['rows'], s2['c']))
    t = _wide_slice()
    # four blocks over two calls, each 44 us of device time
    assert _read('swin_mlp_wide_roofline', t, ctx) == pytest.approx(100 * 4 * bound / (4 * 44e-6))
    s1 = stages[1]
    assert _read('swin_mlp_roofline', t, ctx) == pytest.approx(
        100 * 2 * peaks.bound_s(*kernels.swin_mlp(s1['rows'], s1['c'])) / (2 * 10e-6))
