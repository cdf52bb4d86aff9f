"""The share of the swin attention halves whose glue runs as the two glue
kernels (`swin_glue_fused_share.detect`), from the program's counters."""
import pytest

from test_bench_program_spans import Slice

from benchmark.core import cell as cells


def _read(monkeypatch, counted):
    from yolact_minimal_torch.utils import trace as program_trace
    monkeypatch.setattr(program_trace, 'counts', lambda: counted)
    return cells.metric_reader('swin_glue_fused_share.detect').read(Slice(0, 10).trace(), {})


@pytest.mark.parametrize('halves,fused,want', [(24, 24, 100.0), (12, 12, 100.0), (12, 8, 66.667),
                                               (12, 0, 0.0)])
def test_the_fused_glue_share_reads_the_counters(monkeypatch, halves, fused, want):
    counted = {'swin.attn_blocks': 16 * halves, 'swin.rows': 5}
    if fused:
        counted['swin.glue_fused_blocks'] = 16 * fused
    assert _read(monkeypatch, counted) == pytest.approx(want, abs=1e-3)


@pytest.mark.parametrize('counted', [{}, {'swin.rows': 5, 'swin.mlp_blocks': 24},
                                     {'swin.glue_fused_blocks': 3}])
def test_the_fused_glue_share_is_none_without_the_halves_counter(monkeypatch, counted):
    """A program that does not count its attention halves (the parent of the
    glue kernels, or res50) reads nothing."""
    assert _read(monkeypatch, counted) is None
