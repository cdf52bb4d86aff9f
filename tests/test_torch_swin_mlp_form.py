"""Which form kernel 4 takes (`ops/swin_mlp.py::mlp_form`) and the program's
counters of it (`swin.mlp_blocks`, `swin.mlp_wide_blocks` in
`models/swin.py`), on the CPU: the route by width, dtype and device, and
the counts of a Swin-L and a Swin-T forward at their published widths and
depths (at 64 px), as the card would route them and as the CPU does."""
import pytest
import torch

from yolact_minimal_torch.config import SWIN_SPECS
from yolact_minimal_torch.models import swin
from yolact_minimal_torch.ops import swin_mlp
from yolact_minimal_torch.ops.swin_mlp import MLP_WIDTHS, WIDE_WIDTHS, mlp_form
from yolact_minimal_torch.utils import trace

torch.set_num_threads(1)

# the card's bf16 route, width by width
CARD_BF16 = {96: 'fused', 192: 'fused', 384: 'wide', 768: 'wide', 1536: 'wide'}


@pytest.mark.parametrize('c', MLP_WIDTHS)
def test_the_route_by_width_dtype_and_device(c):
    assert mlp_form(c, torch.bfloat16) == mlp_form(c, torch.bfloat16, 'cuda') == CARD_BF16[c]
    assert mlp_form(c, torch.float32, 'cuda') == 'fused'
    assert mlp_form(c, torch.bfloat16, 'cpu') == mlp_form(c, torch.float32, 'cpu') == 'plain'


def test_the_wide_widths_are_kernel_widths():
    assert set(WIDE_WIDTHS) <= set(MLP_WIDTHS)
    assert swin_mlp.KERNEL_WIDTHS == (96, 192, 384, 768)
    assert {c for c in MLP_WIDTHS if CARD_BF16[c] == 'wide'} == set(WIDE_WIDTHS)


def _counts(model, device_type, monkeypatch):
    """The counters of one forward of `model` on the CPU, the route taken as
    on a device of `device_type`."""
    monkeypatch.setattr(swin, 'mlp_form', lambda c, dt, _dev: mlp_form(c, dt, device_type))
    trace.reset()
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        model(torch.randn(1, 64, 64, 3))
    counts = trace.counts()
    trace.reset()
    return counts['swin.mlp_blocks'], counts['swin.mlp_wide_blocks']


@pytest.mark.parametrize('name,blocks,wide', [('swin_large', 24, 22), ('swin_tiny', 12, 8)])
def test_a_forward_counts_its_mlp_blocks_and_the_wide_ones(name, blocks, wide, monkeypatch):
    spec = SWIN_SPECS[name]
    widths = [spec['embed_dim'] * 2 ** i for i, d in enumerate(spec['depths']) for _ in range(d)]
    assert wide == sum(CARD_BF16[c] == 'wide' for c in widths)
    torch.manual_seed(0)
    model = swin.Swin(dtype=torch.bfloat16, **spec).eval()
    assert _counts(model, 'cuda', monkeypatch) == (blocks, wide)
    assert _counts(model, 'cpu', monkeypatch) == (blocks, 0)
    model = swin.Swin(dtype=torch.float32, **spec).eval()
    assert _counts(model, 'cuda', monkeypatch) == (blocks, 0)


def test_no_counter_without_a_profiler(monkeypatch):
    def refuse(*args):
        raise AssertionError('the route was looked up for a counter with no profiler recording')
    monkeypatch.setattr(swin, 'mlp_form', refuse)
    trace.reset()
    model = swin.Swin(**SWIN_SPECS['swin_tiny']).eval()
    with torch.no_grad():
        model(torch.randn(1, 64, 64, 3))
    assert 'swin.mlp_blocks' not in trace.counts()
