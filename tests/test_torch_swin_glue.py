"""The swin attention half's glue (`ops/swin_glue.py`) on the CPU.

- the plain versions are bit-equal to the composition models/swin.py ran
  before the glue kernels: `_layer_norm` (float32, rounded) -> pad -> roll
  -> window_partition, and window_reverse -> roll back -> crop -> `+
  shortcut`, in float32 and bf16, at windows 7 and 12, shifted or not, with
  and without padding;
- the route: only a 'composed' block on the card, in its compute dtype, at
  rate 0 and with no gradient wanted takes the kernels; a block under
  autograd, in another form, in training with stochastic depth or on the
  CPU takes the plain glue;
- the fused route's wiring (taken on the CPU, where its operators run their
  plain versions) gives the plain route's bits;
- the wrappers trace on tensors without data, as an export on the card
  gives them.
"""
import types

import pytest
import torch
import torch.nn.functional as F

from yolact_minimal_torch.models import swin
from yolact_minimal_torch.ops import swin_glue

torch.set_num_threads(1)

# (window, h, w): maps a window divides, and maps that pad on one or both axes
MAPS = [(7, 14, 14), (7, 12, 10), (12, 24, 24), (12, 20, 17)]


def _composition_to_windows(x, norm, window, shift):
    """norm1, pad, roll and partition as models/swin.py composed them."""
    dtype = x.dtype
    x = F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias,
                     norm.eps).to(dtype)
    b, h, w, c = x.shape
    pad_b, pad_r = (window - h % window) % window, (window - w % window) % window
    if pad_b or pad_r:
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
    if shift > 0:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    hp, wp = h + pad_b, w + pad_r
    x = x.reshape(b, hp // window, window, wp // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def _composition_from_windows(y, shortcut, window, shift):
    """window_reverse, roll back, crop and the residual add, as composed."""
    b, h, w, c = shortcut.shape
    hp, wp = -(-h // window) * window, -(-w // window) * window
    x = y.reshape(b, hp // window, wp // window, window, window, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
    if shift > 0:
        x = torch.roll(x, (shift, shift), dims=(1, 2))
    return shortcut + x[:, :h, :w, :]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('window,h,w', MAPS)
@pytest.mark.parametrize('shifted', [False, True])
def test_plain_glue_equals_the_composition(dtype, window, h, w, shifted):
    g = torch.Generator().manual_seed(window * h + w)
    norm = torch.nn.LayerNorm(32, eps=swin_glue.LN_EPS)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.1 * torch.randn(32, generator=g))
        norm.bias.copy_(0.1 * torch.randn(32, generator=g))
    x = (torch.randn(2, h, w, 32, generator=g) * 2 + 0.5).to(dtype)
    shift = window // 2 if shifted else 0
    want = _composition_to_windows(x, norm, window, shift)
    for got in (swin_glue.to_windows_plain(x, norm.weight, norm.bias, window, shift),
                swin_glue.to_windows(x, norm.weight, norm.bias, window, shift)):
        assert got.dtype == dtype and torch.equal(got, want)
    y = torch.randn(want.shape, generator=g).to(dtype)
    want = _composition_from_windows(y, x, window, shift)
    for got in (swin_glue.from_windows_plain(y, x, window, shift),
                swin_glue.from_windows(y, x, window, shift)):
        assert got.dtype == dtype and torch.equal(got, want)


def _block(form='composed', dtype=torch.bfloat16, rate=0.0):
    block = swin.SwinBlock(64, 2, 3, 7, dtype, fused_attn_block=form == 'attn_block',
                           fused_whole=form == 'whole', drop_path_rate=rate)
    return block.eval()


def _on_card(dtype=torch.bfloat16, requires_grad=False):
    """What the route reads of an input on the card."""
    return types.SimpleNamespace(is_cuda=True, dtype=dtype, requires_grad=requires_grad)


@pytest.mark.parametrize('case,fused', [
    ('composed eval, no grad', True),
    ('composed eval, grad enabled, parameters need it', False),
    ('composed eval, grad enabled, parameters frozen, input needs it', False),
    ('composed eval, grad enabled, nothing needs it', True),
    ('attn_block', False),
    ('whole', False),
    ('cpu', False),
    ('another dtype', False),
    ('training at a drop_path rate', False),
    ('training at rate 0, no grad', True)])
def test_the_glue_route_follows_what_the_call_observes(case, fused):
    block = _block(form=case if case in ('attn_block', 'whole') else 'composed',
                   rate=0.1 if case.startswith('training at a') else 0.0)
    x = _on_card()
    rate = 0.0
    grad = case.startswith('composed eval, grad enabled')
    if 'frozen' in case or 'nothing' in case:
        block.requires_grad_(False)
    if 'input needs it' in case:
        x = _on_card(requires_grad=True)
    if case == 'cpu':
        x = torch.zeros(1, 7, 7, 64, dtype=torch.bfloat16)
    if case == 'another dtype':
        x = _on_card(torch.float32)
    if case.startswith('training'):
        block.train()
        rate = block.drop_path_rate
    with torch.set_grad_enabled(grad):
        assert block._fused_glue(x, rate) is fused


def _small_swin(dtype):
    torch.manual_seed(0)
    model = swin.Swin(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8), dtype=dtype,
                      block_forms=('composed', 'composed', 'attn_block', 'whole')).eval()
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.05)
    return model


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_the_fused_route_gives_the_plain_routes_bits(monkeypatch, dtype):
    """The small swin at 72 px (every stage pads) with the route forced onto
    the glue operators, which on the CPU run their plain versions: the same
    four outputs bit for bit, each operator called once in each 'composed'
    block and in no other."""
    model = _small_swin(dtype)
    x = torch.randn(2, 72, 72, 3, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        plain = model(x)
    calls = {'to_windows': 0, 'from_windows': 0}

    def counting(name, fn):
        def call(*args):
            calls[name] += 1
            return fn(*args)
        return call
    monkeypatch.setattr(swin, 'to_windows', counting('to_windows', swin_glue.to_windows))
    monkeypatch.setattr(swin, 'from_windows', counting('from_windows', swin_glue.from_windows))
    monkeypatch.setattr(swin.SwinBlock, '_fused_glue', lambda self, x, rate: not (
        self.fused_attn_block or self.fused_whole))
    with torch.no_grad():
        fused = model(x)
    assert calls == {'to_windows': 4, 'from_windows': 4}
    for a, b in zip(plain, fused):
        assert torch.equal(a, b)


def test_the_wrappers_trace_on_fake_card_tensors():
    """An export on the card traces the wrappers on tensors without data: the
    checks outside the operators read shapes, dtypes and devices only, and
    the fakes give the outputs' shapes on the card."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        x = torch.empty(2, 12, 12, 96, device='cuda', dtype=torch.bfloat16)
        scale, bias = torch.empty(96, device='cuda'), torch.empty(96, device='cuda')
        windows = swin_glue.to_windows(x, scale, bias, 7, 3)
        back = swin_glue.from_windows(windows, x, 7, 3)
    assert windows.shape == (8, 49, 96) and windows.device.type == 'cuda'
    assert back.shape == x.shape and back.dtype == torch.bfloat16
