"""The backward of the window attention operator: on the CPU its launch
geometry, its argument checks, the plain recompute it runs there, and the
backward kernel's rounding places emulated in float32 against the limit the
card tests hold it to; on the card (marker `cuda`) the bf16 backward kernel
against the plain recompute.

On the card: python -m pytest tests/test_torch_window_attention_backward.py -m cuda -s
(-s prints the gaps measured.)
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from yolact_minimal_torch.models.swin import shifted_window_regions
from yolact_minimal_torch.ops.window_attention import (BACKWARD_BLOCKS_PER_SM, backward_geometry,
                                                       window_attention,
                                                       window_attention_backward,
                                                       window_attention_backward_plain,
                                                       window_attention_plain)

torch.set_num_threads(1)

# Relative L2 gap, |kernel - plain| / |plain|, allowed for each of dq, dk, dv
# and d_bias: both round at the same places, so a gap is a float32 sum in
# another order that rounds to the other bf16 neighbour now and then. The
# kernel reads at most 1.33e-4 on the card; a backward that rounds dS to bf16
# before dq and dk, or keeps dP in float32, reads ~2.6e-3 or more
# (test_the_limit_sees_a_change_of_rounding_places).
BF16_GRAD_GAP = 5e-4


def _gap(got, ref):
    return ((got.float() - ref.float()).norm() / ref.float().norm()).item()


def _case(heads, bnw, nw, masked, dtype=torch.float32, dev='cpu', seed=0):
    rng = np.random.RandomState(seed)
    c, side = heads * 32, int(nw ** 0.5) * 7
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev, dtype)
    qkv = t(rng.randn(bnw, 49, 3 * c))
    bias = t(rng.randn(heads, 49, 49) * 0.1)
    grad = t(rng.randn(bnw, 49, c))
    region = torch.from_numpy(shifted_window_regions(side, side)).to(dev) if masked else None
    return qkv, bias, region, grad


# --- without a card ------------------------------------------------------------

# (windows B*nW, heads): swin_tiny's four stages at 544, batch 8 and 64, and
# window counts that no grid divides
GEOMETRY_CASES = [(3200, 3), (800, 6), (200, 12), (72, 24), (25600, 3), (6400, 6),
                  (1600, 12), (576, 24), (1, 3), (2, 6), (131, 12), (133, 24)]


@pytest.mark.parametrize('bnw,heads', GEOMETRY_CASES)
@pytest.mark.parametrize('sms', [132, 114, 1])
def test_backward_geometry_walks_every_unit_once(bnw, heads, sms):
    """One group a block, as many as stay resident (BACKWARD_BLOCKS_PER_SM a
    multiprocessor), each head's windows dealt round-robin to per_head groups;
    every (window, head) unit walked by exactly one group."""
    geo = backward_geometry(bnw, heads, sms)
    assert geo.per_block == 1 and geo.blocks == geo.groups
    assert geo.groups % heads == 0 and geo.groups // heads == geo.per_head <= bnw
    assert geo.groups <= max(sms * BACKWARD_BLOCKS_PER_SM, heads)
    walked = [u for b in range(geo.blocks) for u in geo.units(b)]
    assert sorted(walked) == [(w, h) for w in range(bnw) for h in range(heads)]
    counts = [len(geo.units(b)) for b in range(geo.blocks)]
    assert max(counts) - min(counts) <= 1
    # group g's head: the d_bias partials of head h are rows h, h + heads, ...
    assert all(h == b % heads for b in range(geo.blocks) for _, h in geo.units(b))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('masked', [False, True])
def test_cpu_backward_is_the_plain_recompute(dtype, masked):
    """On the CPU the operator's backward is the plain version's autograd, to
    the bit, and launches nothing."""
    qkv, bias, region, grad = _case(3, 32, 16, masked, dtype)
    before = (window_attention.launches, window_attention.backward_launches)
    grads = []
    for fn in (window_attention, window_attention_plain):
        q, b = qkv.clone().requires_grad_(), bias.clone().requires_grad_()
        fn(q, b, region, 3).backward(grad)
        grads.append((q.grad, b.grad))
    direct = window_attention_backward(qkv, bias, region, 3, grad)
    assert (window_attention.launches, window_attention.backward_launches) == before
    for got, plain, d in zip(grads[0], grads[1], direct):
        assert got.dtype == dtype and torch.equal(got, plain) and torch.equal(d, plain)


def test_backward_wrapper_checks_its_inputs():
    qkv, bias, region, grad = _case(3, 32, 16, True)
    with pytest.raises(ValueError, match='grad must be'):
        window_attention_backward(qkv, bias, region, 3, grad[:, :, :48].contiguous())
    with pytest.raises(ValueError, match='grad must be'):
        window_attention_backward(qkv, bias, region, 3, grad.to(torch.bfloat16))
    with pytest.raises(ValueError, match='grad must be'):
        window_attention_backward(qkv, bias, region, 3, grad.transpose(0, 1).contiguous()
                                  .transpose(0, 1))
    with pytest.raises(ValueError, match='grad must be'):
        window_attention_backward(qkv, bias, region, 3, grad.to('meta'))
    with pytest.raises(ValueError, match='bias must be'):
        window_attention_backward(qkv, bias.to(torch.bfloat16), region, 3, grad)
    with pytest.raises(ValueError, match='region must be'):
        window_attention_backward(qkv, bias, region.long(), 3, grad)
    with pytest.raises(ValueError, match='whole number of images'):
        window_attention_backward(qkv[:5].contiguous(), bias, region, 3, grad[:5].contiguous())
    with pytest.raises(ValueError, match='unsupported device'):
        window_attention_backward(qkv.to('meta'), bias.to('meta'), None, 3, grad.to('meta'))


def _emulated_backward(qkv, bias, region, heads, grad, ds_lo=True, round_dp=True):
    """(d_qkv, d_bias) computed as csrc/window_attention.cu's backward kernel
    computes them, in float32 on the CPU: P recomputed in float32, dV from
    bf16(P), dP rounded to bf16 as the plain cast does, dS = P (dP - D) in
    float32 and fed to dq and dk as a hi / lo pair of bf16 values, each
    result rounded to bf16 once. `ds_lo` False drops the lo half (dS rounded
    to bf16); `round_dp` False keeps dP in float32."""
    bf16 = torch.bfloat16
    bnw, n, c3 = qkv.shape
    c = c3 // 3
    hd = c // heads
    q, k, v = (qkv[..., i * c:(i + 1) * c].reshape(bnw, n, heads, hd).float() for i in range(3))
    scale = torch.tensor(hd ** -0.5, dtype=bf16).float()
    qs = (q * scale).to(bf16).float()
    s = torch.einsum('bnhd,bmhd->bhnm', qs, k) + bias.float()[None]
    if region is not None:
        nw = region.shape[0]
        madd = torch.where(region[:, :, None] != region[:, None, :], -100.0, 0.0)
        s = (s.reshape(bnw // nw, nw, heads, n, n) + madd[None, :, None]).reshape(s.shape)
    p = torch.softmax(s, -1)
    d_out = grad.reshape(bnw, n, heads, hd).float()
    dv = torch.einsum('bhnm,bnhd->bmhd', p.to(bf16).float(), d_out).to(bf16)
    dp = torch.einsum('bnhd,bmhd->bhnm', d_out, v)
    dp = dp.to(bf16).float() if round_dp else dp
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    hi = ds.to(bf16).float()
    lo = (ds - hi).to(bf16).float() if ds_lo else torch.zeros_like(hi)
    dqs = (torch.einsum('bhnm,bmhd->bnhd', hi, k) + torch.einsum('bhnm,bmhd->bnhd', lo, k))
    dq = (dqs.to(bf16).float() * scale).to(bf16)
    dk = (torch.einsum('bhnm,bnhd->bmhd', hi, qs) +
          torch.einsum('bhnm,bnhd->bmhd', lo, qs)).to(bf16)
    d_qkv = torch.cat([t.reshape(bnw, n, c) for t in (dq, dk, dv)], -1)
    return d_qkv, ds.sum(0).to(bf16)


def _gaps(d_qkv, d_bias, ref_qkv, ref_bias, heads):
    c = heads * 32
    gaps = {name: _gap(d_qkv[..., i * c:(i + 1) * c], ref_qkv[..., i * c:(i + 1) * c])
            for i, name in enumerate(('dq', 'dk', 'dv'))}
    gaps['d_bias'] = _gap(d_bias, ref_bias)
    return gaps


@pytest.mark.parametrize('heads,bnw,nw,masked', [(3, 27, 9, True), (6, 32, 16, False)])
@pytest.mark.parametrize('variant', ['kernel', 'dS in bf16', 'dP in float32'])
def test_the_limit_sees_a_change_of_rounding_places(variant, heads, bnw, nw, masked):
    """The backward kernel's arithmetic, emulated in float32, reads within
    BF16_GRAD_GAP of the plain recompute in bf16; dS rounded to bf16 before
    dq and dk, or dP left unrounded, reads above it in some tensor."""
    qkv, bias, region, grad = _case(heads, bnw, nw, masked, torch.bfloat16, seed=1)
    ref_qkv, ref_bias = window_attention_backward_plain(qkv, bias, region, heads, grad)
    kw = {'kernel': {}, 'dS in bf16': dict(ds_lo=False), 'dP in float32': dict(round_dp=False)}
    gaps = _gaps(*_emulated_backward(qkv, bias, region, heads, grad, **kw[variant]),
                 ref_qkv, ref_bias, heads)
    if variant == 'kernel':
        assert all(v <= BF16_GRAD_GAP for v in gaps.values()), gaps
    else:
        assert max(gaps.values()) > BF16_GRAD_GAP, gaps


# --- on the card -----------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (torch.cuda.is_available() is false)')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


# (heads, windows B*nW, windows an image nW, shifted): swin_tiny's four
# stages at 544, batch 8 (the train_bs of the training shapes), shifted and
# not; window counts that no group count divides: three images of 9 windows,
# shifted, and single windows, unshifted
CARD_CASES = [(heads, bnw, nw, masked) for heads, bnw, nw in
              ((3, 3200, 400), (6, 800, 100), (12, 200, 25), (24, 72, 9))
              for masked in (False, True)] + \
    [(3, 27, 9, True), (12, 131, 1, False), (24, 133, 1, False)]


@pytest.mark.cuda
@pytest.mark.parametrize('heads,bnw,nw,masked', CARD_CASES)
def test_backward_kernel_matches_the_plain_recompute(card, heads, bnw, nw, masked):
    """d_qkv (as dq, dk, dv) and d_bias of the bf16 kernel within
    BF16_GRAD_GAP of the plain recompute's on the card, in relative L2; one
    backward launch counted, no forward; two launches give the same bits."""
    qkv, bias, region, grad = _case(heads, bnw, nw, masked, torch.bfloat16, card, seed=1)
    before = (window_attention.launches, window_attention.backward_launches)
    d_qkv, d_bias = window_attention_backward(qkv, bias, region, heads, grad)
    torch.cuda.synchronize()
    assert (window_attention.launches, window_attention.backward_launches) == \
        (before[0], before[1] + 1)
    ref_qkv, ref_bias = window_attention_backward_plain(qkv, bias, region, heads, grad)
    assert d_qkv.dtype == d_bias.dtype == torch.bfloat16
    assert d_qkv.shape == ref_qkv.shape and d_bias.shape == ref_bias.shape
    gaps = _gaps(d_qkv, d_bias, ref_qkv, ref_bias, heads)
    print(f'heads {heads} windows {bnw} nW {nw} masked {masked}: relative L2 gaps ' +
          ', '.join(f'{k} {v:.3g}' for k, v in gaps.items()))
    assert all(v <= BF16_GRAD_GAP for v in gaps.values()), gaps
    again = window_attention_backward(qkv, bias, region, heads, grad)
    assert torch.equal(again[0], d_qkv) and torch.equal(again[1], d_bias)


@pytest.mark.cuda
def test_autograd_on_the_card_launches_the_backward_kernel_for_bf16_only(card):
    """Through the operator: bf16 takes the kernel (one backward launch a
    backward), float32 the plain recompute (none), each equal to calling the
    backward directly."""
    for dtype, launched in ((torch.bfloat16, 1), (torch.float32, 0)):
        qkv, bias, region, grad = _case(6, 200, 100, True, dtype, card, seed=2)
        q, b = qkv.clone().requires_grad_(), bias.clone().requires_grad_()
        out = window_attention(q, b, region, 6)
        before = window_attention.backward_launches
        out.backward(grad)
        torch.cuda.synchronize()
        assert window_attention.backward_launches == before + launched
        direct = window_attention_backward(qkv, bias, region, 6, grad)
        assert torch.equal(q.grad, direct[0]) and torch.equal(b.grad, direct[1])


# A fresh process whose backward starts at kernel 3's node with every
# allocation served from PyTorch's cache: the autograd thread then makes no
# CUDA call before the kernel's launch, so the launch has to make the
# device's context current itself.
FIRST_WORK_ON_THE_AUTOGRAD_THREAD = textwrap.dedent("""
    import torch
    from yolact_minimal_torch.ops.window_attention import window_attention
    dev = torch.device('cuda', 0)
    bf16 = torch.bfloat16
    qkv = torch.randn(32, 49, 288, device=dev).to(bf16)
    bias = (torch.randn(3, 49, 49, device=dev) * 0.1).to(bf16)
    grad = torch.randn(32, 49, 96, device=dev).to(bf16)
    cached = [torch.empty(n, dtype=torch.uint8, device=dev)
              for n in (1 << 20, 1 << 16, 8 << 20, 8 << 20) for _ in range(4)]
    del cached
    q, b = qkv.clone().requires_grad_(), bias.clone().requires_grad_()
    d_qkv, d_bias = torch.autograd.grad(window_attention(q, b, None, 3), (q, b), grad)
    torch.cuda.synchronize()
    print(window_attention.backward_launches, bool(d_qkv.isfinite().all()))
""")


@pytest.mark.cuda
def test_backward_kernel_runs_as_the_first_cuda_work_of_the_autograd_thread(card):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run([sys.executable, '-c', FIRST_WORK_ON_THE_AUTOGRAD_THREAD], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    assert run.stdout.split() == ['1', 'True'], run.stdout


@pytest.mark.cuda
def test_backward_kernel_is_built_as_the_geometry_assumes(card):
    from yolact_minimal_torch.ops.window_attention import kernel_attributes
    attrs = kernel_attributes(backward=True)
    print('backward kernel:', attrs)
    assert attrs['groups_per_block'] == 1 and attrs['threads'] == 128
    assert attrs['blocks_per_sm'] == BACKWARD_BLOCKS_PER_SM
    assert 0 < (attrs['smem_bytes'] + 1024) * BACKWARD_BLOCKS_PER_SM <= 233472
    assert 0 < attrs['registers'] * attrs['threads'] * BACKWARD_BLOCKS_PER_SM <= 65536
