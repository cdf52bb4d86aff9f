"""Kernels 3 (window attention) and 4 (the swin MLP half-block) under
autograd: the port's wrappers, where an input needs a gradient, against
jax.vjp of the JAX package's kernel functions (`window_attention_fused`,
`mlp_block_fused`: the Pallas kernel in interpret mode forward, its
custom_vjp backward through the XLA form). The same seeded inputs and
cotangent go to both; the outputs and every gradient are compared.

float32: within 1e-5 of each tensor's largest magnitude (sums of up to 49
or 3072 products in another order). bf16: within the forward tests'
limits (2e-2 attention, 3e-2 MLP) of each tensor's largest magnitude; the
backward rounds at other places in the two frameworks (the port's recompute
takes float32 products of bf16 values and rounds its results once)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolact_minimal_tpu.models.swin import shifted_window_regions as jax_regions
from yolact_minimal_tpu.ops.swin_mlp import mlp_block_fused
from yolact_minimal_tpu.ops.window_attention import window_attention_fused
from yolact_minimal_torch.ops.swin_mlp import mlp_block
from yolact_minimal_torch.ops.window_attention import window_attention

torch.set_num_threads(1)

N = 49
TOL = {('attn', 'float32'): 1e-5, ('attn', 'bfloat16'): 2e-2,
       ('mlp', 'float32'): 1e-5, ('mlp', 'bfloat16'): 3e-2}
DTYPES = {'float32': (torch.float32, jnp.float32), 'bfloat16': (torch.bfloat16, jnp.bfloat16)}


def _hold(ours, ref, tol, what):
    ours = ours.float().numpy()
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    scale = float(np.abs(ref).max())
    assert scale > 0, what
    np.testing.assert_allclose(ours, ref, rtol=0, atol=tol * scale, err_msg=what)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shifted', [False, True])
@pytest.mark.parametrize('heads,c', [(3, 96), (6, 192)])
def test_window_attention_grads_equal_jax_vjp(heads, c, shifted, dtype):
    tdt, jdt = DTYPES[dtype]
    rng = np.random.RandomState(heads + 2 * shifted)
    hp = 14
    nw = (hp // 7) ** 2
    qkv = rng.randn(2 * nw, N, 3 * c).astype(np.float32)
    bias = (rng.randn(heads, N, N) * 0.5).astype(np.float32)
    cot = rng.randn(2 * nw, N, c).astype(np.float32)
    region = jax_regions(hp, hp).astype(np.int32) if shifted else None

    q = torch.from_numpy(qkv).to(tdt).requires_grad_()
    b = torch.from_numpy(bias).to(tdt).requires_grad_()
    reg = None if region is None else torch.from_numpy(region)
    before = window_attention.launches
    out = window_attention(q, b, reg, heads)
    out.backward(torch.from_numpy(cot).to(tdt))
    assert window_attention.launches == before            # the CPU runs the plain version
    assert q.grad.dtype == tdt and b.grad.dtype == tdt

    jreg = None if region is None else jnp.asarray(region)
    ref, vjp = jax.vjp(lambda a, s: window_attention_fused(a, s, jreg, heads),
                       jnp.asarray(qkv).astype(jdt), jnp.asarray(bias).astype(jdt))
    d_qkv, d_bias = vjp(jnp.asarray(cot).astype(jdt))
    tol = TOL['attn', dtype]
    _hold(out.detach(), ref, tol, 'output')
    _hold(q.grad, d_qkv, tol, 'd qkv')
    _hold(b.grad, d_bias, tol, 'd bias')


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('c', [96, 192])
def test_mlp_block_grads_equal_jax_vjp(c, dtype):
    tdt, jdt = DTYPES[dtype]
    rng = np.random.RandomState(c)
    rows = 98
    x = rng.randn(rows, c).astype(np.float32)
    params = (rng.randn(c).astype(np.float32) * 0.1 + 1.0,
              rng.randn(c).astype(np.float32) * 0.1,
              rng.randn(c, 4 * c).astype(np.float32) * 0.05,
              rng.randn(4 * c).astype(np.float32) * 0.05,
              rng.randn(4 * c, c).astype(np.float32) * 0.05,
              rng.randn(c).astype(np.float32) * 0.05)
    cot = rng.randn(rows, c).astype(np.float32)

    # the port takes nn.Linear's [out, in] weights, bf16 where x is, float32 LN and biases
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    lns, lnb, k1, b1, k2, b2 = (torch.from_numpy(p) for p in params)
    k1, k2 = k1.T.contiguous().to(tdt), k2.T.contiguous().to(tdt)
    leaves = [t.requires_grad_() for t in (lns, lnb, k1, b1, k2, b2)]
    before = mlp_block.launches
    out = mlp_block(xt, *leaves)
    out.backward(torch.from_numpy(cot).to(tdt))
    assert mlp_block.launches == before

    jargs = [jnp.asarray(x).astype(jdt)] + [jnp.asarray(p) for p in params]
    jargs[3] = jargs[3].astype(jdt)
    jargs[5] = jargs[5].astype(jdt)
    ref, vjp = jax.vjp(mlp_block_fused, *jargs)
    grads = vjp(jnp.asarray(cot).astype(jdt))
    tol = TOL['mlp', dtype]
    _hold(out.detach(), ref, tol, 'output')
    _hold(xt.grad, grads[0], tol, 'd x')
    for name, t, g, transpose in zip(('d ln scale', 'd ln bias', 'd k1', 'd b1', 'd k2', 'd b2'),
                                     leaves, grads[1:], (False, False, True, False, True, False)):
        assert t.grad.dtype == t.dtype, name
        _hold(t.grad.T if transpose else t.grad, g, tol, name)


def _swin_model(rate=0.2):
    from yolact_minimal_torch.models.swin import SwinTiny
    torch.manual_seed(0)
    model = SwinTiny(drop_path_rate=rate)
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.02)
    return model


def test_fused_block_forms_refuse_to_train():
    """The JAX model never trains the attention half-block or whole-block
    forms; the port raises instead of running them without a backward."""
    model = _swin_model().train()
    x = torch.randn(1, 64, 64, 3)
    for form in ('attn_block', 'whole'):
        model.set_block_forms(form)
        with pytest.raises(NotImplementedError, match='composed form only'):
            model(x)
    model.set_block_forms('composed')
    assert all(torch.isfinite(t).all() for t in model(x, torch.Generator().manual_seed(0)))


def test_drop_path_keeps_each_sample_with_its_rate():
    from yolact_minimal_torch.models.swin import drop_path
    x = torch.ones(20000, 3, 2)
    y = drop_path(x, 0.2, torch.Generator().manual_seed(0))
    kept = y[:, 0, 0] > 0
    assert ((y == 0) | (y == 1.25)).all()                            # scaled by 1 / keep
    assert (y == y[:, :1, :1]).all()                                 # one bit a sample
    assert abs(kept.float().mean().item() - 0.8) < 0.01              # 3 sigma: 0.0085
    assert torch.equal(drop_path(x, 0.0, None), x)
    model, img = _swin_model(), torch.randn(1, 64, 64, 3)
    with torch.no_grad():                       # eval draws nothing; training does
        runs = {mode: [model.train(mode == 'train')(img, torch.Generator().manual_seed(s))[3]
                       for s in (0, 1)] for mode in ('eval', 'train')}
    assert torch.equal(*runs['eval']) and not torch.equal(*runs['train'])
    rates = [b.drop_path_rate for s in _swin_model().layers for b in s.blocks]
    np.testing.assert_allclose(rates, np.linspace(0, 0.2, 12))


def test_mlp_kernel_runs_in_training_only_where_drop_path_is_off(monkeypatch):
    from yolact_minimal_torch.ops import swin_mlp
    model = _swin_model().train()
    seen = []
    orig = swin_mlp._forward

    def spy(*a):
        seen.append(a[0].shape)
        return orig(*a)
    monkeypatch.setattr(swin_mlp, '_forward', spy)
    model(torch.randn(2, 64, 64, 3), torch.Generator().manual_seed(0))
    assert len(seen) == 1                            # block 0 of stage 0, rate 0
    seen.clear()
    with torch.no_grad():
        model.eval()(torch.randn(2, 64, 64, 3))
    assert len(seen) == 12


def test_cached_casts_follow_an_optimizer_step():
    """The eval path keeps its bf16 casts and bias gathers cached on the
    parameters' versions: after an in-place optimizer step it sees the new
    weights, and a training forward sends gradients to every parameter."""
    from yolact_minimal_torch.models.swin import SwinTiny
    model = SwinTiny(dtype=torch.bfloat16, drop_path_rate=0.0)
    torch.manual_seed(1)
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.02)
    x = torch.randn(1, 64, 64, 3)
    with torch.no_grad():
        before = model.eval()(x)
    model.train()
    with torch.autocast('cpu', dtype=torch.bfloat16):
        loss = sum(o.float().square().mean() for o in model(x, torch.Generator().manual_seed(0)))
    loss.backward()
    no_grad = [n for n, p in model.named_parameters() if p.grad is None or not p.grad.any()]
    assert not no_grad, no_grad
    torch.optim.SGD(model.parameters(), lr=1.0).step()
    with torch.no_grad():
        after = model.eval()(x)
        fresh = SwinTiny(dtype=torch.bfloat16, drop_path_rate=0.0)
        fresh.load_state_dict(model.state_dict())
        want = fresh.eval()(x)
    for a, b, w in zip(before, after, want):
        assert not torch.equal(a, b)
        assert torch.equal(b, w)
