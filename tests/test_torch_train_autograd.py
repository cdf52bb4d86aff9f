"""Kernels 3 (window attention) and 4 (the swin MLP half-block) under
autograd: the port's wrappers, where an input needs a gradient, against
jax.vjp of the JAX package's kernel functions (`window_attention_fused`,
`mlp_block_fused`: the Pallas kernel in interpret mode forward, its
custom_vjp backward through the XLA form). Kernels 5 (the attention
half-block) and 6 (the whole block) against their custom_vjp backwards,
`_block_bwd` and `_bwd`, called directly. The same seeded inputs and
cotangent go to both; the outputs and every gradient are compared. Then a
SwinBlock in each form, in training, against the JAX block, and which
operators each form calls in training.

float32: within 1e-5 of each tensor's largest magnitude (sums of up to 49
or 3072 products in another order). bf16: within the forward tests'
limits (2e-2 attention, 3e-2 MLP) of each tensor's largest magnitude; the
backward rounds at other places in the two frameworks (the port's recompute
takes float32 products of bf16 values and rounds its results once)."""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from yolact_minimal_tpu.models.swin import shifted_window_regions as jax_regions
from yolact_minimal_tpu.ops.swin_mlp import mlp_block_fused
from yolact_minimal_tpu.ops.window_attention import window_attention_fused
from yolact_minimal_torch.ops.swin_mlp import mlp_block
from yolact_minimal_torch.ops.window_attention import window_attention
from yolact_minimal_torch.utils.weights import swin_from_jax_params

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
    from yolact_minimal_torch.models.swin import Swin
    torch.manual_seed(0)
    model = Swin(drop_path_rate=rate)
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.02)
    return model


BLOCK_WEIGHTS = {'attn': (1, 5), 'swin': (4, 8, 12, 14)}    # [in, out] JAX kernels


def _block_case(kind, args, dtype):
    """The port's and the JAX package's inputs from one JAX-layout tuple:
    x and the relative-position bias in the compute dtype, the weight
    matrices too (as models/swin.py hands them over: cast, [out, in]), the
    rest float32; the port's floating inputs are leaves that need a
    gradient (the rowmask too, to show that none reaches it)."""
    tdt, jdt = DTYPES[dtype]
    bias_at = {'attn': 3, 'swin': 6}[kind]
    low = (0, bias_at) + BLOCK_WEIGHTS[kind]
    ours, theirs = [], []
    for i, a in enumerate(args):
        if a is None or a.dtype == np.int32:
            ours.append(None if a is None else torch.from_numpy(a))
            theirs.append(None if a is None else jnp.asarray(a))
            continue
        t = torch.from_numpy(np.array(a.T if i in BLOCK_WEIGHTS[kind] else a, order='C'))
        ours.append(t.to(tdt if i in low else torch.float32).requires_grad_())
        theirs.append(jnp.asarray(a).astype(jdt if i in low else jnp.float32))
    return ours, theirs


def _hold_block_grads(kind, ours, theirs, out, ref, d_theirs, dtype):
    tol = TOL['attn' if kind == 'attn' else 'mlp', dtype]
    _hold(out.detach(), ref, tol, 'output')
    assert len(d_theirs) == len(ours)
    for i, (t, g) in enumerate(zip(ours, d_theirs)):
        if t is None or not t.is_floating_point() or g is None:
            # region (int32) and rowmask take no gradient, in JAX as in the port
            assert g is None and (t is None or t.grad is None), i
            continue
        assert t.grad.dtype == t.dtype and t.grad.shape == t.shape, i
        _hold(t.grad.T if i in BLOCK_WEIGHTS[kind] else t.grad, g, tol, f'd input {i}')


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shifted', [False, True])
@pytest.mark.parametrize('heads,c', [(3, 96), (6, 192)])
def test_attn_block_grads_equal_jax_vjp(heads, c, shifted, dtype):
    """Kernel 5's operator under autograd against the JAX package's
    custom_vjp backward `_block_bwd` (jax.vjp of `_block_xla`), which is
    what jax.grad of `window_attention_block_fused` runs after its forward.
    Tolerances: kernel 3's (1e-5 float32, 2e-2 bf16)."""
    from tests.test_torch_attn_block import _inputs
    from yolact_minimal_tpu.ops.window_attention import _block_bwd, _block_xla
    from yolact_minimal_torch.ops.attn_block import attn_block
    args = _inputs(heads, c, 14, shifted, seed=c + shifted)
    cot = np.random.RandomState(c).randn(*args[0].shape).astype(np.float32)
    ours, theirs = _block_case('attn', args, dtype)
    before = attn_block.launches
    out = attn_block(*ours, heads)
    out.backward(torch.from_numpy(cot).to(out.dtype))
    assert attn_block.launches == before                  # the CPU runs the plain version
    ref = _block_xla(*theirs, heads)
    grads = _block_bwd(heads, tuple(theirs), jnp.asarray(cot).astype(ref.dtype))
    _hold_block_grads('attn', ours, theirs, out, ref, grads, dtype)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('padded', [False, True])
@pytest.mark.parametrize('shift', [0, 3])
def test_swin_block_grads_equal_jax_vjp(shift, padded, dtype):
    """Kernel 6's operator under autograd against the JAX package's
    custom_vjp backward `_bwd` (jax.vjp of `_block_xla` over its 14
    differentiable inputs). A 12x12 map pads to 14x14 (rowmask), a 14x14
    one needs none. Tolerances: kernel 4's (1e-5 float32, 3e-2 bf16)."""
    from tests.test_torch_swin_block import _inputs
    from yolact_minimal_tpu.ops.swin_block import _block_xla, _bwd
    from yolact_minimal_torch.ops.swin_block import swin_block
    side = 12 if padded else 14
    args = _inputs(side, side, 96, 3, shift, seed=5 + shift + padded)
    assert (args[1] is None) != padded and (args[7] is None) == (shift == 0)
    cot = np.random.RandomState(shift).randn(*args[0].shape).astype(np.float32)
    ours, theirs = _block_case('swin', args, dtype)
    before = swin_block.launches
    out = swin_block(*ours, 3)
    out.backward(torch.from_numpy(cot).to(out.dtype))
    assert swin_block.launches == before
    ref = _block_xla(*theirs, 3)
    grads = _bwd(3, tuple(theirs), jnp.asarray(cot).astype(ref.dtype))
    _hold_block_grads('swin', ours, theirs, out, ref, grads, dtype)


@pytest.mark.parametrize('name', ['attn_block', 'swin_block'])
def test_block_ops_pass_opcheck_with_grad(name):
    """Kernels 5 and 6's operators with inputs that need a gradient pass
    torch.library.opcheck's schema, fake and autograd registration checks."""
    from tests.test_torch_attn_block import _inputs as attn_inputs
    from tests.test_torch_swin_block import _inputs as swin_inputs
    args = attn_inputs(3, 96, 14, True) if name == 'attn_block' else \
        swin_inputs(12, 12, 96, 3, 3)
    ours, _ = _block_case(name.split('_')[0], args, 'float32')
    if name == 'swin_block':
        ours[1] = ours[1].detach()                        # the rowmask takes no gradient
    result = torch.library.opcheck(
        getattr(torch.ops.yolact_torch, name), tuple(ours) + (3,),
        test_utils=('test_schema', 'test_faketensor', 'test_autograd_registration'))
    assert set(result.values()) == {'SUCCESS'}, result


def _block_pair(rate, form, state_dict):
    """A port SwinBlock (96 wide, 3 heads, shift 3) in `form`, in train mode."""
    from yolact_minimal_torch.models.swin import SwinBlock
    block = SwinBlock(96, 3, 3, 7, drop_path_rate=rate, fused_attn_block=form == 'attn_block',
                      fused_whole=form == 'whole')
    block.load_state_dict(state_dict, strict=True)
    return block.train()


def _block_grads(block, x, cot, seed=0):
    """The block's output and the gradients of sum(out * cot) for x and each
    parameter, by name."""
    x = x.clone().requires_grad_()
    out = block(x, torch.Generator().manual_seed(seed))
    (out * cot).sum().backward()
    grads = {k: p.grad for k, p in block.named_parameters()}
    return out.detach(), dict(grads, x=x.grad)


def _to_port(tree):
    """A JAX SwinBlock's params (or their gradients) -> the port block's
    state_dict names and layout."""
    prefix = 'layers.0.blocks.0.'
    return {k.removeprefix(prefix): t for k, t in
            swin_from_jax_params({'stage0': {'block0': tree}}, prefix='').items()}


@pytest.fixture(scope='module')
def jax_block_grads():
    """The unfused JAX SwinBlock (96 wide, 3 heads, shift 3, rate 0) in
    train mode on a 1x16x16x96 map: (x, cotangent, perturbed params, output,
    gradients of sum(out * cot) for x and each parameter in the port's
    names)."""
    from yolact_minimal_tpu.models.swin import SwinBlock as JaxSwinBlock
    rng = np.random.RandomState(17)
    x = rng.randn(1, 16, 16, 96).astype(np.float32)
    cot = rng.randn(1, 16, 16, 96).astype(np.float32)
    block = JaxSwinBlock(96, 3, shift=3, drop_path_rate=0.0, train=True)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(scale=0.02, size=a.shape).astype(np.float32),
        jax.jit(block.init)(jax.random.PRNGKey(0), x)['params'])
    apply = lambda p, a: block.apply({'params': p}, a)
    out = jax.jit(apply)(params, x)
    d_params, d_x = jax.jit(jax.grad(lambda p, a: (apply(p, a) * cot).sum(),
                                     argnums=(0, 1)))(params, x)
    grads = dict(_to_port(jax.tree_util.tree_map(np.asarray, d_params)),
                 x=torch.from_numpy(np.array(d_x)))
    return x, cot, params, np.asarray(out), grads


@pytest.mark.parametrize('form', ['composed', 'attn_block', 'whole'])
def test_block_forms_train_as_the_jax_block_does(jax_block_grads, form):
    """A port SwinBlock in each form, in train mode, against the JAX
    SwinBlock on the same weights: a 1x16x16x96 map that pads to 21x21,
    shifted by 3. At rate 0 the output and the gradients of x and every
    parameter are held to jax.grad of the unfused JAX block (whose fused
    forms the JAX package's own tests hold to it) at 2e-4, as the JAX
    package holds its fused block's gradients. At a nonzero rate the two
    stacks draw other keep bits, so the 'whole' and 'attn_block' blocks are
    held to the port's 'composed' block on the same generator seed within
    1e-5 of each tensor's largest magnitude (float32): 'whole' takes the
    two halves there, as the JAX block falls back."""
    x, cot, params, ref_out, want = jax_block_grads
    weights = _to_port(params)
    out, got = _block_grads(_block_pair(0.0, form, weights), torch.from_numpy(x),
                            torch.from_numpy(cot))
    np.testing.assert_allclose(out.numpy(), ref_out, rtol=2e-4, atol=2e-4)
    assert got.keys() == want.keys()
    for k, g in want.items():
        assert g.shape == got[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), g.numpy(), rtol=2e-4, atol=2e-4, err_msg=k)
    if form == 'composed':
        return
    rng = np.random.RandomState(18)
    xs, cots = (torch.from_numpy(rng.randn(4, 16, 16, 96).astype(np.float32)) for _ in 'ab')
    ref_out, ref = _block_grads(_block_pair(0.5, 'composed', weights), xs, cots, seed=3)
    out, got = _block_grads(_block_pair(0.5, form, weights), xs, cots, seed=3)
    assert not torch.allclose(ref_out, _block_grads(_block_pair(0.0, form, weights), xs, cots)[0])
    for k, g in dict(ref, out=ref_out).items():
        ours = dict(got, out=out)[k]
        assert (ours - g).abs().max() <= 1e-5 * g.abs().max(), k


def test_whole_block_trains_after_an_inference_mode_forward():
    """The padded map's rowmask is cached per shape; a detect forward under
    inference mode may make it first, and the whole-block backward, which
    saves it for autograd, must still take it."""
    from yolact_minimal_torch.models import swin
    swin._cached_table.cache_clear()
    block = _block_pair(0.0, 'whole', swin.SwinBlock(96, 3, 3, 7).state_dict())
    x = torch.randn(1, 13, 13, 96)
    with torch.inference_mode():
        block.eval()(x)
    out, grads = _block_grads(block.train(), x, torch.randn(1, 13, 13, 96))
    assert torch.isfinite(out).all() and torch.isfinite(grads['x']).all()


class _OpCalls(TorchDispatchMode):
    """Counts the calls of each yolact_torch:: operator."""

    def __init__(self):
        super().__init__()
        self.calls = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == 'yolact_torch':
            self.calls[func._schema.name.split('::')[1]] += 1
        return func(*args, **(kwargs or {}))


# the operators a train-mode Swin forward calls in each form, drop_path
# rates linspace(0, 0.2, 12): only block 0 of stage 0 has rate 0
TRAIN_CALLS = {'composed': dict(window_attention=12, mlp_block=1),
               'attn_block': dict(attn_block=12, mlp_block=1),
               'whole': dict(swin_block=1, window_attention=11),
               'mixed': dict(swin_block=1, attn_block=2, window_attention=9)}


@pytest.mark.parametrize('form', list(TRAIN_CALLS))
def test_block_forms_route_in_training_as_the_jax_block_does(form):
    """'whole' runs kernel 6 in training only where the block's rate is 0
    (and every block in eval); 'attn_block' runs kernel 5 in every block."""
    model = _swin_model().train()
    model.set_block_forms(('whole', 'attn_block', 'composed', 'composed')
                          if form == 'mixed' else form)
    x = torch.randn(1, 64, 64, 3)
    with _OpCalls() as seen:
        model(x, torch.Generator().manual_seed(0))
    assert seen.calls == TRAIN_CALLS[form]
    if form == 'whole':
        for mode, rate in (('train', 0.0), ('eval', 0.2)):
            model = _swin_model(rate).train(mode == 'train')
            model.set_block_forms('whole')
            with _OpCalls() as seen:
                model(x, torch.Generator().manual_seed(0))
            assert seen.calls == dict(swin_block=12), mode


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
    from yolact_minimal_torch.models.swin import Swin
    model = Swin(dtype=torch.bfloat16, drop_path_rate=0.0)
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
        fresh = Swin(dtype=torch.bfloat16, drop_path_rate=0.0)
        fresh.load_state_dict(model.state_dict())
        want = fresh.eval()(x)
    for a, b, w in zip(before, after, want):
        assert not torch.equal(a, b)
        assert torch.equal(b, w)
