"""The port's training step against the JAX package's, on the CPU.

- `lr_schedule` at the points tests/test_train_step.py checks;
- SGD and AdamW over 5 steps of fixed gradients against optax (1e-6);
- one res50_custom step at 128 (train_bs 2) and one swin_tiny_custom step
  at 64 with stochastic depth off, from the same weights (carried by
  `from_jax_variables`) on the same seeded batch: the four losses, every
  parameter's gradient, the updated parameters and BatchNorm's running
  statistics against the JAX package's train step (its loss function under
  jax.grad, then `TrainState.apply_gradients`, which is what
  `make_train_step` runs). The batch is drawn row by row: duplicated rows
  make exact OHEM ties;
- the same res50 step, well conditioned: each bottleneck's last BatchNorm
  scale at 0.02 of its init, so each block starts near the identity, and
  the JAX BatchNorm's variance taken in two passes. Each part of the
  network's gradient and update is held at 1e-4, each tensor at 1e-2; once
  more with cfg.remat on both sides;
- 24 res50 steps and 12 swin AdamW steps at drop_path_rate 0.2 lower the
  loss (the JAX tests' windowed rule);
- a port checkpoint resumes in the JAX `restore_opt_state` with equal
  moments, and a JAX checkpoint in the port.
"""
import functools
from unittest import mock

import numpy as np
import pytest
import torch

import flax.linen as flax_nn
import flax.serialization as fser
import jax
import jax.numpy as jnp
import optax

from yolact_minimal_tpu import train_state as JT
from yolact_minimal_tpu.config import get_config as jax_get_config
from yolact_minimal_tpu.models import swin as jax_swin
from yolact_minimal_tpu.ops.losses import compute_loss as jax_compute_loss
from yolact_minimal_tpu.utils import checkpoint as jax_ckpt
from yolact_minimal_torch.config import get_config
from yolact_minimal_torch.models.swin import SwinBlock
from yolact_minimal_torch.train_state import (create_train_state, lr_schedule, make_optimizer,
                                              opt_state_to_payload, restore_opt_state,
                                              train_step)
from yolact_minimal_torch.utils.checkpoint import load_checkpoint, load_weights_auto, save_latest
from yolact_minimal_torch.utils.weights import from_jax_variables, to_jax_variables

torch.set_num_threads(1)

# The whole network in float32 on both sides, summed in another order.
# Losses within 1e-4 relative.
LOSS_RTOL = 1e-4
# swin (no BatchNorm): each gradient within 1e-4 of its tensor's largest
# magnitude (measured: 3e-6 in L2 norm). AdamW's first step moves each
# parameter by lr * g / (|g| + eps) (+ decay), eps = 1e-8, which moves by
# at most lr * 2 |g' - g| / (|g| + eps) when g becomes g': a gradient
# element near 0 that float32 noise moves, or flips, moves its parameter by
# up to 2 lr (measured: 0.35 lr where g = 3e-10 against -5e-9). Each
# updated parameter is held within lr * (2 |g' - g| / (|g| + eps) + 1e-3)
# of the JAX package's, g' the port's gradient (held above).
SWIN_TOL = 1e-4
ADAM_EPS = 1e-8
# res50: training-mode BatchNorm at a random init amplifies float32 noise
# (channels of tiny batch variance; 4x4 maps at 128 px), so the JAX step
# does not agree with itself to better than ~9% (L2, per tensor) when only
# the batch order changes, which only reorders sums. Each res50 tensor is
# held to RES50_FLOOR_FACTOR times that floor, plus RES50_TOL of its norm:
# a wrong formula moves every tensor by ~100%, far outside it.
RES50_FLOOR_FACTOR = 2.0
RES50_TOL = 1e-5
# The running statistics take 0.1 of the batch statistics, which carry the
# forward's noise (and flax's E[x^2] - E[x]^2 variance): within 1e-3 of each
# tensor's largest magnitude (measured 1.1e-4; the JAX step alone with the
# batch reversed, 1.7e-4).
BN_STATS_TOL = 1e-3
# The well-conditioned res50 step. At the seeded init each of the 16
# bottlenecks adds a branch as large as its input, and float32 rounding
# grows by ~1.2x a BatchNorm (the port's forward against its own float64
# step: 2e-7 after the stem, 2.5e-4 after layer 4; its gradients 4.5e-2
# off float64 in the backbone, 7.6e-3 in proto_net). With each block's last
# BatchNorm scale at NEAR_IDENTITY of its init the port's float32 gradients
# lie within 9.4e-5 of its float64 ones, tensor by tensor. The JAX step
# adds its own: flax's default variance E[x^2] - E[x]^2 cancels where a
# channel's mean is large beside its spread (up to 1.3e-2 off the port's
# float64 step); `use_fast_variance=False` takes the same biased variance
# in two passes. What stays is a ReLU input that rounding moves across 0,
# which changes the gradient of the layers below it: measured up to 2e-3
# in one or two of 195 tensors (4.5e-3 to 1.3e-2 at scales 0.01 and 0.05).
# So the parts (backbone, fpn, proto_net, prediction_layers,
# semantic_seg_conv) are held as wholes within WELL_PART_TOL in L2 norm
# (measured: backbone 5.5e-5, the others 4e-6), each tensor within
# WELL_TENSOR_TOL (a wrong formula moves a tensor by ~100%).
NEAR_IDENTITY = 0.02
WELL_PART_TOL = 1e-4
WELL_TENSOR_TOL = 1e-2


def _batch(seed, b, g, img):
    rng = np.random.RandomState(seed)
    xy1 = rng.uniform(0, 0.5, size=(b, g, 2)).astype(np.float32)
    wh = rng.uniform(0.2, 0.45, size=(b, g, 2)).astype(np.float32)
    return dict(image=rng.randn(b, img, img, 3).astype(np.float32),
                boxes=np.concatenate([xy1, xy1 + wh], 2),
                labels=rng.randint(0, 4, size=(b, g)).astype(np.int32),
                valid=np.ones((b, g), bool),
                masks_proto=(rng.rand(b, g, img // 4, img // 4) > 0.5).astype(np.uint8),
                masks_seg=(rng.rand(b, g, img // 8, img // 8) > 0.5).astype(np.uint8))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def _hold_tree(ours: dict, ref: dict, what: str, tol=SWIN_TOL):
    """Two JAX-layout trees of numpy arrays, leaf by leaf, each within tol
    of the reference leaf's largest magnitude."""
    ours, ref = dict(_flat(ours)), dict(_flat(ref))
    assert ours.keys() == ref.keys(), what
    for k, r in ref.items():
        scale = max(float(np.abs(r).max()), 1e-12)
        np.testing.assert_allclose(ours[k], r, rtol=0, atol=tol * scale,
                                   err_msg=f'{what} {"/".join(k)}')


def _hold_to_floor(ours: dict, ref: dict, floor: dict, what: str):
    """Leaf by leaf, |ours - ref| <= RES50_FLOOR_FACTOR * |floor - ref| +
    RES50_TOL * |ref| in L2 norm, where `floor` is the JAX step on the
    batch in the other order."""
    ours, ref, floor = dict(_flat(ours)), dict(_flat(ref)), dict(_flat(floor))
    assert ours.keys() == ref.keys() == floor.keys(), what
    for k, r in ref.items():
        gap = np.linalg.norm(ours[k] - r)
        allowed = RES50_FLOOR_FACTOR * np.linalg.norm(floor[k] - r) + RES50_TOL * np.linalg.norm(r)
        assert gap <= allowed, f'{what} {"/".join(k)}: {gap:.3g} > {allowed:.3g}'


def test_lr_schedule_equals_jax():
    cfg = get_config('res101_coco', mode='train', train_bs=8)
    ours, ref = lr_schedule(cfg), JT.lr_schedule(jax_get_config('res101_coco', mode='train',
                                                                 train_bs=8))
    lr, wi = cfg.lr, cfg.warmup_init
    points = {0: wi, 250: (lr - wi) * 0.5 + wi, 500: lr, 100000: lr, 280000: lr * 0.1,
              600000: lr * 0.01, 650000: lr * 0.001}
    for step, want in points.items():
        assert ours(step) == pytest.approx(want)
        assert ours(step) == float(ref(step))


@pytest.mark.parametrize('name', ['res50_custom', 'swin_tiny_custom'])
def test_optimizer_equals_optax_over_five_steps(name):
    """SGD (momentum, coupled decay) and AdamW against optax, base_lr 0.1 so
    the steps move the parameters."""
    cfg = get_config(name, mode='train', base_lr=0.1)
    rng = np.random.RandomState(0)
    shapes = {'a': (3, 4), 'b': (5,)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    module = torch.nn.Module()
    for k, v in params.items():
        module.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    opt = make_optimizer(cfg, module)
    tx = JT.make_optimizer(jax_get_config(name, mode='train', base_lr=0.1))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jp)
    sched = lr_schedule(cfg)
    for step in range(5):
        grads = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
        for group in opt.param_groups:
            group['lr'] = sched(step)
        for k, p in module.named_parameters():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6,
                                       err_msg=f'{name} step {step} {k}')


def _jax_step(cfg, state, batch):
    """The body of JAX's make_train_step: the loss under value_and_grad with
    mutable batch_stats, then apply_gradients."""
    anchors = jnp.asarray(JT.make_anchors_for(cfg))
    rng = jax.random.fold_in(jax.random.PRNGKey(0), state.step)
    loss_rng, dropout_rng = jax.random.split(rng)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    @jax.jit
    def grad_fn(params, batch_stats):
        def loss_fn(params):
            variables = {'params': params}
            if batch_stats is not None:
                variables['batch_stats'] = batch_stats
            outputs, mutated = state.apply_fn(variables, jbatch['image'], train=True,
                                              mutable=['batch_stats'],
                                              rngs={'dropout': dropout_rng})
            losses = jax_compute_loss(cfg, outputs, jbatch, anchors, loss_rng)
            return losses.total, (losses, mutated)
        return jax.grad(loss_fn, has_aux=True)(params)

    grads, (losses, mutated) = grad_fn(state.params, state.batch_stats)
    new_stats = mutated.get('batch_stats') or state.batch_stats
    return state.apply_gradients(grads=grads, batch_stats=new_stats), grads, losses


def _one_step(name, img):
    jcfg = jax_get_config(name, mode='train', img_size=img, max_gt=4, train_bs=2, base_lr=0.1)
    cfg = get_config(name, mode='train', img_size=img, max_gt=4, train_bs=2, base_lr=0.1)
    jstate = JT.create_train_state(jcfg, jax.random.PRNGKey(0))
    variables = jax.device_get({'params': jstate.params, 'batch_stats': jstate.batch_stats})
    state = create_train_state(cfg, 'cpu', state_dict=from_jax_variables(variables))
    for m in state.model.modules():
        if isinstance(m, SwinBlock):
            m.drop_path_rate = 0.0                # parity: stochastic depth off
    batch = _batch(3, 2, 4, img)
    losses = train_step(state, batch)
    jstate2, grads, jlosses = _jax_step(jcfg, jstate, batch)
    # the noise floor: the same JAX step on the batch in the other order
    floor = None
    if name.startswith('res50'):
        floor = _jax_step(jcfg, jstate, {k: v[::-1].copy() for k, v in batch.items()})
    return cfg, state, losses, jstate2, grads, jlosses, floor


@functools.lru_cache(maxsize=None)
def _res50_step():
    return _one_step('res50_custom', 128)


@functools.lru_cache(maxsize=None)
def _swin_step():
    # the JAX SwinTiny without stochastic depth: Yolact builds it by name
    orig = jax_swin.SwinTiny
    jax_swin.SwinTiny = functools.partial(orig, drop_path_rate=0.0)
    try:
        return _one_step('swin_tiny_custom', 64)
    finally:
        jax_swin.SwinTiny = orig


@pytest.mark.parametrize('which', ['res50', 'swin'])
def test_one_train_step_equals_jax(which):
    cfg, state, losses, jstate2, grads, jlosses, floor = (
        _res50_step if which == 'res50' else _swin_step)()
    for got, want in zip(losses, jlosses):
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    named = dict(state.model.named_parameters())
    ours_grads = to_jax_variables({k: p.grad for k, p in named.items()})['params']
    after = to_jax_variables(state.model.state_dict())
    grads, params = jax.device_get(grads), jax.device_get(jstate2.params)
    if which == 'swin':
        _hold_tree(ours_grads, grads, 'gradient')
        ours_p, g_ref = dict(_flat(after['params'])), dict(_flat(grads))
        g_ours = dict(_flat(ours_grads))
        for k, p in dict(_flat(params)).items():
            moved = np.abs(g_ours[k] - g_ref[k]) / (np.abs(g_ref[k]) + ADAM_EPS)
            allowed = lr_schedule(cfg)(0) * (2 * moved + 1e-3)
            bad = np.abs(ours_p[k] - p) > allowed
            assert not bad.any(), f'updated parameter {"/".join(k)}: {int(bad.sum())} elements'
        assert 'batch_stats' not in after and jstate2.batch_stats is None
    else:
        fstate, fgrads, flosses = jax.device_get(floor)
        for got, want in zip(flosses, jlosses):      # the floor's losses: the same sums
            np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
        _hold_to_floor(ours_grads, grads, fgrads, 'gradient')
        _hold_to_floor(after['params'], params, fstate.params, 'updated parameter')
        _hold_tree(after['batch_stats'], jax.device_get(jstate2.batch_stats), 'batch_stats',
                   tol=BN_STATS_TOL)
    assert state.step == int(jstate2.step) == 1


def _hold_parts(ours: dict, ref: dict, what: str, stored: dict = None):
    """Two JAX-layout trees: each top-level part within WELL_PART_TOL of
    its L2 norm, each leaf within WELL_TENSOR_TOL of its own. For updates,
    `stored` holds the updated parameters: an update is resolved no finer
    than the float32 spacing of the value that stores it, which is added
    to the allowance."""
    ours, ref = dict(_flat(ours)), dict(_flat(ref))
    slack = {k: np.linalg.norm(np.spacing(v)) for k, v in _flat(stored)} if stored else {}
    assert ours.keys() == ref.keys(), what
    parts = {}
    for k, r in ref.items():
        d, n, e = np.linalg.norm(ours[k] - r), np.linalg.norm(r), slack.get(k, 0.0)
        assert d <= WELL_TENSOR_TOL * n + e, f'{what} {"/".join(k)}: {d:.3g} of {n:.3g}'
        sums = parts.setdefault(k[0], np.zeros(3))
        sums += (d * d, n * n, e * e)
    for part, (d2, n2, e2) in parts.items():
        assert np.sqrt(d2) <= WELL_PART_TOL * np.sqrt(n2) + np.sqrt(e2), \
            f'{what} {part}: {np.sqrt(d2 / n2):.3g}'


def test_res50_near_identity_step_equals_jax():
    """The port's seeded init with every bottleneck's bn3 scale at
    NEAR_IDENTITY, carried to the JAX step by `to_jax_variables`; the JAX
    ResNet built with two-pass BatchNorm variance. The same batch as the
    step above."""
    _near_identity_step(remat=False)


def test_res50_near_identity_remat_step_equals_jax():
    """The same step with cfg.remat on both sides: the port's checkpointed
    Bottlenecks against the JAX package's nn.remat ones."""
    _near_identity_step(remat=True)


def _near_identity_step(remat: bool):
    cfg = get_config('res50_custom', mode='train', img_size=128, max_gt=4, train_bs=2,
                     base_lr=0.1, remat=remat)
    jcfg = jax_get_config('res50_custom', mode='train', img_size=128, max_gt=4, train_bs=2,
                          base_lr=0.1, remat=remat)
    state = create_train_state(cfg, 'cpu', seed=0)
    with torch.no_grad():
        for name, p in state.model.named_parameters():
            if name.endswith('bn3.weight'):
                p.mul_(NEAR_IDENTITY)
    variables = to_jax_variables({k: v.clone() for k, v in state.model.state_dict().items()})
    before = variables['params']
    batch = _batch(3, 2, 4, 128)
    two_pass = functools.partial(flax_nn.BatchNorm, use_fast_variance=False)
    with mock.patch.object(flax_nn, 'BatchNorm', two_pass):
        jstate = JT.create_train_state(jcfg, jax.random.PRNGKey(0), variables=variables)
        jstate2, grads, jlosses = jax.device_get(_jax_step(jcfg, jstate, batch))
    losses = train_step(state, batch)
    for got, want in zip(losses, jlosses):
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    named = dict(state.model.named_parameters())
    _hold_parts(to_jax_variables({k: p.grad for k, p in named.items()})['params'], grads,
                'gradient')
    after = to_jax_variables(state.model.state_dict())
    step = lambda new: jax.tree_util.tree_map(np.subtract, new, before)
    _hold_parts(step(after['params']), step(jstate2.params), 'update', jstate2.params)
    _hold_tree(after['batch_stats'], jstate2.batch_stats, 'batch_stats', tol=WELL_PART_TOL)


@pytest.mark.parametrize('name,img,steps', [('res50_custom', 128, 24),
                                            ('swin_tiny_custom', 64, 12)])
def test_repeated_steps_lower_the_loss(name, img, steps):
    """Stochastic depth at its 0.2 (swin); the JAX tests' windowed rule, with
    their learning rates (swin's raised to 1e-3 as test_swin_train.py does)."""
    extra = {'base_lr': 1e-3} if name.startswith('swin') else {}
    cfg = get_config(name, mode='train', img_size=img, max_gt=4, train_bs=2, **extra)
    state = create_train_state(cfg, 'cpu', seed=0)
    rates = [m.drop_path_rate for m in state.model.modules() if isinstance(m, SwinBlock)]
    if rates:
        np.testing.assert_allclose(rates, np.linspace(0, 0.2, 12))
    batch = _batch(7, 2, 4, img)
    history = []
    for _ in range(steps):
        total = float(train_step(state, batch).total)
        assert np.isfinite(total)
        history.append(total)
    window = 4 if name.startswith('res50') else 3
    assert np.mean(history[-window:]) < np.mean(history[:window]), history


def test_port_checkpoint_resumes_in_jax(tmp_path):
    for step_fn, name in ((_res50_step, 'res50_custom'), (_swin_step, 'swin_tiny_custom')):
        cfg, state = step_fn()[:2]
        payload = opt_state_to_payload(state)
        v = to_jax_variables(state.model.state_dict())
        path = save_latest({'params': v['params'], 'batch_stats': v.get('batch_stats'),
                            'opt_state': payload, 'step': state.step}, cfg.name, state.step,
                           weight_dir=str(tmp_path))
        variables = jax_ckpt.load_weights_auto(path, include_semantic=True)
        jpayload = variables.pop('opt_state')
        assert int(variables.pop('step')) == 1
        jcfg = jax_get_config(name, mode='train', img_size=cfg.img_size, max_gt=4, train_bs=2,
                              base_lr=0.1)
        jstate = JT.restore_opt_state(JT.create_train_state(jcfg, jax.random.PRNGKey(0),
                                                            variables=variables, step=1),
                                      jpayload)
        restored = jax.device_get(fser.to_state_dict(jstate.opt_state))
        _hold_tree(restored, payload, f'{name} moments', tol=0)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    for step_fn, name in ((_res50_step, 'res50_custom'), (_swin_step, 'swin_tiny_custom')):
        cfg, jstate2 = step_fn()[0], step_fn()[3]
        path = jax_ckpt.save_latest(
            {'params': jax.device_get(jstate2.params),
             'batch_stats': jax.device_get(jstate2.batch_stats),
             'opt_state': JT.opt_state_to_payload(jstate2.opt_state),
             'step': int(jstate2.step)}, cfg.name, 1, weight_dir=str(tmp_path))
        state = create_train_state(cfg, 'cpu', state_dict=load_weights_auto(
            path, include_semantic=True))
        assert any(k.startswith('semantic_seg_conv.') for k in state.model.state_dict())
        restore_opt_state(state, load_checkpoint(path)['opt_state'])
        assert state.step == 1
        want = jax.device_get(fser.to_state_dict(jstate2.opt_state))
        _hold_tree(opt_state_to_payload(state), want, f'{name} moments', tol=0)
        _hold_tree(to_jax_variables(state.model.state_dict())['params'],
                   jax.device_get(jstate2.params), f'{name} params', tol=0)
