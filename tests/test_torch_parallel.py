"""The port's data parallelism against the JAX package's, on the CPU.

- `TrainLoader` shards an epoch as the JAX loader does;
- a two-process gloo world (tests/_torch_parallel_worker.py, joined through
  YOLACT_COORDINATOR as the train CLI joins) takes one res50_custom step on
  a global batch of 4, 2 rows a process: its four float32 losses (summed
  over the processes) equal the JAX package's one-process step on the same
  global batch and weights, and the port's, within LOSS_RTOL. The same
  step in float64: the gradient summed over the processes and the updated
  parameters equal the port's one-process float64 step within RES50_TOL of
  each tensor's norm (tests/test_torch_train_step.py's limit without a
  noise floor; measured 4e-13), the running statistics within
  BN_STATS_TOL. In float32 training-mode BatchNorm at a random init
  amplifies rounding (the one-process float32 step lies ~2% of the
  backbone's gradient from the float64 one), and a world sums the
  statistics in another order: two float32 BatchNorms that differ by 1e-7
  a layer give gradients ~5e-4 apart, so float32 holds no gradient;
- the same world with cfg.remat, in float64: the plain one-process step;
- the same world on swin_tiny_custom with stochastic depth at 0.2: the
  processes draw the keep bits of the global batch, so the losses,
  gradients and updated parameters are the one-process step's;
- a Detector over a mesh of two CPU replicas gives the slates of the
  port's and the JAX package's single-device Detectors, with fast and with
  traditional NMS;
- `make_mesh` raises for more CUDA devices than there are.

Every worker has its own timeout: a hung collective fails the test.
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train_step import (ADAM_EPS, BN_STATS_TOL, LOSS_RTOL, RES50_TOL,
                                         SWIN_TOL, _batch, _flat, _hold_tree, _jax_step)
from yolact_minimal_tpu import train_state as JT
from yolact_minimal_tpu.config import get_config as jax_config
from yolact_minimal_tpu.data.coco import TrainLoader as JaxTrainLoader
from yolact_minimal_tpu.models.yolact import Yolact as JaxYolact
from yolact_minimal_tpu.pipeline import Detector as JaxDetector
from yolact_minimal_torch.config import get_config
from yolact_minimal_torch.data.coco import TrainLoader
from yolact_minimal_torch.parallel.mesh import make_mesh
from yolact_minimal_torch.pipeline import Detector
from yolact_minimal_torch.train_state import create_train_state, lr_schedule, train_step
from yolact_minimal_torch.utils.weights import from_jax_variables, to_jax_variables

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / 'tests' / '_torch_parallel_worker.py'
# A process joins in ~4 s and steps in a few more; the bound only turns a
# hung collective into a failure.
WORKER_TIMEOUT = 300
IMG, GLOBAL_BS, PROCESSES = 64, 4, 2
OVERRIDES = dict(img_size=IMG, max_gt=4, base_lr=0.1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _world(tmp_path, name, batch, weights=None, dtypes=('float32',), **overrides):
    """Run the worker in PROCESSES processes on `batch` (with 'priorities'
    where given), a step in each of `dtypes`, the config's OVERRIDES and
    `overrides` set; returns process 0's npz as a dict."""
    np.savez(tmp_path / 'batch.npz', **batch)
    spec = dict(cfg=name, overrides=dict(OVERRIDES, **overrides), dtypes=dtypes, batch=str(tmp_path / 'batch.npz'),
                weights=weights and str(weights), out=str(tmp_path / 'out'))
    (tmp_path / 'spec.json').write_text(json.dumps(spec))
    port = _free_port()
    procs = []
    for rank in range(PROCESSES):
        env = dict(os.environ, PYTHONPATH=str(ROOT), YOLACT_COORDINATOR=f'127.0.0.1:{port}',
                   YOLACT_NUM_PROCESSES=str(PROCESSES), YOLACT_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen([sys.executable, str(WORKER), str(tmp_path / 'spec.json')],
                                      env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), '\n---\n'.join(l[-3000:] for l in logs)
    outs = [dict(np.load(tmp_path / f'out_{rank}.npz')) for rank in range(PROCESSES)]
    # every process holds the same weights after the step
    for out in outs[1:]:
        for dtype in dtypes:
            np.testing.assert_array_equal(out[f'{dtype}/checksum'], outs[0][f'{dtype}/checksum'])
            np.testing.assert_array_equal(out[f'{dtype}/losses'], outs[0][f'{dtype}/losses'])
    return outs[0]


def _trees(out, dtype='float32'):
    """The worker's gradients and state_dict of its `dtype` step as
    JAX-layout trees."""
    def part(prefix):
        return {k[len(prefix):]: torch.from_numpy(v) for k, v in out.items()
                if k.startswith(prefix)}
    return (to_jax_variables(part(f'{dtype}/grad/'))['params'],
            to_jax_variables(part(f'{dtype}/state/')))


def _port_step(name, batch, weights=None, priorities=None, dtype=torch.float32):
    """The port's one-process step on the global batch, in `dtype` ->
    (losses, gradient tree, state tree) as numpy."""
    cfg = get_config(name, mode='train', train_bs=GLOBAL_BS, **OVERRIDES)
    state = create_train_state(cfg, 'cpu', seed=0, state_dict=weights)
    if dtype == torch.float64:
        state.model.double()
        batch = dict(batch, image=batch['image'].astype(np.float64))
    losses = train_step(state, batch, priorities=priorities)
    grads = {k: p.grad.detach() for k, p in state.model.named_parameters()}
    return ([float(t) for t in losses], to_jax_variables(grads)['params'],
            to_jax_variables({k: v.detach() for k, v in state.model.state_dict().items()}))


def test_loader_shards_as_jax():
    class FakeDS:
        def __len__(self):
            return 103

    cfg = get_config('res50_custom', mode='train', img_size=IMG)
    jcfg = jax_config('res50_custom', mode='train', img_size=IMG)
    plans = []
    for p in range(2):
        ours = TrainLoader(FakeDS(), cfg, batch_size=8, num_workers=1, seed=3,
                           process_index=p, process_count=2)
        ref = JaxTrainLoader(FakeDS(), jcfg, batch_size=8, num_workers=1, seed=3,
                             process_index=p, process_count=2)
        ours.epoch = ref.epoch = 1
        plans.append(ours._epoch_indices())
        np.testing.assert_array_equal(plans[-1], ref._epoch_indices())
    # 103 rows -> 51 a process -> 12 batches of 8 / 2 rows
    assert plans[0].shape == plans[1].shape == (12, 4)
    assert not set(plans[0].ravel()) & set(plans[1].ravel())
    with pytest.raises(ValueError, match='divide'):
        TrainLoader(FakeDS(), cfg, batch_size=9, num_workers=1, process_index=0,
                    process_count=2)


def test_two_process_res50_step_equals_one_process(tmp_path):
    jcfg = jax_config('res50_custom', mode='train', train_bs=GLOBAL_BS, **OVERRIDES)
    jstate = JT.create_train_state(jcfg, jax.random.PRNGKey(0))
    weights = from_jax_variables(jax.device_get(
        {'params': jstate.params, 'batch_stats': jstate.batch_stats}))
    torch.save(weights, tmp_path / 'weights.pt')
    batch = _batch(3, GLOBAL_BS, 4, IMG)
    # the priorities JAX's loss draws for the lincomb subsample at step 0
    loss_rng = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), 0))[0]
    n_anchors = len(JT.make_anchors_for(jcfg))
    priorities = np.stack([np.asarray(jax.random.uniform(k, (n_anchors,)))
                           for k in jax.random.split(loss_rng, GLOBAL_BS)])

    out = _world(tmp_path, 'res50_custom', dict(batch, priorities=priorities),
                 tmp_path / 'weights.pt', dtypes=('float32', 'float64'))
    jlosses = _jax_step(jcfg, jstate, batch)[2]
    np.testing.assert_allclose(out['float32/losses'], [float(t) for t in jlosses],
                               rtol=LOSS_RTOL)
    prio = torch.from_numpy(priorities)
    losses = _port_step('res50_custom', batch, weights, prio)[0]
    np.testing.assert_allclose(out['float32/losses'], losses, rtol=LOSS_RTOL)

    losses, grads, after = _port_step('res50_custom', batch, weights, prio, torch.float64)
    np.testing.assert_allclose(out['float64/losses'], losses, rtol=LOSS_RTOL)
    dp_after = _hold_float64(out, grads, after)
    _hold_tree(dp_after['batch_stats'], after['batch_stats'], 'batch_stats', tol=BN_STATS_TOL)


def _hold_float64(out, grads, after):
    """The world's float64 gradients and updated parameters within
    RES50_TOL of each tensor's norm."""
    dp_grads, dp_after = _trees(out, 'float64')
    for what, ours, ref in (('gradient', dp_grads, grads),
                            ('updated parameter', dp_after['params'], after['params'])):
        ours = dict(_flat(ours))
        for k, r in _flat(ref):
            gap, allowed = np.linalg.norm(ours[k] - r), RES50_TOL * np.linalg.norm(r)
            assert gap <= allowed, f'{what} {"/".join(k)}: {gap:.3g} > {allowed:.3g}'
    return dp_after


def test_two_process_remat_step_equals_one_process(tmp_path):
    """cfg.remat in the world: each Bottleneck's recompute sums BatchNorm's
    statistics over the world again and leaves the running statistics as
    the forward left them, so the float64 step is the plain one-process
    step."""
    batch = _batch(3, GLOBAL_BS, 4, IMG)
    out = _world(tmp_path, 'res50_custom', batch, dtypes=('float64',), remat=True)
    losses, grads, after = _port_step('res50_custom', batch, dtype=torch.float64)
    np.testing.assert_allclose(out['float64/losses'], losses, rtol=LOSS_RTOL)
    dp_after = _hold_float64(out, grads, after)
    _hold_tree(dp_after['batch_stats'], after['batch_stats'], 'batch_stats', tol=BN_STATS_TOL)
    counts = {int(v) for k, v in out.items() if k.endswith('num_batches_tracked')}
    assert counts == {1}


def test_two_process_swin_step_draws_the_global_batch(tmp_path):
    """Stochastic depth at its 0.2: a process that drew only its own rows
    would keep other samples than the one-process step."""
    batch = _batch(5, GLOBAL_BS, 4, IMG)
    out = _world(tmp_path, 'swin_tiny_custom', batch)
    losses, grads, after = _port_step('swin_tiny_custom', batch)
    np.testing.assert_allclose(out['float32/losses'], losses, rtol=LOSS_RTOL)
    dp_grads, dp_after = _trees(out)
    _hold_tree(dp_grads, grads, 'gradient', tol=SWIN_TOL)
    # AdamW's first step, as tests/test_torch_train_step.py holds it
    cfg = get_config('swin_tiny_custom', mode='train', **OVERRIDES)
    g_ours, g_ref = dict(_flat(dp_grads)), dict(_flat(grads))
    ours_p = dict(_flat(dp_after['params']))
    for k, p in _flat(after['params']):
        moved = np.abs(g_ours[k] - g_ref[k]) / (np.abs(g_ref[k]) + ADAM_EPS)
        bad = np.abs(ours_p[k] - p) > lr_schedule(cfg)(0) * (2 * moved + 1e-3)
        assert not bad.any(), f'updated parameter {"/".join(k)}: {int(bad.sum())} elements'


def _hold_slates(ours, masks, ref, ref_masks, atol):
    """tests/test_dp_eval.py's check, scores and boxes within `atol`."""
    np.testing.assert_array_equal(np.asarray(ours.ids), np.asarray(ref.ids))
    np.testing.assert_array_equal(np.asarray(ours.valid), np.asarray(ref.valid))
    np.testing.assert_allclose(np.asarray(ours.scores), np.asarray(ref.scores), atol=atol)
    np.testing.assert_allclose(np.asarray(ours.boxes), np.asarray(ref.boxes), atol=atol)
    np.testing.assert_allclose(np.asarray(masks), np.asarray(ref_masks), atol=1e-5)


@pytest.mark.parametrize('traditional', [False, True])
def test_mesh_detector_equals_jax_single_device(traditional):
    """A mesh of two CPU replicas, 4 images at 64, conf_layer scaled x20 so
    that the scores separate (tests/test_torch_pipeline.py): the slates of
    the port's single-device Detector at tests/test_dp_eval.py's
    tolerances, and the JAX single-device Detector's at those tolerances
    but for scores and boxes, held at the cross-stack 1e-5 of
    tests/test_torch_pipeline.py and test_torch_traditional_nms.py (two
    forward passes; measured 3e-6)."""
    cfg = jax_config('res50_coco', img_size=IMG, nms_pre_topk=128, traditional_nms=traditional)
    init = jax.jit(lambda key: JaxYolact(cfg=cfg).init(
        key, jnp.zeros((1, IMG, IMG, 3), jnp.float32), train=False))
    v = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(1)))
    v['params']['prediction_layers']['conf_layer']['kernel'] = \
        v['params']['prediction_layers']['conf_layer']['kernel'] * 20
    images = np.random.RandomState(2).normal(size=(4, IMG, IMG, 3)).astype(np.float32)
    ref, ref_masks, _ = jax.device_get(JaxDetector(cfg, v, static_weights=False)(
        jnp.asarray(images)))
    ours_cfg = get_config('res50_coco', img_size=IMG, nms_pre_topk=128,
                          traditional_nms=traditional)
    det = Detector(ours_cfg, from_jax_variables(v), mesh=make_mesh(2, 'cpu'))
    assert len(det.replicas) == 2 and det.replicas[1].model is not det.model
    ours, masks, _ = det(images)
    assert ours.valid.sum() > 10
    single, single_masks, _ = Detector(ours_cfg, from_jax_variables(v), device='cpu')(images)
    _hold_slates(ours, masks, single, single_masks, atol=1e-6)
    _hold_slates(ours, masks, ref, ref_masks, atol=1e-5)
    with pytest.raises(ValueError, match='not divisible'):
        det(images[:3])


def test_make_mesh_raises_for_devices_there_are_not():
    if torch.cuda.device_count() >= 2:
        pytest.skip('this machine has two CUDA devices')
    with pytest.raises(ValueError, match='CUDA device'):
        make_mesh(2)
    assert make_mesh(3, 'cpu') == [torch.device('cpu')] * 3
