"""Training state, the optimizer and its schedule, and the train step.

The port's counterpart of the JAX package's `train_state.py`:

  * `lr_schedule`: linear warmup from 0.1 * lr over `warmup_until` steps,
    then x0.1 at each entry of lr_steps, in float32 as the JAX schedule;
  * `make_optimizer`: SGD (momentum 0.9, coupled weight decay 5e-4) for the
    resnets, which is optax's add_decayed_weights + sgd; AdamW (eps 1e-8,
    weight decay 0.05 on every parameter) for swin, which is optax.adamw.
    Step k runs at lr_schedule(k), as optax's count drives it;
  * `train_step`: the train-mode forward (under bf16 autocast where the
    config asks), the four losses, backward, the optimizer step; BatchNorm
    updates its running statistics in the forward (models/resnet.py). One
    torch.Generator a step, seeded from (seed, step), draws the stochastic
    depth and the lincomb subsample;
  * `opt_state_to_payload` / `restore_opt_state` / `fast_forward_schedule`:
    the optimizer state in the layout JAX's `opt_state_to_payload` writes
    for the same optimizer, so a `latest_*.ckpt` resumes in either package.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from yolact_minimal_torch.config import Config
from yolact_minimal_torch.models.yolact import Yolact
from yolact_minimal_torch.ops.boxes import make_anchors
from yolact_minimal_torch.ops.losses import LossBreakdown, compute_loss
from yolact_minimal_torch.utils.device import resolve_device
from yolact_minimal_torch.utils.weights import (from_jax_variables, graft_backbone,
                                                to_jax_variables)


def lr_schedule(cfg: Config) -> Callable[[int], float]:
    """step -> learning rate, the JAX package's schedule in float32."""
    # the JAX schedule's weak typing: Python floats meet float32 arrays
    lr, warm_init = np.float32(cfg.lr), np.float32(cfg.warmup_init)
    rise = np.float32(cfg.lr - cfg.warmup_init)
    warm_until = cfg.warmup_until
    steps = np.asarray(cfg.lr_steps, np.float32)

    def schedule(step: int) -> float:
        s = np.float32(step)
        decayed = lr * np.float32(0.1) ** np.float32(np.sum(s >= steps) - 1)
        if warm_until > 0 and s <= warm_until:
            warm = rise * (s / np.float32(warm_until)) + warm_init
            return float(min(warm, decayed))
        return float(decayed)

    return schedule


def make_optimizer(cfg: Config, model: torch.nn.Module) -> torch.optim.Optimizer:
    params = list(model.parameters())
    if cfg.optimizer == 'sgd':
        return torch.optim.SGD(params, lr=cfg.lr, momentum=cfg.momentum,
                               weight_decay=cfg.weight_decay)
    if cfg.optimizer == 'adamw':
        return torch.optim.AdamW(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=cfg.weight_decay)
    raise ValueError(f'Unknown optimizer {cfg.optimizer!r}')


@dataclass
class TrainState:
    """The train-mode model on its device, its optimizer, the number of
    steps taken (the schedule's position) and the anchors of cfg.img_size."""
    cfg: Config
    model: Yolact
    optimizer: torch.optim.Optimizer
    anchors: torch.Tensor
    step: int = 0
    seed: int = 0

    @property
    def device(self) -> torch.device:
        return self.anchors.device


def create_train_state(cfg: Config, device: Union[str, torch.device] = 'cuda', seed: int = 0,
                       state_dict: Optional[Dict[str, torch.Tensor]] = None,
                       step: int = 0,
                       backbone: Optional[Dict[str, torch.Tensor]] = None) -> TrainState:
    """A train-mode Yolact with the reference init drawn from a generator
    seeded with `seed`, or `state_dict`'s weights (a state_dict without the
    semantic head keeps its init), and a fresh optimizer at `step`.
    `backbone` (from `utils/weights.py::load_backbone_pth`) is laid over the
    init by `graft_backbone`: strictly for the resnets, leniently for swin."""
    device = resolve_device(device)
    model = Yolact(cfg, train_mode=True)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    if backbone is not None:
        model.load_state_dict(graft_backbone(model.state_dict(), backbone,
                                             strict=cfg.backbone != 'swin_tiny'))
    if state_dict is not None:
        missing, unexpected = model.load_state_dict(state_dict, strict=False)
        missing = [k for k in missing if not k.startswith('semantic_seg_conv.')]
        if missing or unexpected:
            raise KeyError(f'state_dict does not fit {cfg.name}: missing {missing}, '
                           f'unexpected {unexpected}')
    model = model.to(device=device, memory_format=torch.channels_last).train()
    anchors = torch.from_numpy(make_anchors(cfg.img_size, cfg.aspect_ratios, cfg.scales))
    return TrainState(cfg, model, make_optimizer(cfg, model), anchors.to(device),
                      step=step, seed=seed)


def step_generator(state: TrainState) -> torch.Generator:
    """The step's generator, on the state's device, seeded from (seed, step)."""
    return torch.Generator(device=state.device).manual_seed((state.seed << 32) + state.step)


def train_step(state: TrainState, batch: Dict[str, np.ndarray],
               priorities: Optional[torch.Tensor] = None) -> LossBreakdown:
    """One optimizer step on `batch` (a dict of arrays as `assemble_train_batch`
    makes them). Returns the four losses, detached. `priorities` replaces
    the lincomb subsample's random draw (tests)."""
    dev = state.device
    gt = {k: torch.as_tensor(v).to(dev, non_blocking=True) for k, v in batch.items()}
    image = gt.pop('image')
    lr = lr_schedule(state.cfg)(state.step)
    for group in state.optimizer.param_groups:
        group['lr'] = lr
    generator = step_generator(state)
    state.model.train()
    outputs = state.model(image, generator=generator)
    losses = compute_loss(state.cfg, outputs, gt, state.anchors, generator=generator,
                          priorities=priorities)
    state.optimizer.zero_grad(set_to_none=True)
    losses.total.backward()
    state.optimizer.step()
    state.step += 1
    return LossBreakdown(*(t.detach() for t in losses))


# --- the optimizer state in the JAX package's checkpoint layout --------------------

def _param_tree(tensors: Dict[str, torch.Tensor]) -> dict:
    """Per-parameter tensors keyed by parameter name -> the JAX params tree."""
    return to_jax_variables(tensors)['params']


def _slots(state: TrainState, key: str) -> Dict[str, torch.Tensor]:
    opt = state.optimizer
    return {name: opt.state.get(p, {}).get(key, torch.zeros_like(p))
            for name, p in state.model.named_parameters()}


def opt_state_to_payload(state: TrainState) -> dict:
    """The optimizer state as optax's for the same optimizer, through
    flax.serialization.to_state_dict: SGD {'0': {}, '1': {'0': {'trace'},
    '1': {'count'}}}, AdamW {'0': {'count', 'mu', 'nu'}, '1': {}, '2':
    {'count'}}; moments laid out as the JAX params."""
    count = np.asarray(state.step, np.int32)
    if state.cfg.optimizer == 'sgd':
        trace = _param_tree(_slots(state, 'momentum_buffer'))
        return {'0': {}, '1': {'0': {'trace': trace}, '1': {'count': count}}}
    adam_count = next((int(s['step']) for s in state.optimizer.state.values() if 'step' in s),
                      state.step)
    return {'0': {'count': np.asarray(adam_count, np.int32),
                  'mu': _param_tree(_slots(state, 'exp_avg')),
                  'nu': _param_tree(_slots(state, 'exp_avg_sq'))},
            '1': {}, '2': {'count': count}}


def _set_adam(state: TrainState, count: int, mu: Optional[dict] = None,
              nu: Optional[dict] = None):
    for name, p in state.model.named_parameters():
        state.optimizer.state[p] = {
            'step': torch.tensor(float(count), dtype=torch.float32),
            'exp_avg': torch.zeros_like(p) if mu is None else mu[name].to(p),
            'exp_avg_sq': torch.zeros_like(p) if nu is None else nu[name].to(p)}


def restore_opt_state(state: TrainState, payload: dict) -> TrainState:
    """Load a payload of `opt_state_to_payload` (or the JAX package's) into
    the state's optimizer; the schedule resumes at its count."""
    untree = lambda tree: from_jax_variables({'params': tree})
    if state.cfg.optimizer == 'sgd':
        trace = untree(payload['1']['0']['trace'])
        for name, p in state.model.named_parameters():
            state.optimizer.state[p] = {'momentum_buffer': trace[name].to(p)}
        state.step = int(payload['1']['1']['count'])
    else:
        adam = payload['0']
        _set_adam(state, int(adam['count']), untree(adam['mu']), untree(adam['nu']))
        state.step = int(payload['2']['count'])
    return state


def fast_forward_schedule(state: TrainState, step: int) -> TrainState:
    """For a checkpoint without optimizer state: every count to `step` (the
    schedule's and AdamW's bias correction), moments left at zero, as the
    JAX package does."""
    state.step = step
    if state.cfg.optimizer == 'adamw':
        _set_adam(state, step)
    return state
