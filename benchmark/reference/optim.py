"""The learning-rate schedule, SGD and AdamW, step by step.

Schedule: linear warmup from 0.1 * lr to lr over `warmup_until` steps, then
x0.1 at each of `lr_steps` (scaled by 8 / batch), in float32; step k runs
at schedule(k). SGD: momentum 0.9 on (gradient + weight_decay * weight).
AdamW (Loshchilov and Hutter, 2019): betas (0.9, 0.999), eps 1e-8, the
decay lr * weight_decay * weight applied before the Adam update, bias
correction by the step count.
"""
from __future__ import annotations

import numpy as np
import torch


def lr_at(train: dict, batch: int, step: int) -> float:
    f = np.float32
    lr = f(train['base_lr'] * batch / 8)
    warm_init = f(lr * 0.1)
    steps = np.asarray([int(s / (batch / 8)) for s in train['lr_steps']], np.float32)
    s = f(step)
    decayed = lr * f(0.1) ** f(np.sum(s >= steps) - 1)
    if train['warmup_until'] > 0 and s <= train['warmup_until']:
        warm = f(lr - warm_init) * (s / f(train['warmup_until'])) + warm_init
        return float(min(warm, decayed))
    return float(decayed)


class Optimizer:
    def __init__(self, train: dict, params):
        self.kind = train['optimizer']
        self.wd = train['weight_decay']
        self.momentum = train.get('momentum', 0.9)
        self.params = list(params)
        self.state = [dict() for _ in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, lr: float):
        self.count += 1
        t = self.count
        for p, st in zip(self.params, self.state):
            if p.grad is None:
                continue
            g = p.grad
            if self.kind == 'sgd':
                d = g + self.wd * p
                st['buf'] = d.clone() if 'buf' not in st else self.momentum * st['buf'] + d
                p -= lr * st['buf']
            elif self.kind == 'adamw':
                p *= 1 - lr * self.wd
                st['m'] = 0.1 * g if 'm' not in st else 0.9 * st['m'] + 0.1 * g
                st['v'] = 0.001 * g * g if 'v' not in st else 0.999 * st['v'] + 0.001 * g * g
                denom = (st['v'] / (1 - 0.999 ** t)).sqrt() + 1e-8
                p -= lr / (1 - 0.9 ** t) * st['m'] / denom
            else:
                raise ValueError(f'unknown optimizer {self.kind!r}')
