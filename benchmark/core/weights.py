"""The weights of a cell, made on its device from the seed.

The names and shapes are those of the reference built on the meta device
(the published state_dict names, which the program loads too). All values
come from one uniform draw of a torch.Generator on the device, split into
the tensors: convolution weights Xavier-uniform; linear weights and
relative-position bias tables truncated normal (std 0.02, cut at 2 std);
biases uniform in [-0.02, 0.02]; normalization scales in [0.9, 1.1] and
shifts in [-0.05, 0.05]; BatchNorm running means in [-0.05, 0.05] and
variances in [0.9, 1.1]. A traffic mix may set other uniform ranges for the
tensors whose names end as its `weights` keys say (training starts each
bottleneck's residual branch small, as a trained network has it)."""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from benchmark.reference.layers import BatchNorm, Conv, LayerNorm, Linear
from benchmark.reference.swin import Attention
from benchmark.reference.yolact import Yolact

_LO, _HI = 0.5 * (1 + math.erf(-2 / math.sqrt(2))), 0.5 * (1 + math.erf(2 / math.sqrt(2)))


def _plan(model: torch.nn.Module):
    """[(name, shape, kind, a, b)]: uniform in [a, b], or 'tnormal' std a."""
    plan = []
    for mod_name, mod in model.named_modules():
        pre = f'{mod_name}.' if mod_name else ''
        if isinstance(mod, Conv):
            o, i, kh, kw = mod.weight.shape
            bound = math.sqrt(6.0 / ((i + o) * kh * kw))
            plan.append((pre + 'weight', mod.weight.shape, 'uniform', -bound, bound))
        elif isinstance(mod, Linear):
            plan.append((pre + 'weight', mod.weight.shape, 'tnormal', 0.02, 0.0))
        elif isinstance(mod, Attention):
            t = mod.relative_position_bias_table
            plan.append((pre + 'relative_position_bias_table', t.shape, 'tnormal', 0.02, 0.0))
        elif isinstance(mod, (BatchNorm, LayerNorm)):
            plan.append((pre + 'weight', mod.weight.shape, 'uniform', 0.9, 1.1))
            plan.append((pre + 'bias', mod.bias.shape, 'uniform', -0.05, 0.05))
            if isinstance(mod, BatchNorm):
                plan.append((pre + 'running_mean', mod.running_mean.shape, 'uniform', -0.05, 0.05))
                plan.append((pre + 'running_var', mod.running_var.shape, 'uniform', 0.9, 1.1))
        if isinstance(mod, (Conv, Linear)) and mod.bias is not None:
            plan.append((pre + 'bias', mod.bias.shape, 'uniform', -0.02, 0.02))
    return plan


def make_state_dict(model_spec: dict, train_mode: bool, seed: int, device: torch.device,
                    ranges: Optional[Dict[str, list]] = None) -> Dict[str, torch.Tensor]:
    with torch.device('meta'):
        ref = Yolact(model_spec, train_mode=train_mode)
    plan = _plan(ref)
    for suffix, (lo, hi) in (ranges or {}).items():
        plan = [(n, shape, 'uniform', lo, hi) if n.endswith(suffix) else (n, shape, k, a, b)
                for n, shape, k, a, b in plan]
    sizes = [math.prod(shape) for _, shape, *_ in plan]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    sd = {}
    for (name, shape, kind, a, b), piece in zip(plan, flat.split(sizes)):
        if kind == 'uniform':
            value = piece * (b - a) + a
        else:
            value = torch.erfinv(2 * (_LO + piece * (_HI - _LO)) - 1) * (math.sqrt(2) * a)
        sd[name] = value.reshape(shape)
    for name, buf in ref.named_buffers():
        if name.endswith('num_batches_tracked'):
            sd[name] = torch.zeros((), dtype=torch.long, device=device)
    missing = set(ref.state_dict()) - set(sd)
    if missing:
        raise KeyError(f'no initializer for {sorted(missing)[:5]}')
    return sd
