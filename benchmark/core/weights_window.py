"""The weights of a cell on `reference/yolact_window.py`, made on its
device from the seed by `core/weights.py`'s rule: the same plan of
initializers in the same module order (the window's bias tables sized
(2w-1)^2), one uniform draw split into the tensors, the same ranges a
traffic mix may set. At window 7 it gives what `core/weights.py` gives."""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from benchmark.core import weights
from benchmark.reference.swin_window import Attention
from benchmark.reference.yolact_window import Yolact


def _plan(model: torch.nn.Module):
    """core/weights.py's plan, with this reference's attention tables."""
    plan = []
    for mod_name, mod in model.named_modules():
        pre = f'{mod_name}.' if mod_name else ''
        if isinstance(mod, Attention):
            t = mod.relative_position_bias_table
            plan.append((pre + 'relative_position_bias_table', t.shape, 'tnormal', 0.02, 0.0))
        elif not any(True for _ in mod.children()):
            plan += [(pre + name, *rest) for name, *rest in weights._plan(mod)]
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
            value = torch.erfinv(2 * (weights._LO + piece * (weights._HI - weights._LO)) - 1) \
                * (math.sqrt(2) * a)
        sd[name] = value.reshape(shape)
    missing = set(ref.state_dict()) - set(sd)
    if missing:
        raise KeyError(f'no initializer for {sorted(missing)[:5]}')
    return sd
