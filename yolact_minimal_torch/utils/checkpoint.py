"""Checkpoints in the JAX package's format and filename contract.

A `.ckpt` is a flax msgpack dict: {'params', 'batch_stats'} of the JAX
model's variables always; `latest` checkpoints written by training also
carry {'opt_state', 'step'}, and swin's (a backbone without BatchNorm)
carry `batch_stats: None`. `best_{maskmAP}_{cfg}_{step}.ckpt` and
`latest_{cfg}_{step}.ckpt` are kept one of each per config, the step parsed
back out of the name. Read and written with the port's own msgpack codec
(utils/msgpack.py): no flax, no msgpack.

`load_weights_auto` turns a `.ckpt` or a reference-format `.pth` into the
port's state_dict; `save_checkpoint` takes JAX-format variables, which
`utils/weights.py::to_jax_variables` makes from a state_dict.
"""
from __future__ import annotations

import glob
import os
import os.path as osp
import re
from typing import Dict, Optional

import numpy as np
import torch

from yolact_minimal_torch.utils import msgpack
from yolact_minimal_torch.utils.weights import from_jax_variables, load_pth


def _to_host(tree):
    """Every leaf as a numpy array (a Python or numpy scalar as a 0-d one)
    and dict keys sorted, as the JAX package's tree map leaves them: the
    file is then byte for byte the JAX package's."""
    if isinstance(tree, dict):
        return {k: _to_host(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_to_host(v) for v in tree]
    return None if tree is None else np.asarray(tree)


def save_checkpoint(path: str, variables: dict):
    os.makedirs(osp.dirname(path) or '.', exist_ok=True)
    with open(path, 'wb') as f:
        f.write(msgpack.packb(_to_host(variables)))


def load_checkpoint(path: str) -> dict:
    with open(path, 'rb') as f:
        return msgpack.unpackb(f.read())


def save_best(variables: dict, mask_map: float, cfg_name: str, step: int,
              weight_dir: str = 'weights') -> Optional[str]:
    """Keep exactly one best checkpoint per config; overwrite when the new
    mask mAP is >= the one parsed from the existing filename."""
    existing = [w for w in glob.glob(osp.join(weight_dir, 'best*.ckpt'))
                if cfg_name in osp.basename(w)]
    assert len(existing) <= 1, 'Multiple best checkpoints found.'
    best = float(osp.basename(existing[0]).split('_')[1]) if existing else 0.0
    if mask_map < best:
        return None
    if existing:
        os.remove(existing[0])
    path = osp.join(weight_dir, f'best_{mask_map}_{cfg_name}_{step}.ckpt')
    save_checkpoint(path, variables)
    print(f"\nSaving the best model as '{osp.basename(path)}'.\n")
    return path


def save_latest(variables: dict, cfg_name: str, step: int,
                weight_dir: str = 'weights') -> str:
    existing = [w for w in glob.glob(osp.join(weight_dir, 'latest*.ckpt'))
                if cfg_name in osp.basename(w)]
    assert len(existing) <= 1, 'Multiple latest checkpoints found.'
    if existing:
        os.remove(existing[0])
    path = osp.join(weight_dir, f'latest_{cfg_name}_{step}.ckpt')
    save_checkpoint(path, variables)
    print(f"\nSaving the latest model as '{osp.basename(path)}'.\n")
    return path


def step_from_name(path: str) -> int:
    m = re.search(r'_(\d+)\.(?:ckpt|pth|msgpack)$', path)
    if not m:
        raise ValueError(f'No step in checkpoint name {path!r}')
    return int(m.group(1))


def load_weights_auto(path: str) -> Dict[str, torch.Tensor]:
    """A `.ckpt` of the JAX package or a reference `.pth` -> the port's
    state_dict for inference: the train-only semantic head, the optimizer
    state, the step and collections stored as None (swin's batch_stats) are
    dropped."""
    if not path.endswith('.ckpt'):
        return load_pth(path)
    variables = load_checkpoint(path)
    variables['params'].pop('semantic_seg_conv', None)
    variables.pop('opt_state', None)
    variables.pop('step', None)
    for k in [k for k, v in variables.items() if v is None]:
        variables.pop(k)
    return from_jax_variables(variables)
