"""The weight bridge: JAX variables or reference `.pth` files -> the port's
state_dict.

`from_jax_variables` is the port's own copy of the JAX package's reverse
converter (flax variables -> reference key names): conv kernels HWIO -> OIHW,
BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var, and
the named FPN/proto/head modules back to the reference Sequential indices.
For swin_tiny it is the reverse of the JAX package's `_convert_swin_entry`:
Dense kernels [in, out] -> Linear weights [out, in], LayerNorm scale ->
weight, and the stage/block tree back to `layers.{s}.blocks.{b}`. It takes
the variables as nested dicts of numpy arrays and imports nothing of JAX.

`to_jax_variables` goes the other way, state_dict -> JAX variables: the
port's own copy of the JAX package's `convert_state_dict` (resnet) and
`_convert_swin_entry` (swin), which `utils/checkpoint.py` writes as a
`.ckpt` the JAX package reads.
"""
from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch

_FPN_MAP = {
    'lat3': 'lat_layers.0', 'lat4': 'lat_layers.1', 'lat5': 'lat_layers.2',
    'pred3': 'pred_layers.0.0', 'pred4': 'pred_layers.1.0', 'pred5': 'pred_layers.2.0',
    'down6': 'downsample_layers.0.0', 'down7': 'downsample_layers.1.0',
}
_PROTO_MAP = {
    'proto1_0': 'proto1.0', 'proto1_1': 'proto1.2', 'proto1_2': 'proto1.4',
    'proto2_0': 'proto2.0', 'proto2_1': 'proto2.2',
}
_HEAD_MAP = {
    'upfeature': 'upfeature.0', 'bbox_layer': 'bbox_layer',
    'conf_layer': 'conf_layer', 'coef_layer': 'coef_layer.0',
}


def _conv(w) -> torch.Tensor:
    """HWIO -> OIHW."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(w), (3, 2, 0, 1))))


def _tensor(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, dtype=np.float32))


def _linear(w) -> torch.Tensor:
    """Dense kernel [in, out] -> Linear weight [out, in]."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(w, dtype=np.float32).T))


def _put_norm(out: dict, prefix: str, p: dict):
    out[f'{prefix}.weight'] = _tensor(p['scale'])
    out[f'{prefix}.bias'] = _tensor(p['bias'])


def _put_dense(out: dict, prefix: str, p: dict):
    out[f'{prefix}.weight'] = _linear(p['kernel'])
    if 'bias' in p:
        out[f'{prefix}.bias'] = _tensor(p['bias'])


def swin_from_jax_params(bb: dict, prefix: str = 'backbone.') -> Dict[str, torch.Tensor]:
    """The params of a JAX SwinTiny (nested dicts of numpy arrays) ->
    reference-format state_dict entries under `prefix`."""
    out: Dict[str, torch.Tensor] = {}
    for mod, p in bb.items():
        stage = re.match(r'^stage(\d+)$', mod)
        norm = re.match(r'^out_norm(\d)$', mod)
        if mod == 'patch_embed':
            out[f'{prefix}patch_embed.proj.weight'] = _conv(p['kernel'])
            out[f'{prefix}patch_embed.proj.bias'] = _tensor(p['bias'])
        elif mod == 'patch_norm':
            _put_norm(out, f'{prefix}patch_embed.norm', p)
        elif norm:
            _put_norm(out, f'{prefix}norm{norm.group(1)}', p)
        elif stage:
            pre = f'{prefix}layers.{stage.group(1)}'
            for sub, q in p.items():
                block = re.match(r'^block(\d+)$', sub)
                if sub == 'downsample':
                    _put_norm(out, f'{pre}.downsample.norm', q['norm'])
                    _put_dense(out, f'{pre}.downsample.reduction', q['reduction'])
                elif block:
                    b = f'{pre}.blocks.{block.group(1)}'
                    _put_norm(out, f'{b}.norm1', q['norm1'])
                    _put_norm(out, f'{b}.norm2', q['norm2'])
                    _put_dense(out, f'{b}.attn.qkv', q['attn']['qkv'])
                    _put_dense(out, f'{b}.attn.proj', q['attn']['proj'])
                    out[f'{b}.attn.relative_position_bias_table'] = \
                        _tensor(q['attn']['rel_bias_table'])
                    _put_dense(out, f'{b}.mlp.fc1', q['mlp']['fc1'])
                    _put_dense(out, f'{b}.mlp.fc2', q['mlp']['fc2'])
                else:
                    raise ValueError(f'unexpected swin module {mod}/{sub}')
        else:
            raise ValueError(f'unexpected backbone module {mod!r}')
    return out


def from_jax_variables(variables: dict) -> Dict[str, torch.Tensor]:
    """{'params': ..., 'batch_stats': ...} of a Yolact (nested dicts of
    numpy arrays) -> reference-format state_dict of float32 tensors."""
    params = variables['params']
    stats = variables.get('batch_stats', {})
    out: Dict[str, torch.Tensor] = {}

    def put_bn(prefix: str, p: dict, s: dict):
        out[f'{prefix}.weight'] = _tensor(p['scale'])
        out[f'{prefix}.bias'] = _tensor(p['bias'])
        out[f'{prefix}.running_mean'] = _tensor(s['mean'])
        out[f'{prefix}.running_var'] = _tensor(s['var'])

    bb_p, bb_s = params['backbone'], stats.get('backbone', {})
    if any(k.startswith('stage') for k in bb_p):
        out.update(swin_from_jax_params(bb_p))
        bb_p = {}
    for mod, p in bb_p.items():
        if mod == 'conv1':
            out['backbone.conv1.weight'] = _conv(p['kernel'])
        elif mod == 'bn1':
            put_bn('backbone.bn1', p, bb_s['bn1'])
        else:
            m = re.match(r'^layer(\d+)_(\d+)$', mod)
            if not m:
                raise ValueError(f'unexpected backbone module {mod!r}')
            pre = f'backbone.layers.{m.group(1)}.{m.group(2)}'
            for leaf, v in p.items():
                if leaf == 'downsample_conv':
                    out[f'{pre}.downsample.0.weight'] = _conv(v['kernel'])
                elif leaf == 'downsample_bn':
                    put_bn(f'{pre}.downsample.1', v, bb_s[mod][leaf])
                elif leaf.startswith('conv'):
                    out[f'{pre}.{leaf}.weight'] = _conv(v['kernel'])
                elif leaf.startswith('bn'):
                    put_bn(f'{pre}.{leaf}', v, bb_s[mod][leaf])

    for section, name_map in (('fpn', _FPN_MAP), ('proto_net', _PROTO_MAP),
                              ('prediction_layers', _HEAD_MAP)):
        for mod, p in params.get(section, {}).items():
            out[f'{section}.{name_map[mod]}.weight'] = _conv(p['kernel'])
            if 'bias' in p:
                out[f'{section}.{name_map[mod]}.bias'] = _tensor(p['bias'])
    return out


# --- state_dict -> JAX variables ------------------------------------------------

def _hwio(w) -> np.ndarray:
    """OIHW -> HWIO."""
    return np.ascontiguousarray(np.transpose(_np(w), (2, 3, 1, 0)))


def _np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _set(tree: dict, path: Tuple[str, ...], value: np.ndarray):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


_BN_LEAVES = {'weight': (0, 'scale'), 'bias': (0, 'bias'),
              'running_mean': (1, 'mean'), 'running_var': (1, 'var')}


def _bn_entry(leaf: str, value, trees, path: Tuple[str, ...]):
    """One BatchNorm tensor into params (scale, bias) or batch_stats (mean,
    var); num_batches_tracked is dropped."""
    if leaf in _BN_LEAVES:
        which, name = _BN_LEAVES[leaf]
        _set(trees[which], path + (name,), _np(value))


def _resnet_entry(rest: str, value, trees, prefix: Tuple[str, ...]):
    m = re.match(r'^layers\.(\d+)\.(\d+)\.(.+)$', rest)
    if m:
        stage, block, leaf = m.groups()
        mod = prefix + (f'layer{stage}_{block}',)
        if leaf.startswith('downsample.0.'):
            _set(trees[0], mod + ('downsample_conv', 'kernel'), _hwio(value))
        elif leaf.startswith('downsample.1.'):
            _bn_entry(leaf.split('.')[-1], value, trees, mod + ('downsample_bn',))
        elif leaf.startswith('conv'):
            _set(trees[0], mod + (leaf.split('.')[0], 'kernel'), _hwio(value))
        elif leaf.startswith('bn'):
            _bn_entry(leaf.split('.')[-1], value, trees, mod + (leaf.split('.')[0],))
    elif rest == 'conv1.weight':
        _set(trees[0], prefix + ('conv1', 'kernel'), _hwio(value))
    elif rest.startswith('bn1.'):
        _bn_entry(rest.split('.')[-1], value, trees, prefix + ('bn1',))


_SWIN_BLOCK_LEAVES = {
    'norm1.weight': ('norm1', 'scale'), 'norm1.bias': ('norm1', 'bias'),
    'norm2.weight': ('norm2', 'scale'), 'norm2.bias': ('norm2', 'bias'),
    'attn.qkv.weight': ('attn', 'qkv', 'kernel'), 'attn.qkv.bias': ('attn', 'qkv', 'bias'),
    'attn.proj.weight': ('attn', 'proj', 'kernel'), 'attn.proj.bias': ('attn', 'proj', 'bias'),
    'attn.relative_position_bias_table': ('attn', 'rel_bias_table'),
    'mlp.fc1.weight': ('mlp', 'fc1', 'kernel'), 'mlp.fc1.bias': ('mlp', 'fc1', 'bias'),
    'mlp.fc2.weight': ('mlp', 'fc2', 'kernel'), 'mlp.fc2.bias': ('mlp', 'fc2', 'bias'),
}


def _swin_entry(rest: str, value, params: dict, prefix: Tuple[str, ...]):
    """Linear weights [out, in] -> Dense kernels [in, out], LayerNorm
    weight -> scale; derived buffers (relative_position_index, attn_mask)
    are dropped."""
    v = _np(value)
    if rest.startswith('patch_embed.proj.'):
        leaf = 'kernel' if rest.endswith('weight') else 'bias'
        _set(params, prefix + ('patch_embed', leaf), _hwio(v) if leaf == 'kernel' else v)
        return
    if rest.startswith('patch_embed.norm.'):
        _set(params, prefix + ('patch_norm', 'scale' if rest.endswith('weight') else 'bias'), v)
        return
    m = re.match(r'^layers\.(\d+)\.blocks\.(\d+)\.(.+)$', rest)
    if m:
        stage, block, leaf = m.groups()
        if leaf in _SWIN_BLOCK_LEAVES:
            path = _SWIN_BLOCK_LEAVES[leaf]
            if path[-1] == 'kernel':
                v = np.ascontiguousarray(v.T)
            _set(params, prefix + (f'stage{stage}', f'block{block}') + path, v)
        return
    m = re.match(r'^layers\.(\d+)\.downsample\.(.+)$', rest)
    if m:
        mod = prefix + (f'stage{m.group(1)}', 'downsample')
        leaf = m.group(2)
        if leaf == 'reduction.weight':
            _set(params, mod + ('reduction', 'kernel'), np.ascontiguousarray(v.T))
        elif leaf in ('norm.weight', 'norm.bias'):
            _set(params, mod + ('norm', 'scale' if leaf.endswith('weight') else 'bias'), v)
        return
    m = re.match(r'^norm(\d)\.(weight|bias)$', rest)
    if m:
        _set(params, prefix + (f'out_norm{m.group(1)}',
                               'scale' if m.group(2) == 'weight' else 'bias'), v)


def to_jax_variables(state_dict: Dict[str, torch.Tensor]) -> dict:
    """A reference-format state_dict -> {'params': ..., 'batch_stats': ...}
    of the JAX Yolact as nested dicts of float32 numpy arrays: conv weights
    OIHW -> HWIO, BatchNorm into scale/bias and mean/var, the Sequential
    indices of FPN / proto / head to their named modules. swin has no
    BatchNorm, so its result has no 'batch_stats'."""
    params: dict = {}
    stats: dict = {}
    is_swin = any('.blocks.' in k for k in state_dict)
    sections = {'fpn': {v: k for k, v in _FPN_MAP.items()},
                'proto_net': {v: k for k, v in _PROTO_MAP.items()},
                'prediction_layers': {v: k for k, v in _HEAD_MAP.items()}}
    for key, value in state_dict.items():
        section, _, rest = key.partition('.')
        if section == 'backbone':
            if is_swin:
                _swin_entry(rest, value, params, ('backbone',))
            else:
                _resnet_entry(rest, value, (params, stats), ('backbone',))
        elif section in sections:
            mod, _, leaf = rest.rpartition('.')
            if mod in sections[section] and leaf in ('weight', 'bias'):
                _set(params, (section, sections[section][mod],
                              'kernel' if leaf == 'weight' else 'bias'),
                     _hwio(value) if leaf == 'weight' else _np(value))
    out = {'params': params}
    if stats:
        out['batch_stats'] = stats
    return out


def load_pth(path: str) -> Dict[str, torch.Tensor]:
    """A reference-format `.pth` state_dict (unwrapping a {'model': ...} or
    {'state_dict': ...} container), without the train-only semantic head and
    without the `relative_position_index` / `attn_mask` buffers that
    published swin checkpoints carry (the port derives both). A `.ckpt` is
    refused: `checkpoint.load_weights_auto` reads both formats."""
    if path.endswith('.ckpt'):
        raise ValueError(f'{path} is a .ckpt (flax msgpack): read it with '
                         'yolact_minimal_torch.utils.checkpoint.load_weights_auto')
    sd = torch.load(path, map_location='cpu', weights_only=True)
    for wrapper in ('model', 'state_dict'):
        if isinstance(sd.get(wrapper), dict):
            sd = sd[wrapper]
            break
    return {k: v for k, v in sd.items()
            if not k.startswith('semantic_seg_conv.')
            and not k.endswith(('.relative_position_index', '.attn_mask'))}
