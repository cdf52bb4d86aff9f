"""The pretrained-backbone init of training (the train CLI's --backbone_weight)
against the JAX package's, on the CPU: seeded backbone `.pth` files in the
reference's names, in torchvision's (`layer1..4`) and a swin one laid out as
published checkpoints are (no FPN-facing norms; the final `norm`, the
classifier `head` and the `relative_position_index` / `attn_mask` buffers
extra). The port's graft equals the JAX `graft_backbone` on the same init
(carried by `to_jax_variables`), read back by `from_jax_variables`; the
errors raise where the JAX graft raises."""
import re

import numpy as np
import pytest
import torch

from yolact_minimal_tpu.utils import weights as jax_weights
from yolact_minimal_torch import train as port_train
from yolact_minimal_torch.config import get_config
from yolact_minimal_torch.train_state import create_train_state
from yolact_minimal_torch.utils.weights import (from_jax_variables, graft_backbone,
                                                load_backbone_pth, to_jax_variables)

torch.set_num_threads(1)

IMG = 64


def _init(name):
    cfg = get_config(name, mode='train', img_size=IMG, train_bs=2)
    return cfg, {k: v.clone() for k, v in create_train_state(cfg, 'cpu').model.state_dict().items()}


@pytest.fixture(scope='module')
def res50():
    return _init('res50_custom')


@pytest.fixture(scope='module')
def swin():
    return _init('swin_tiny_custom')


def _seeded_backbone(init, seed):
    """The backbone.* tensors of `init` redrawn from a seed, without the
    prefix, as a backbone .pth holds them."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in init.items():
        if k.startswith('backbone.'):
            out[k[len('backbone.'):]] = (torch.randn(v.shape, generator=g) if v.is_floating_point()
                                         else v.clone())
    return out


def _jax_graft(path, init, strict):
    """The JAX package's graft of the .pth at `path` onto `init`, as a port
    state_dict."""
    backbone = jax_weights.convert_backbone_state_dict(jax_weights.load_torch_checkpoint(path))
    variables = jax_weights.graft_backbone(to_jax_variables(init), backbone, strict)
    return from_jax_variables(variables)


def _hold(grafted, ref, init):
    """The port's grafted state_dict against the JAX graft on every key both
    carry (num_batches_tracked is the port's own), and against the init on
    the keys outside the backbone."""
    for k, v in grafted.items():
        if k.endswith('num_batches_tracked'):
            assert torch.equal(v, init[k]), k
            continue
        assert torch.equal(v, ref[k]), k
        if not k.startswith('backbone.'):
            assert torch.equal(v, init[k]), k


@pytest.mark.parametrize('naming', ['reference', 'torchvision'])
def test_res50_graft_equals_jax(res50, tmp_path, naming):
    cfg, init = res50
    sd = _seeded_backbone(init, 1)
    if naming == 'torchvision':
        sd = {re.sub(r'^layers\.(\d)\.', lambda m: f'layer{int(m.group(1)) + 1}.', k): v
              for k, v in sd.items()}
    sd.update({'fc.weight': torch.zeros(1000, 2048), 'fc.bias': torch.zeros(1000)})
    path = str(tmp_path / 'backbone_res50.pth')
    torch.save({'state_dict': sd}, path)
    state = create_train_state(cfg, 'cpu', backbone=load_backbone_pth(path))
    grafted = state.model.state_dict()
    _hold(grafted, _jax_graft(path, init, strict=True), init)
    assert torch.equal(grafted['backbone.layers.3.2.conv3.weight'],
                       sd['layers.3.2.conv3.weight' if naming == 'reference'
                          else 'layer4.2.conv3.weight'])


def test_swin_graft_equals_jax(swin, tmp_path):
    cfg, init = swin
    sd = {k: v for k, v in _seeded_backbone(init, 2).items() if not re.match(r'norm\d\.', k)}
    sd.update({'norm.weight': torch.ones(768), 'norm.bias': torch.zeros(768),
               'head.weight': torch.zeros(1000, 768), 'head.bias': torch.zeros(1000),
               'layers.0.blocks.1.attn_mask': torch.zeros(4, 49, 49),
               'layers.0.blocks.0.attn.relative_position_index': torch.zeros(49, 49,
                                                                           dtype=torch.long)})
    path = str(tmp_path / 'swin_tiny.pth')
    torch.save({'model': sd}, path)
    backbone = load_backbone_pth(path)
    assert not any(k.startswith(('backbone.norm.', 'backbone.head.')) for k in backbone)
    state = create_train_state(cfg, 'cpu', backbone=backbone)
    grafted = state.model.state_dict()
    _hold(grafted, _jax_graft(path, init, strict=False), init)
    for i in (1, 2, 3):          # not in the file: left at the init
        assert torch.equal(grafted[f'backbone.norm{i}.weight'], init[f'backbone.norm{i}.weight'])
    assert torch.equal(grafted['backbone.layers.2.blocks.5.mlp.fc1.weight'],
                       sd['layers.2.blocks.5.mlp.fc1.weight'])


@pytest.mark.parametrize('fault,error', [
    ('missing', ValueError), ('unknown', KeyError), ('shape', ValueError)])
def test_graft_errors_raise_where_jax_raises(res50, swin, tmp_path, fault, error):
    for (cfg, init), strict in ((res50, True), (swin, False)):
        sd = _seeded_backbone(init, 3)
        if fault == 'missing':
            if not strict:
                continue             # a lenient swin load takes a partial file
            del sd['layers.1.0.bn2.running_var']
        elif fault == 'unknown':
            if strict:
                sd['layers.4.0.conv1.weight'] = torch.zeros(64, 64, 1, 1)
            else:
                sd['layers.0.blocks.2.norm1.weight'] = torch.zeros(96)
        else:
            key = 'conv1.weight' if strict else 'patch_embed.proj.weight'
            sd[key] = sd[key][:, :1]
        path = str(tmp_path / f'{fault}_{cfg.name}.pth')
        torch.save(sd, path)
        with pytest.raises(error):
            _jax_graft(path, init, strict)
        with pytest.raises(error):
            graft_backbone(init, load_backbone_pth(path), strict)


class _Stop(Exception):
    pass


def test_train_cli_reads_the_backbone_as_jax_does(res50, tmp_path, monkeypatch, capsys):
    cfg, init = res50
    monkeypatch.chdir(tmp_path)
    base = ['--cfg', 'res50_custom', '--img_size', str(IMG), '--device', 'cpu']
    with pytest.raises(FileNotFoundError, match='--backbone_weight'):
        port_train.main(base + ['--backbone_weight', 'missing.pth'])
    seen = []

    def stop(cfg, device, state_dict=None, step=0, backbone=None):
        seen.append(backbone)
        raise _Stop
    monkeypatch.setattr(port_train, 'create_train_state', stop)
    with pytest.raises(_Stop):                          # no file at the config's path
        port_train.main(base)
    assert seen[-1] is None
    assert "No pretrained backbone at 'weights/backbone_res50.pth'" in capsys.readouterr().out
    (tmp_path / 'weights').mkdir()
    torch.save(_seeded_backbone(init, 4), tmp_path / 'weights' / 'backbone_res50.pth')
    with pytest.raises(_Stop):                          # the config's path, where it exists
        port_train.main(base)
    assert 'Backbone is initiated with weights/backbone_res50.pth.' in capsys.readouterr().out
    assert len(seen[-1]) == len([k for k in init if k.startswith('backbone.')
                                 and not k.endswith('num_batches_tracked')])
    assert np.isfinite(seen[-1]['backbone.conv1.weight'].numpy()).all()
