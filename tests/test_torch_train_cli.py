"""`python -m yolact_minimal_torch.train` on the CPU: a few steps at 64 px
on custom_dataset/ with one in-training validation, a `latest_*.ckpt` that
the JAX package reads and resumes from (optimizer state and step), a
resume of the port from it, and the card default refusing to start
without a card."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from yolact_minimal_tpu import train_state as JT
from yolact_minimal_tpu.config import get_config as jax_get_config
from yolact_minimal_tpu.utils.checkpoint import load_weights_auto as jax_load_weights_auto

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
DATA = ['--train_imgs', str(ROOT / 'custom_dataset/images'),
        '--train_ann', str(ROOT / 'custom_dataset/annotations.json'),
        '--val_imgs', str(ROOT / 'custom_dataset/images'),
        '--val_ann', str(ROOT / 'custom_dataset/annotations.json')]


def _train(cwd, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS='2')
    cmd = [sys.executable, '-m', 'yolact_minimal_torch.train', '--cfg', 'res50_custom',
           '--img_size', '64', '--train_bs', '2', '--num_workers', '1', '--device', 'cpu',
           *DATA, *args]
    proc = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def test_train_cli_writes_a_checkpoint_jax_resumes_and_resumes_from_it(tmp_path):
    out = _train(tmp_path, '--max_steps', '3', '--val_interval', '2', '--val_num', '2')
    assert 'Training completed.' in out
    assert 'box ' in out.lower() or 'mask' in out.lower()          # the validation table
    weights = tmp_path / 'weights'
    latest = sorted(weights.glob('latest_res50_custom_*.ckpt'))
    assert [p.name for p in latest] == ['latest_res50_custom_3.ckpt']
    assert len(list(weights.glob('best_*_res50_custom_2.ckpt'))) == 1

    # the JAX package reads it, and resumes its optimizer from it
    variables = jax_load_weights_auto(str(latest[0]), include_semantic=True)
    assert int(variables.pop('step')) == 3 and 'semantic_seg_conv' in variables['params']
    payload = variables.pop('opt_state')
    jcfg = jax_get_config('res50_custom', mode='train', img_size=64, train_bs=2)
    state = JT.restore_opt_state(JT.create_train_state(jcfg, jax.random.PRNGKey(0),
                                                       variables=variables, step=3), payload)
    assert int(state.opt_state[1][1].count) == 3
    trace = jax.tree.leaves(state.opt_state[1][0].trace)
    assert any(float(np.abs(np.asarray(t)).max()) > 0 for t in trace)   # momentum was kept

    # and the port resumes from it where it stopped
    out = _train(tmp_path, '--max_steps', '2', '--resume', str(latest[0]))
    assert 'Optimizer state (momentum/moments + schedule) restored.' in out
    assert sorted(p.name for p in weights.glob('latest_*.ckpt')) == ['latest_res50_custom_5.ckpt']


def test_train_cli_needs_a_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip('this machine has a card: the default device is usable')
    from yolact_minimal_torch.train import main
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        main(['--cfg', 'res50_custom', '--img_size', '64', *DATA])
    with pytest.raises(AssertionError, match='not compatible'):
        main(['--cfg', 'res50_custom', '--device', 'cpu', '--resume',
              'latest_res50_coco_10.ckpt', *DATA])
