"""The comparison that decides `correct`, shown to fail: the control (the
reference in the next lower precision, in the program's place) and each
fault a cell can have, planted under a run's timed path, at a size the CPU
runs. The chip's readings at the cells' own sizes are in PERF.md."""
import json
import subprocess
import sys
import time

import pytest
import torch

from _util import ROOT, small_cell

from benchmark import calibrate, faults
from benchmark.core import judge
from benchmark.core.run import run_cell

CPU = torch.device('cpu')
SIZES = {'res50_coco.detect_b16': 64, 'swin_tiny_coco.detect_b16': 64,
         'swin_tiny_coco.train_b64': 128, 'res50_coco.train_b64': 128}


def _run(name, seed=2 ** 31 + 17):
    cell = small_cell(name, img_size=SIZES[name])
    result, lines = run_cell(cell, seed, 2.0, False, CPU, (time.perf_counter(), 0.0))
    assert len(lines) == 1 + len(cell.limits["checks"])
    return result


@pytest.mark.parametrize('name', ['res50_coco.detect_b16', 'swin_tiny_coco.train_b64'])
def test_a_sound_run_is_correct(name):
    result = _run(name)
    assert result['correct'], result['checks']
    assert list(result)[-1] == 'checks'


@pytest.mark.parametrize('name,fault', [
    ('res50_coco.detect_b16', 'half_batch'), ('res50_coco.detect_b16', 'altered_answer'),
    ('swin_tiny_coco.detect_b16', 'half_batch'), ('swin_tiny_coco.detect_b16', 'altered_answer'),
    ('swin_tiny_coco.train_b64', 'half_batch'), ('swin_tiny_coco.train_b64', 'unchanged_state'),
    ('res50_coco.train_b64', 'half_batch'), ('res50_coco.train_b64', 'unchanged_state')])
def test_a_planted_fault_makes_the_run_incorrect(name, fault):
    entry = small_cell(name).traffic['entry']
    with faults.FAULTS[fault](entry):
        result = _run(name)
    assert not result['correct'], result['checks']


@pytest.mark.parametrize('name', list(SIZES))
def test_the_control_fails_the_cells_limits(name):
    cell = small_cell(name, img_size=SIZES[name])
    control = calibrate.control_detect if cell.traffic['entry'] == 'detect' \
        else calibrate.control_train
    values = control(cell, 2 ** 32 + 3, CPU)
    checks = judge.checks(values, cell.limits['checks'])
    assert not all(c.ok for c in checks), values


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card: run on the card with '
                    'python -m pytest benchmark/tests -m cuda')
    return torch.device('cuda', 0)


@pytest.mark.cuda
@pytest.mark.parametrize('trace', (0, 1))
def test_a_cell_runs_on_the_card(card, trace):
    out = subprocess.run([sys.executable, 'benchmark/run.py', '--workload',
                          'res50_coco.detect_b16', '--seed', str(2 ** 31 + 21), '--seconds', '2',
                          '--trace', str(trace)], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result['correct'] and result['device']['platform'] == 'gpu'
