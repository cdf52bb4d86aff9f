"""The port stands alone: it imports no JAX, no flax, no msgpack, nothing of
the JAX package and no cv2 or scipy at import time, and its entry points run on the card
unless the caller asks for the CPU."""
import ctypes
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from yolact_minimal_torch.config import get_config

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT_MODULES = sorted(
    '.'.join(p.relative_to(ROOT).with_suffix('').parts).removesuffix('.__init__')
    for p in (ROOT / 'yolact_minimal_torch').rglob('*.py'))


def test_port_imports_no_jax():
    for module in ('ops.mask_finalize', 'ops.window_attention', 'ops.swin_mlp',
                   'ops.attn_block', 'ops.swin_block', 'models.swin', 'eval',
                   'utils.msgpack', 'utils.checkpoint', 'data.coco', 'utils.cocoeval',
                   'train', 'train_state', 'ops.losses', 'ops.matching', 'data.augment',
                   'ops.nms_numpy', 'deploy', 'export', 'detect_with_export',
                   'ops.traditional_nms', 'models.remat', 'parallel.mesh',
                   'data.converters', 'data.synthetic', 'tools.labelme2coco',
                   'tools.pascal2coco', 'tools.make_custom_dataset',
                   'tools.view_annotations'):
        assert f'yolact_minimal_torch.{module}' in PORT_MODULES
    code = (
        'import sys\n'
        f'for m in {PORT_MODULES!r}: __import__(m)\n'
        'bad = sorted(k for k in sys.modules if k.split(".")[0] in '
        '("jax", "jaxlib", "flax", "msgpack", "yolact_minimal_tpu", "cv2", "scipy"))\n'
        'print(len(sys.modules)); assert not bad, bad\n')
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_host_nms_library_builds_at_first_use_under_build_never_native():
    """Importing ops.traditional_nms builds and loads nothing (and no cv2);
    the first call loads the library g++ wrote under build/torch_host/."""
    code = (
        'import sys\n'
        'from yolact_minimal_torch.ops import _build, traditional_nms as t\n'
        'assert not _build._loaded and "cv2" not in sys.modules\n'
        'import numpy as np\n'
        'b = np.array([[0, 0, 9, 9], [1, 1, 9, 9], [20, 20, 30, 30]], np.float32)\n'
        'assert t.greedy_nms(b, np.array([0.9, 0.8, 0.7], np.float32), 0.5).tolist() == [0, 2]\n'
        'print(_build._loaded["nms.cc"]._name)\n')
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lib = Path(proc.stdout.strip())
    assert lib.parent == ROOT / 'build' / 'torch_host' and lib.suffix == '.so'
    assert (ROOT / 'native') not in lib.parents


def test_chip_smoke_imports_no_jax():
    src = (ROOT / 'chip_smoke.py').read_text()
    for name in ('jax', 'flax', 'msgpack', 'yolact_minimal_tpu', 'cv2'):
        assert f'import {name}' not in src and f'from {name}' not in src


def test_detector_without_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip('this machine has a card: the default device is usable')
    from yolact_minimal_torch.pipeline import Detector, load_detector
    cfg = get_config('res50_coco', img_size=64)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        Detector(cfg)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        Detector(get_config('swin_tiny_coco', img_size=64))
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        load_detector('latest_res50_coco_1.pth')
    from yolact_minimal_torch.detect import main
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        main(['--weight', 'missing_res50_coco.pth', '--image', str(ROOT)])


def test_kernels_raise_on_a_device_they_do_not_take():
    from yolact_minimal_torch.ops.suppression import suppression_iou_max
    x = torch.zeros(2, 8, device='meta')
    with pytest.raises(ValueError, match='unsupported device'):
        suppression_iou_max(x, x, x, x, torch.zeros(2, 8, dtype=torch.bool, device='meta'))


def test_every_kernel_source_names_what_it_replaces():
    sources = sorted((ROOT / 'yolact_minimal_torch' / 'csrc').glob('*.cu'))
    assert [p.stem for p in sources] == ['attn_block', 'mask_finalize', 'suppression',
                                         'swin_block', 'swin_glue', 'swin_mlp',
                                         'window_attention']
    for path in sources:
        text = path.read_text()
        # the glue kernels replace no TPU kernel: XLA fuses that work there
        assert ('Replaces the Pallas TPU kernel yolact_minimal_tpu/ops/' in text or
                'Replaces no TPU kernel: the JAX package leaves' in text), path.name
        assert 'extern "C" int ' + path.stem in text, path.name
        assert 'cudaGetLastError' in text, path.name
        wrapper = (ROOT / 'yolact_minimal_torch' / 'ops' / f'{path.stem}.py').read_text()
        assert f"_build.load('{path.stem}')" in wrapper and '.launches += 1' in wrapper


def test_every_kernel_entry_point_has_one_declared_signature():
    """ops/_build.py declares exactly the extern "C" entry points of csrc/,
    each with its C signature's arguments, kind for kind: ctypes passes the
    widths a list states, so a wrong list would fail silently."""
    from yolact_minimal_torch.ops import _build
    csrc = ROOT / 'yolact_minimal_torch' / 'csrc'
    in_c = {}
    for path in sorted(csrc.glob('*.cu')) + [csrc / 'nms.cc']:
        text = path.read_text()
        pattern = r'extern "C" int (\w+)\(([^)]*)\)'
        if path.suffix == '.cc':                # one extern "C" { ... } block
            text, pattern = text[text.index('extern "C" {'):], r'^int (\w+)\(([^)]*)\)'
        for name, params in re.findall(pattern, text, re.M):
            kinds = []
            for param in params.split(','):
                param = ' '.join(param.replace('const ', '').split())
                kinds.append('pointer' if '*' in param else param.rsplit(' ', 1)[0])
            assert name not in in_c, name
            in_c[name] = (path.name, kinds)
    assert len(in_c) == 20 and in_c['greedy_nms'][0] == 'nms.cc'
    kind = {ctypes.c_void_p: 'pointer', ctypes.c_int: 'int', ctypes.c_float: 'float'}
    declared = {name: (source, [kind[t] for t in argtypes])
                for source, entries in _build.SIGNATURES.items()
                for name, argtypes in entries.items()}
    assert declared == in_c


def test_kernel_build_names_libraries_by_source_and_needs_nvcc(tmp_path, monkeypatch):
    from yolact_minimal_torch.ops import _build
    monkeypatch.setattr(_build, 'CSRC', tmp_path)
    monkeypatch.setattr(_build, 'BUILD_DIR', tmp_path / 'build')
    (tmp_path / 'k.cu').write_text('// one\n')
    first = _build._target('k')
    (tmp_path / 'k.cu').write_text('// two\n')
    second = _build._target('k')
    assert second != first                         # an edited source rebuilds
    assert first.parent == tmp_path / 'build'
    (tmp_path / 'shared.cuh').write_text('// a header\n')
    third = _build._target('k')
    assert third != second                         # and so does a new or edited header
    (tmp_path / 'shared.cuh').write_text('// a header, edited\n')
    assert _build._target('k') not in (second, third)
    monkeypatch.setattr(_build.shutil, 'which', lambda name: None)
    monkeypatch.setattr(_build.os.path, 'exists', lambda path: False)
    with pytest.raises(RuntimeError, match='nvcc not found'):
        _build.build(['k'])
