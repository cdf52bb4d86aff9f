"""The port's data tools against the JAX package's, on the CPU: the synthetic
generator writes the repository's custom_dataset/ byte for byte, the
labelme and Pascal-SBD converters write the JAX converters' jsons, and each
`python -m yolact_minimal_torch.tools.<name>` writes the files its twin
under tools/ writes."""
import filecmp
import json
import os
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import scipy.io

from yolact_minimal_tpu.data import converters as jax_converters
from yolact_minimal_torch.data import converters
from yolact_minimal_torch.data.synthetic import generate_dataset

ROOT = Path(__file__).resolve().parents[1]
CLI_TIMEOUT = 300


def _files(folder: Path, pattern: str):
    return sorted(p.relative_to(folder) for p in folder.glob(pattern) if p.is_file())


def _same_tree(ours: Path, ref: Path, pattern: str = '**/*'):
    """The files under `ref` that match `pattern`, byte for byte."""
    assert _files(ours, pattern) == _files(ref, pattern) and _files(ref, pattern)
    for rel in _files(ref, pattern):
        assert filecmp.cmp(ours / rel, ref / rel, shallow=False), rel


def test_generator_writes_the_repository_dataset(tmp_path):
    img_dir, ann = generate_dataset(str(tmp_path), num_images=48, img_size=448, seed=0)
    assert Path(img_dir) == tmp_path / 'images'
    assert Path(ann).read_bytes() == (ROOT / 'custom_dataset' / 'annotations.json').read_bytes()
    _same_tree(tmp_path / 'images', ROOT / 'custom_dataset' / 'images', '*.jpg')


def _labelme_folder(folder: Path):
    """One labelme json with a polygon, a rectangle and a circle (and a
    json without shapes, which is skipped) and its labels.txt."""
    folder.mkdir()
    shapes = [dict(label='cat', shape_type='polygon',
                   points=[[10.2, 5.0], [40.7, 8.4], [30.0, 35.5], [8.0, 30.0]]),
              dict(label='dog', shape_type='rectangle', points=[[45.0, 12.5], [70.4, 40.0]]),
              dict(label='cat', shape_type='circle', points=[[20.0, 50.0], [27.5, 53.0]])]
    (folder / 'a.json').write_text(json.dumps(
        dict(imageHeight=64, imageWidth=80, shapes=shapes)))
    (folder / 'b.json').write_text(json.dumps(dict(imageHeight=64, imageWidth=80)))
    labels = folder / 'labels.txt'
    labels.write_text('background\ncat\ndog\n')
    return labels


def test_labelme_to_coco_equals_jax(tmp_path):
    outs = []
    for side, fn in (('ours', converters.labelme_to_coco),
                     ('ref', jax_converters.labelme_to_coco)):
        labels = _labelme_folder(tmp_path / side)
        outs.append(json.loads(Path(fn(str(tmp_path / side), str(labels))).read_text()))
    assert outs[0] == outs[1]
    assert len(outs[0]['annotations']) == 3 and all(a['area'] > 0 for a in outs[0]['annotations'])


def _pascal_folder(folder: Path):
    """img/, inst/ (GTinst .mat files written with scipy.io.savemat) and the
    split lists of two images."""
    for sub in ('img', 'inst'):
        (folder / sub).mkdir(parents=True)
    rng = np.random.RandomState(0)
    for i, name in enumerate(('2008_000001', '2008_000002')):
        seg = np.zeros((40 + i, 50), np.uint8)
        seg[5:15, 5:20] = 1
        seg[20:35, 10 + i:45] = 2
        gt = np.zeros((1, 1), dtype=[('Segmentation', 'O'), ('Boundaries', 'O'),
                                     ('Categories', 'O')])
        gt[0, 0] = (seg, np.zeros((0, 0)), np.array([[3 + i], [15]], np.uint8))
        scipy.io.savemat(folder / 'inst' / f'{name}.mat', {'GTinst': gt})
        cv2.imwrite(str(folder / 'img' / f'{name}.jpg'),
                    rng.randint(0, 255, (40 + i, 50, 3)).astype(np.uint8))
    (folder / 'train.txt').write_text('2008_000001\n')
    (folder / 'val.txt').write_text('2008_000002\n')


def test_pascal_sbd_to_coco_equals_jax(tmp_path):
    outs = []
    for side, fn in (('ours', converters.pascal_sbd_to_coco),
                     ('ref', jax_converters.pascal_sbd_to_coco)):
        _pascal_folder(tmp_path / side)
        outs.append([json.loads(Path(p).read_text()) for p in fn(str(tmp_path / side))])
    assert outs[0] == outs[1]
    assert [len(o['annotations']) for o in outs[0]] == [2, 2]


def _run(cmd, cwd):
    proc = subprocess.run([sys.executable, *cmd], cwd=cwd, capture_output=True, text=True,
                          timeout=CLI_TIMEOUT, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]


def _cli_case(name, folder: Path):
    """(arguments, the folder the tool writes into, a pattern of the files
    it writes) for one tool, its inputs made under `folder`."""
    folder.mkdir()
    if name == 'labelme2coco':
        labels = _labelme_folder(folder / 'data')
        return (['--img_dir', str(folder / 'data'), '--label_name', str(labels)],
                folder / 'data', 'custom_ann.json')
    if name == 'pascal2coco':
        _pascal_folder(folder / 'sbd')
        return ['--folder_path', str(folder / 'sbd')], folder / 'sbd', 'pascal_sbd_*.json'
    if name == 'make_custom_dataset':
        return (['--root', str(folder / 'out'), '--num_images', '3', '--img_size', '160'],
                folder / 'out', '**/*')
    data = ROOT / 'custom_dataset'
    return (['--img_dir', str(data / 'images'), '--ann', str(data / 'annotations.json'),
             '--out_dir', str(folder / 'out'), '--limit', '3'], folder / 'out', '*.jpg')


@pytest.mark.parametrize('name', ['labelme2coco', 'pascal2coco', 'make_custom_dataset',
                                  'view_annotations'])
def test_tool_cli_writes_what_the_jax_tool_writes(tmp_path, name):
    args, ours, pattern = _cli_case(name, tmp_path / 'ours')
    _run(['-m', f'yolact_minimal_torch.tools.{name}', *args], tmp_path)
    args, ref, _ = _cli_case(name, tmp_path / 'ref')
    _run([str(ROOT / 'tools' / f'{name}.py'), *args], tmp_path)
    _same_tree(ours, ref, pattern)
