"""The port's detect CLI without cv2: `val_aug` against the JAX package's cv2
`val_aug` (equal with cv2, its F.interpolate fallback without), the numpy
blend and rectangles of `draw_img` against cv2's, the cv2 and PIL image
paths, `detect.main` on the CPU with cv2, then cv2 and PIL, hidden, and its
`--cutout` files against those of the JAX `draw_img`."""
import sys

import cv2
import numpy as np
import pytest
import torch

from yolact_minimal_tpu.data.augment import val_aug as jax_val_aug
from yolact_minimal_torch.config import get_config
from yolact_minimal_torch.data.augment import val_aug
from yolact_minimal_torch.utils import image_io, visualize

torch.set_num_threads(1)

# Normalized units ((pixel - mean) / std, std ~58), for the fallback without
# cv2: cv2 and F.interpolate place the same half-pixel samples but round their
# weights differently in float32, up to ~3e-4 at 544 (~0.02 of a pixel level).
VAL_AUG_ATOL = 1e-3


def _hide(monkeypatch, *names):
    """The named top-level modules do not import from here on."""
    for name in [m for m in sys.modules if m.split('.')[0] in names]:
        monkeypatch.delitem(sys.modules, name)
    for name in names:
        monkeypatch.setitem(sys.modules, name, None)
    image_io.backend.cache_clear()


@pytest.fixture(autouse=True)
def _fresh_backend():
    image_io.backend.cache_clear()
    yield
    image_io.backend.cache_clear()


@pytest.mark.parametrize('h,w,size', [(480, 640, 544), (700, 900, 544), (100, 60, 544),
                                      (544, 544, 544), (37, 53, 128), (1000, 300, 256)])
def test_val_aug_matches_jax_cv2(h, w, size, monkeypatch):
    rng = np.random.RandomState(h + w)
    imgs = (rng.randint(0, 256, (h, w, 3)).astype(np.uint8),
            (rng.rand(h, w, 3) * 255).astype(np.float32))
    refs = [jax_val_aug(img, size) for img in imgs]
    for img, ref in zip(imgs, refs):        # with cv2: the reference's own resize
        ours = val_aug(img, size)
        assert ours.shape == ref.shape == (size, size, 3) and ours.dtype == np.float32
        np.testing.assert_array_equal(ours, ref)
    _hide(monkeypatch, 'cv2')
    for img, ref in zip(imgs, refs):        # without cv2: F.interpolate
        ours = val_aug(img, size)
        assert ours.shape == ref.shape and ours.dtype == np.float32
        np.testing.assert_allclose(ours, ref, rtol=0, atol=VAL_AUG_ATOL)


def test_blend_equals_cv2_add_weighted_on_every_pair():
    a, b = np.meshgrid(np.arange(256, dtype=np.uint8), np.arange(256, dtype=np.uint8))
    for width in (256, 13):         # cv2's vector loop and its scalar tail
        x = np.resize(np.stack([a, b, a], -1), (256, width, 3)).astype(np.uint8)
        y = np.resize(np.stack([b, a, b], -1), (256, width, 3)).astype(np.uint8)
        assert np.array_equal(visualize.blend(x, y, 0.4, 0.6),
                              cv2.addWeighted(x, 0.4, y, 0.6, gamma=0))


def test_rectangle_equals_cv2_rectangle():
    rng = np.random.RandomState(0)
    for _ in range(500):
        h, w = rng.randint(1, 40, size=2)
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        ours = img.copy()
        p1, p2 = (tuple(int(v) for v in rng.randint(-10, 50, 2)) for _ in range(2))
        filled = bool(rng.rand() < 0.5)
        cv2.rectangle(img, p1, p2, (10, 20, 30), -1 if filled else 1)
        visualize.rectangle(ours, p1, p2, (10, 20, 30), filled)
        assert np.array_equal(img, ours), (h, w, p1, p2, filled)


def _weights(tmp_path):
    """A seeded res50_coco state_dict whose class head favours class 1 (the
    bias of its logit +6 at every anchor), so that detections pass the
    thresholds and the drawing has work."""
    from yolact_minimal_torch.pipeline import Detector
    det = Detector(get_config('res50_coco', img_size=64), device='cpu', seed=0)
    sd = det.model.state_dict()
    sd['prediction_layers.conf_layer.bias'][1::81] += 6.0
    path = tmp_path / 'seeded_res50_coco.pth'
    torch.save(sd, path)
    return path


def test_detect_cli_runs_without_cv2_or_pil(tmp_path, monkeypatch, capsys):
    """Without cv2 the CLI reads, draws and writes through PIL; without cv2
    and PIL it stops before the detector is built."""
    from yolact_minimal_torch.detect import main
    images = tmp_path / 'images'
    images.mkdir()
    img = np.random.RandomState(0).randint(0, 256, (40, 56, 3)).astype(np.uint8)
    image_io.imwrite(images / 'one.png', img)
    weight = _weights(tmp_path)
    monkeypatch.chdir(tmp_path)
    _hide(monkeypatch, 'cv2')
    assert image_io.backend() == 'PIL'
    main(['--weight', str(weight), '--image', str(images), '--device', 'cpu',
          '--img_size', '64', '--visual_thre', '0'])
    assert 'image library: PIL' in capsys.readouterr().out
    out = image_io.imread(tmp_path / 'results' / 'images' / 'one.png')
    assert out.shape == img.shape and not np.array_equal(out, img)    # masks were drawn

    # the weight does not exist, so only a check made before the build can stop it
    _hide(monkeypatch, 'PIL')
    with pytest.raises(SystemExit, match='neither cv2 nor PIL imports'):
        main(['--weight', 'missing_res50_coco.pth', '--image', str(images), '--device', 'cpu'])


class _Cv2SkipsEmpty:
    """cv2 as the JAX `draw_img` sees it, except that an empty image is not
    written: cv2.imwrite raises on one, so the JAX `draw_img` stops at the
    first detection whose box crops to nothing, where the port writes no
    file for it and goes on."""

    def __getattr__(self, name):
        return getattr(cv2, name)

    @staticmethod
    def imwrite(path, img):
        return img.size == 0 or cv2.imwrite(path, img)


def test_detect_cli_cutout_writes_the_files_jax_draw_img_names(tmp_path, monkeypatch):
    """--cutout writes `<basename>_total_obj.jpg` and `<basename>_<i>.jpg`
    under results/images/: the files, names and pixels that the JAX package's
    `draw_img` writes for the same detections, and none for a box that lies
    outside the image (the image is 60 high, the boxes span the padded 80)."""
    from yolact_minimal_tpu.utils import visualize as jax_visualize
    from yolact_minimal_torch import detect
    images = tmp_path / 'images'
    images.mkdir()
    img = np.random.RandomState(2).randint(0, 256, (60, 80, 3)).astype(np.uint8)
    image_io.imwrite(images / 'one.png', img)
    weight = _weights(tmp_path)
    jax_dir = tmp_path / 'jax'
    drawn = []

    def draw_both(ids, scores, boxes, masks, img_origin, cfg, img_name=None):
        h, w = img_origin.shape[:2]
        b = np.clip(np.asarray(boxes).astype(int), 0, [w, h, w, h])
        drawn.append((img_name, [i for i in range(len(ids))
                                 if b[i, 2] > b[i, 0] and b[i, 3] > b[i, 1]], len(ids)))
        jax_visualize.draw_img(ids, scores, boxes, masks, img_origin.copy(), cfg,
                               img_name=img_name, out_dir=str(jax_dir))
        return visualize.draw_img(ids, scores, boxes, masks, img_origin, cfg,
                                  img_name=img_name)
    monkeypatch.setattr(detect, 'draw_img', draw_both)
    monkeypatch.setattr(jax_visualize, 'cv2', _Cv2SkipsEmpty())
    monkeypatch.chdir(tmp_path)
    detect.main(['--weight', str(weight), '--image', str(images), '--device', 'cpu',
                 '--img_size', '64', '--visual_thre', '0', '--cutout'])
    [(name, nonempty, n)] = drawn
    assert name == 'one.png' and 0 < len(nonempty) < n     # some boxes crop to nothing
    out_dir = tmp_path / 'results' / 'images'
    cutouts = {'one.png_total_obj.jpg'} | {f'one.png_{i}.jpg' for i in nonempty}
    assert {p.name for p in out_dir.iterdir()} == cutouts | {'one.png'}
    assert {p.name for p in jax_dir.iterdir()} == cutouts
    for file in cutouts:
        assert np.array_equal(image_io.imread(out_dir / file), cv2.imread(str(jax_dir / file)))


def test_image_io_backends_agree(tmp_path, monkeypatch):
    img = np.random.RandomState(1).randint(0, 256, (30, 20, 3)).astype(np.uint8)
    path = tmp_path / 'x.png'
    image_io.imwrite(path, img)
    assert image_io.backend() == 'cv2'
    assert np.array_equal(image_io.imread(path), img)
    _hide(monkeypatch, 'cv2')
    assert image_io.backend() == 'PIL'
    assert np.array_equal(image_io.imread(path), img)
    image_io.imwrite(path, img[::-1])
    assert np.array_equal(cv2.imread(str(path)), img[::-1])
    with pytest.raises(ValueError, match='cannot read'):
        image_io.imread(tmp_path / 'missing.png')
    _hide(monkeypatch, 'PIL')
    for call in (image_io.backend, lambda: image_io.imread(path)):
        with pytest.raises(ImportError, match='neither cv2 nor PIL imports'):
            call()
