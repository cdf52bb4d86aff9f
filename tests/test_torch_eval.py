"""The port's eval path against the JAX package's, on the tracked
custom_dataset/: the COCO annotation IO, the val items, the mAP tables and
the COCO-protocol stats on the same detections, the eval loop on stub
detectors, and `evaluate` end to end on one seeded `.ckpt` through both
stacks."""
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eval as jax_eval
from yolact_minimal_tpu.config import get_config as jax_config
from yolact_minimal_tpu.data import coco_io as jax_coco_io
from yolact_minimal_tpu.data.coco import COCODetection as JaxCOCODetection
from yolact_minimal_tpu.models.yolact import Yolact as JaxYolact
from yolact_minimal_tpu.pipeline import Detector as JaxDetector
from yolact_minimal_tpu.utils import checkpoint as jax_ckpt
from yolact_minimal_tpu.utils import cocoeval as jax_cocoeval
from yolact_minimal_tpu.utils import map_eval as jax_map_eval
from yolact_minimal_torch import eval as port_eval
from yolact_minimal_torch.config import get_config
from yolact_minimal_torch.data import coco_io
from yolact_minimal_torch.data.coco import COCODetection
from yolact_minimal_torch.ops.nms import Detections
from yolact_minimal_torch.pipeline import Detector, load_detector
from yolact_minimal_torch.utils import cocoeval, image_io, map_eval

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
DATA = dict(val_imgs=str(ROOT / 'custom_dataset' / 'images'),
            val_ann=str(ROOT / 'custom_dataset' / 'annotations.json'))
# Slates of two forward passes (JAX and the port, float32 on the CPU):
# scores and boxes within 1e-6, masks after the upsample within a 1e-4
# mismatch fraction (pixels within rounding of 0.5 may flip: cv2.resize in
# the JAX package, F.interpolate in the port).
ATOL = 1e-6
MISMATCH = 1e-4


def _configs(img_size=256, **kw):
    kw = dict(mode='val', img_size=img_size, **DATA, **kw)
    return get_config('res50_custom', **kw), jax_config('res50_custom', **kw)


@pytest.fixture(scope='module')
def coco():
    return coco_io.COCO(DATA['val_ann']), jax_coco_io.COCO(DATA['val_ann'])


def test_ann_to_mask_and_rle_match_jax(coco):
    ours, ref = coco
    assert len(ours.anns) == 113 and ours.imgToAnns.keys() == ref.imgToAnns.keys()
    for ann_id, ann in ref.anns.items():
        m = ours.annToMask(ann)
        np.testing.assert_array_equal(m, ref.annToMask(ann))
        assert m.any()
        rle = coco_io.mask_to_rle(m)
        assert rle == jax_coco_io.mask_to_rle(m)
        np.testing.assert_array_equal(coco_io.rle_to_mask(rle), m)
        np.testing.assert_array_equal(jax_coco_io.rle_to_mask(rle), m)
        assert coco_io.rle_decode_counts(rle['counts']) == \
            jax_coco_io.rle_decode_counts(rle['counts'])
    rng = np.random.RandomState(0)
    for m in (np.zeros((5, 7), np.uint8), np.ones((5, 7), np.uint8),
              (rng.rand(33, 20) > 0.5).astype(np.uint8), np.zeros((0, 4), np.uint8)):
        rle = coco_io.mask_to_rle(m)
        assert rle == jax_coco_io.mask_to_rle(m)
        np.testing.assert_array_equal(coco_io.rle_to_mask(rle), m)
    # RLE segmentations (crowd regions) and bytes counts
    ann = dict(next(iter(ref.anns.values())))
    ann['segmentation'] = coco_io.mask_to_rle(ref.annToMask(ann))
    np.testing.assert_array_equal(ours.annToMask(ann), ref.annToMask(ann))
    ann['segmentation']['counts'] = ann['segmentation']['counts'].encode('ascii')
    np.testing.assert_array_equal(ours.annToMask(ann), ref.annToMask(ann))


def test_val_and_detect_items_match_jax():
    cfg, jcfg = _configs()
    ours, ref = COCODetection(cfg, mode='val'), JaxCOCODetection(jcfg, mode='val')
    assert len(ours) == len(ref) == 48 and ours.ids == ref.ids
    for i in range(len(ref)):
        a, b = ours.get_val(i), ref.get_val(i)
        assert a.keys() == b.keys()
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f'item {i} {k}')
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, (i, k)
    cfg = get_config('res50_custom', img_size=256, image=DATA['val_imgs'])
    jcfg = jax_config('res50_custom', img_size=256, image=DATA['val_imgs'])
    ours, ref = COCODetection(cfg, mode='detect'), JaxCOCODetection(jcfg, mode='detect')
    assert len(ours) == len(ref) == 48
    for i in (0, 47):
        a, b = ours.get_detect(i), ref.get_detect(i)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError, match='train, val or detect'):
        COCODetection(cfg, mode='test')


def _perturbed_detections(item, rng):
    """Detections made from one val item's gt: most gts found with jittered
    boxes and shifted masks (some exactly), some with the wrong class, plus
    false positives; random scores. -> (ids, scores, pixel boxes, masks)."""
    h, w = item['height'], item['width']
    gt_boxes = item['boxes'] * np.array([w, h, w, h], np.float32)
    ids, boxes, masks = [], [], []
    for box, label, mask in zip(gt_boxes, item['labels'], item['masks']):
        if rng.rand() < 0.15:
            continue
        exact = rng.rand() < 0.3
        shift = (0, 0) if exact else tuple(rng.randint(-12, 13, size=2))
        boxes.append(box + (0 if exact else rng.normal(scale=6, size=4)))
        masks.append(np.roll(mask, shift, axis=(0, 1)).astype(bool))
        ids.append(label if rng.rand() < 0.85 else (label + 1) % 4)
    for _ in range(rng.randint(1, 4)):
        x, y = rng.randint(0, w - 60), rng.randint(0, h - 60)
        s = rng.randint(20, 60)
        boxes.append(np.array([x, y, x + s, y + s], np.float32))
        m = np.zeros((h, w), bool)
        m[y:y + s, x:x + s] = True
        masks.append(m)
        ids.append(rng.randint(4))
    order = rng.permutation(len(ids))
    scores = np.sort(rng.uniform(0.05, 1.0, len(ids)))[::-1].astype(np.float32)
    return (np.asarray(ids, np.int32)[order], scores,
            np.asarray(boxes, np.float32)[order].astype(np.int32),
            np.stack(masks)[order])


@pytest.fixture(scope='module')
def perturbed():
    cfg, _ = _configs()
    ds = COCODetection(cfg, mode='val')
    rng = np.random.RandomState(4)
    items = [ds.get_val(i) for i in range(16)]
    return items, [_perturbed_detections(it, rng) for it in items]


def test_calc_map_matches_jax_on_perturbed_detections(perturbed):
    items, dets = perturbed
    ours, ref = map_eval.make_ap_data(4), jax_map_eval.make_ap_data(4)
    for item, (ids, scores, boxes, masks) in zip(items, dets):
        for ap_data, prep in ((ours, map_eval.prep_metrics), (ref, jax_map_eval.prep_metrics)):
            prep(ap_data, ids, scores, boxes, masks, item['boxes'], item['labels'],
                 item['masks'], item['height'], item['width'])
    table, box_row, mask_row = map_eval.calc_map(ours, 4, step=3000)
    assert (table, box_row, mask_row) == jax_map_eval.calc_map(ref, 4, step=3000)
    assert '3k' in table
    for row in (box_row, mask_row):
        assert all(0 < v < 100 for v in row[1:]), row


def test_cocoeval_stats_match_jax(perturbed, coco, tmp_path, capsys):
    items, dets = perturbed
    ours_json, ref_json = map_eval.MakeJson({i: i for i in range(1, 5)}), \
        jax_map_eval.MakeJson({i: i for i in range(1, 5)})
    for item, (ids, scores, boxes, masks) in zip(items, dets):
        for mj in (ours_json, ref_json):
            for k in range(len(ids)):
                mj.add_bbox(item['image_id'], ids[k], boxes[k], scores[k])
                mj.add_mask(item['image_id'], ids[k], masks[k], scores[k])
    assert ours_json.bbox_data == ref_json.bbox_data
    assert ours_json.mask_data == ref_json.mask_data
    ours_json.dump(str(tmp_path))
    ours_coco, ref_coco = coco
    for kind, data in (('bbox', ours_json.bbox_data), ('segm', ours_json.mask_data)):
        stats = []
        for mod, gt in ((cocoeval, ours_coco), (jax_cocoeval, ref_coco)):
            ev = mod.COCOEvaluator(gt, data, kind)
            ev.evaluate()
            ev.accumulate()
            stats.append(ev.summarize(quiet=True))
        np.testing.assert_array_equal(stats[0], stats[1])
        assert 0 < stats[0][0] < 1
    jsons = str(tmp_path / 'bbox_detections.json'), str(tmp_path / 'mask_detections.json')
    box, mask = cocoeval.evaluate_detections(DATA['val_ann'], *jsons)
    out = capsys.readouterr().out
    assert 'bbox    AP' in out and 'segm    AP' in out
    ref_box, ref_mask = jax_cocoeval.evaluate_detections(DATA['val_ann'], *jsons)
    np.testing.assert_array_equal(box, ref_box)
    np.testing.assert_array_equal(mask, ref_mask)


class StubDetector:
    """Gt-derived detections (or none) for whatever batch it is shown, in
    the dataset's order, through the port's postprocess_host."""
    device = torch.device('cpu')

    def __init__(self, cfg, perfect=True):
        import cv2
        self.cfg, self.perfect, self.calls = cfg, perfect, 0
        self.ds = COCODetection(cfg, mode='val')
        self._i = 0
        self._cv2 = cv2

    def __call__(self, images):
        b, d = images.shape[0], self.cfg.max_detections
        ph = pw = self.cfg.img_size // 4
        boxes = np.zeros((b, d, 4), np.float32)
        scores = np.zeros((b, d), np.float32)
        ids = np.zeros((b, d), np.int32)
        valid = np.zeros((b, d), bool)
        masks_proto = np.zeros((b, ph, pw, d), np.float32)
        for row in range(b if self.perfect else 0):
            item = self.ds.get_val(min(self._i + row, len(self.ds) - 1))
            n = len(item['labels'])
            boxes[row, :n], scores[row, :n] = item['boxes'], 0.9
            ids[row, :n], valid[row, :n] = item['labels'], True
            for j in range(n):
                m = self._cv2.resize(item['masks'][j].astype(np.float32), (pw, ph),
                                     interpolation=self._cv2.INTER_LINEAR)
                masks_proto[row, :, :, j] = m > 0.5
        self._i += b
        dets = Detections(*(torch.from_numpy(x) for x in
                            (ids, scores, boxes, np.zeros((b, d, 32), np.float32), valid)))
        return dets, torch.from_numpy(masks_proto), None

    def postprocess_host(self, *args, **kw):
        self.calls += 1
        return Detector.postprocess_host(self, *args, **kw)


def test_perfect_detections_score_high_and_empty_zero():
    cfg, _ = _configs(val_num=8)
    table, box_row, mask_row = port_eval.evaluate(StubDetector(cfg), cfg, max_images=8)
    assert box_row[1] > 95 and mask_row[1] > 80
    table, box_row, mask_row = port_eval.evaluate(StubDetector(cfg, perfect=False), cfg,
                                                  max_images=8)
    assert box_row[1:] == mask_row[1:] == [0.0] * 11


def test_tail_batch_is_padded_and_not_scored():
    cfg, _ = _configs()
    full = StubDetector(cfg)
    ref = port_eval.evaluate(full, cfg, max_images=8)
    cfg.val_bs = 3                       # 8 images: 3 + 3 + 2, the last batch padded
    padded = StubDetector(cfg)
    assert port_eval.evaluate(padded, cfg, max_images=8) == ref
    assert full.calls == padded.calls == 8 and padded._i == 9


def test_crowd_only_images_are_skipped_unless_strict(tmp_path, capsys):
    with open(DATA['val_ann']) as f:
        d = json.load(f)
    gt = coco_io.COCO(DATA['val_ann'])
    for a in d['annotations']:
        if a['image_id'] == 2:          # image 2 becomes crowd-only, as RLE
            a['iscrowd'] = 1
            a['segmentation'] = coco_io.mask_to_rle(gt.annToMask(a))
    ann = tmp_path / 'crowd.json'
    ann.write_text(json.dumps(d))
    cfg = get_config('res50_custom', mode='val', img_size=256, val_imgs=DATA['val_imgs'],
                     val_ann=str(ann))
    det = StubDetector(cfg, perfect=False)
    port_eval.evaluate(det, cfg, max_images=8)
    assert 'skipping val image 1: No valid object' in capsys.readouterr().out
    assert det.calls == 7
    cfg.strict = True
    with pytest.raises(RuntimeError, match='No valid object'):
        port_eval.evaluate(StubDetector(cfg, perfect=False), cfg, max_images=8)


@pytest.fixture(scope='module')
def seeded_ckpt(tmp_path_factory):
    """A seeded JAX res50_custom init, written by the JAX save_checkpoint."""
    cfg = jax_config('res50_custom', img_size=64)
    init = jax.jit(lambda key: JaxYolact(cfg=cfg).init(
        key, jnp.zeros((1, 64, 64, 3), jnp.float32), train=False))
    variables = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0)))
    path = str(tmp_path_factory.mktemp('ckpt') / 'seeded_res50_custom_0.ckpt')
    jax_ckpt.save_checkpoint(path, variables)
    return path


def _recording(postprocess, log):
    def run(dets, masks_proto, img_h, img_w, visual_thre=None):
        out = postprocess(dets, masks_proto, img_h, img_w, visual_thre)
        log.append((dets, out))
        return out
    return run


def test_evaluate_matches_jax_end_to_end(seeded_ckpt):
    cfg, jcfg = _configs(val_num=8)
    jdet = JaxDetector(jcfg, jax_ckpt.load_weights_auto(seeded_ckpt, include_semantic=False))
    det = load_detector(seeded_ckpt, cfg, device='cpu')
    ref_log, log = [], []
    jdet.postprocess_host = _recording(jdet.postprocess_host, ref_log)
    det.postprocess_host = _recording(det.postprocess_host, log)
    ref = jax_eval.evaluate(jdet, jcfg, max_images=8)
    ours = port_eval.evaluate(det, cfg, max_images=8)
    assert ours[1:] == ref[1:] and ours[0] == ref[0]
    assert len(log) == len(ref_log) == 8
    for i, ((d, out), (rd, rout)) in enumerate(zip(log, ref_log)):
        np.testing.assert_array_equal(d.valid.numpy(), rd.valid, err_msg=f'image {i}')
        np.testing.assert_array_equal(d.ids.numpy(), rd.ids, err_msg=f'image {i}')
        np.testing.assert_allclose(d.scores.numpy(), rd.scores, rtol=0, atol=ATOL)
        np.testing.assert_allclose(d.boxes.numpy(), rd.boxes, rtol=0, atol=ATOL)
        assert d.valid.sum() == 100
        np.testing.assert_array_equal(out[0], rout[0])
        assert out[3].shape == rout[3].shape and out[3].any()
        assert (out[3] != rout[3]).mean() < MISMATCH, f'image {i}'


@pytest.mark.parametrize('coco_api', [False, True])
def test_cli_runs_on_the_cpu(seeded_ckpt, tmp_path, monkeypatch, capsys, coco_api):
    monkeypatch.chdir(tmp_path)
    argv = ['--weight', seeded_ckpt, '--img_size', '64', '--val_num', '3', '--val_bs', '2',
            '--device', 'cpu', *(f'--{k}={v}' for k, v in DATA.items())]
    port_eval.main(argv + ['--coco_api'] * coco_api)
    out = capsys.readouterr().out
    assert 'res50_custom' in out and 'val_bs: 2' in out
    if coco_api:
        for name in ('bbox_detections.json', 'mask_detections.json'):
            data = json.loads((tmp_path / 'results' / name).read_text())
            assert {d['image_id'] for d in data} == {1, 2, 3}
        assert 'bbox    AP' in out and 'segm    AP' in out
    else:
        assert '| box  |' in out and '| mask |' in out


def test_cli_stops_where_the_port_cannot_follow(monkeypatch):
    base = ['--weight', 'missing_res50_custom.ckpt']
    if torch.cuda.device_count() < 2:      # a mesh of more CUDA devices than there are
        with pytest.raises(SystemExit, match='--data_parallel 2: a mesh of 2 CUDA devices'):
            port_eval.main(base + ['--data_parallel', '2'])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            port_eval.main(base)
    monkeypatch.setitem(sys.modules, 'cv2', None)       # as on a machine without cv2
    image_io.backend.cache_clear()
    try:
        with pytest.raises(SystemExit, match='evaluation needs cv2'):
            port_eval.main(base + ['--device', 'cpu'])
    finally:
        image_io.backend.cache_clear()
    assert not os.path.exists('missing_res50_custom.ckpt')
