"""The --traditional_nms path against the JAX package's, on the CPU: the C++
greedy NMS (the port's own csrc/nms.cc, built by g++ into build/), the
per-class tail, the Detector that runs the forward with the tail, and the
eval CLI's table."""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import eval as jax_eval
from yolact_minimal_tpu.config import get_config as jax_config
from yolact_minimal_tpu.models.yolact import Yolact as JaxYolact
from yolact_minimal_tpu.ops import traditional_nms as jax_tnms
from yolact_minimal_tpu.pipeline import Detector as JaxDetector
from yolact_minimal_tpu.utils import checkpoint as jax_ckpt
from yolact_minimal_torch import eval as port_eval
from yolact_minimal_torch.config import get_config
from yolact_minimal_torch.ops import _build
from yolact_minimal_torch.ops import traditional_nms as tnms
from yolact_minimal_torch.pipeline import Detector
from yolact_minimal_torch.utils.weights import from_jax_variables

torch.set_num_threads(1)

IMG = 64
# Slates of two forward passes (JAX and the port, float32 on the CPU): the
# network's float noise (~1e-6 of each output's scale) reaches scores,
# boxes and coefs; the masks are sigmoids of the coefs' products.
ATOL = 1e-5
DATA = dict(val_imgs='custom_dataset/images', val_ann='custom_dataset/annotations.json')


def _boxes(rng, n, scale=100.0):
    xy = rng.uniform(0, scale, size=(n, 2))
    wh = rng.uniform(0, scale / 2, size=(n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize('case', ['random', 'ties', 'zero_area', 'empty', 'one'])
def test_greedy_nms_equals_jax(case):
    rng = np.random.RandomState(len(case))
    n = {'empty': 0, 'one': 1}.get(case, 300)
    boxes = _boxes(rng, n)
    scores = rng.rand(n).astype(np.float32)
    if case == 'ties':          # equal scores keep their input order
        scores = np.round(scores * 4) / 4
        boxes[::7] = boxes[0]
    if case == 'zero_area':     # x2 = x1 or y2 = y1: the +1 convention still gives area 1
        boxes[::3, 2] = boxes[::3, 0]
        boxes[1::3, 3] = boxes[1::3, 1]
    for thre in (0.3, 0.5, 0.7):
        ours = tnms.greedy_nms(boxes, scores, thre)
        ref = jax_tnms.greedy_nms(boxes, scores, thre)
        assert ours.dtype == ref.dtype == np.int32
        np.testing.assert_array_equal(ours, ref)
    assert len(ours) == min(n, len(ours)) and (n == 0 or len(ours) >= 1)


@pytest.mark.parametrize('max_det', [100, 5])
def test_traditional_nms_equals_jax(max_det):
    rng = np.random.RandomState(3)
    a, c = 400, 12
    boxes = np.clip(_boxes(rng, a, 1.0), 0, 1)
    coefs = rng.normal(size=(a, 32)).astype(np.float32)
    scores = rng.rand(c, a).astype(np.float32) ** 4
    scores[5] = 0.0                               # a class with no candidate
    scores[:, :20] = np.round(scores[:, :20], 1)  # exact ties across and within classes
    args = (IMG, 0.05, 0.5, max_det)
    ours = tnms.traditional_nms(boxes, coefs, scores, *args)
    ref = jax_tnms.traditional_nms(boxes, coefs, scores, *args)
    assert len(ours[2]) == min(max_det, len(ours[2])) > 0
    for o, r in zip(ours, ref):
        assert o.dtype == r.dtype
        np.testing.assert_array_equal(o, r)
    empty = tnms.traditional_nms(boxes, coefs, scores * 0, *args)
    for o, r in zip(empty, jax_tnms.traditional_nms(boxes, coefs, scores * 0, *args)):
        assert o.shape == r.shape and o.dtype == r.dtype
    with pytest.raises(ValueError, match='boxes \\[N, 4\\]'):
        tnms.greedy_nms(boxes[:, :3], scores[0], 0.5)


def test_host_library_is_named_by_its_source_and_needs_gxx(tmp_path, monkeypatch):
    assert _build.host_target('nms').parent == _build.HOST_BUILD_DIR
    assert _build.HOST_BUILD_DIR.parts[-2:] == ('build', 'torch_host')
    monkeypatch.setattr(_build, 'CSRC', tmp_path)
    monkeypatch.setattr(_build, 'HOST_BUILD_DIR', tmp_path / 'build')
    (tmp_path / 'k.cc').write_text('// one\n')
    first = _build.host_target('k')
    (tmp_path / 'k.cc').write_text('// two\n')
    assert _build.host_target('k') != first        # an edited source rebuilds
    monkeypatch.setattr(_build, 'CXX_FLAGS', _build.CXX_FLAGS + ('-g',))
    assert _build.host_target('k') not in (first,)   # and so do other flags
    (tmp_path / 'k.cc').write_text('int broken(\n')
    with pytest.raises(RuntimeError, match='g\\+\\+ failed for csrc/k.cc'):
        _build.build_host('k')
    assert not list((tmp_path / 'build').glob('*.tmp'))
    monkeypatch.setattr(_build.shutil, 'which', lambda name: None)
    with pytest.raises(RuntimeError, match='g\\+\\+ not found'):
        _build.build_host('k')


@pytest.fixture(scope='module')
def detectors():
    """JAX and port Detectors with traditional_nms on one random init; the
    class head scaled x20 so the softmax scores separate (as in
    test_torch_pipeline.py)."""
    cfg = jax_config('res50_coco', img_size=IMG, traditional_nms=True)
    init = jax.jit(lambda key: JaxYolact(cfg=cfg).init(
        key, jnp.zeros((1, IMG, IMG, 3), jnp.float32), train=False))
    v = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(1)))
    v['params']['prediction_layers']['conf_layer']['kernel'] = \
        v['params']['prediction_layers']['conf_layer']['kernel'] * 20
    jdet = JaxDetector(cfg, v, static_weights=False)
    det = Detector(get_config('res50_coco', img_size=IMG, traditional_nms=True),
                   from_jax_variables(v), device='cpu')
    images = np.random.RandomState(2).normal(size=(2, IMG, IMG, 3)).astype(np.float32)
    return jdet, det, images


def test_traditional_detector_matches_jax(detectors):
    jdet, det, images = detectors
    ref, ref_masks, ref_proto = jdet(jnp.asarray(images))
    ours, masks, proto = det(images)
    assert all(t.device.type == 'cpu' for t in (*ours, masks, proto))
    assert ours.valid.sum() > 10
    np.testing.assert_array_equal(ours.valid.numpy(), ref.valid)
    np.testing.assert_array_equal(ours.ids.numpy(), ref.ids)
    for got, want in ((ours.scores, ref.scores), (ours.boxes, ref.boxes),
                      (ours.coefs, ref.coefs), (masks, ref_masks)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(proto.numpy(), ref_proto, rtol=0,
                               atol=1e-4 * np.abs(ref_proto).max())
    # the tail alone is the JAX tail on the same raw outputs, bit for bit
    with torch.inference_mode():
        raw = [t.numpy() for t in det._infer_raw(images)]
    tail = det.traditional_tail(*raw)
    jraw = jax.device_get(jdet._infer_raw(jnp.asarray(images)))
    jdet._infer_raw = lambda _: tuple(raw)
    jtail = jdet._call_traditional(images)
    for o, r in zip((*tail[0], tail[1]), (*jtail[0], jtail[1])):
        np.testing.assert_array_equal(o.numpy(), r)
    for o, r in zip(raw, jraw):
        np.testing.assert_allclose(o, r, rtol=0, atol=1e-4 * np.abs(r).max())
    # detect_fixed stays fast NMS, as JAX's does
    fixed, _ = det.detect_fixed(images, IMG)
    jfixed, _ = jdet.detect_fixed(jnp.asarray(images), IMG)
    np.testing.assert_array_equal(fixed.ids.numpy(), jfixed.ids)
    np.testing.assert_allclose(fixed.scores.numpy(), jfixed.scores, rtol=0, atol=ATOL)


def _recording(postprocess, log):
    def run(dets, masks_proto, img_h, img_w, visual_thre=None):
        out = postprocess(dets, masks_proto, img_h, img_w, visual_thre)
        log.append((dets, out))
        return out
    return run


def test_eval_cli_with_the_flag_gives_jax_table(tmp_path, monkeypatch, capsys):
    """A seeded res50_custom init whose foreground logits are raised by 4 at
    every anchor, so that every class has candidates and every slate fills;
    the port's eval CLI against JAX's evaluate() on 8 images: the printed
    table and each image's slate."""
    cfg = jax_config('res50_custom', img_size=IMG)
    init = jax.jit(lambda key: JaxYolact(cfg=cfg).init(
        key, jnp.zeros((1, IMG, IMG, 3), jnp.float32), train=False))
    variables = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0)))
    head = variables['params']['prediction_layers']['conf_layer']
    bias = np.array(head['bias']).reshape(-1, cfg.num_classes)
    bias[:, 1:] += 4.0
    head['bias'] = bias.reshape(-1)
    path = str(tmp_path / 'seeded_res50_custom_0.ckpt')
    jax_ckpt.save_checkpoint(path, variables)
    root = Path(__file__).resolve().parents[1]
    data = {k: f'{root}/{v}' for k, v in DATA.items()}
    jcfg = jax_config('res50_custom', mode='val', img_size=IMG, traditional_nms=True,
                      val_num=8, **data)
    jdet = JaxDetector(jcfg, jax_ckpt.load_weights_auto(path, include_semantic=False))
    ref_log, log = [], []
    jdet.postprocess_host = _recording(jdet.postprocess_host, ref_log)
    table = jax_eval.evaluate(jdet, jcfg, max_images=8)[0]
    capsys.readouterr()
    monkeypatch.chdir(tmp_path)
    post = Detector.postprocess_host
    monkeypatch.setattr(Detector, 'postprocess_host',
                        lambda self, *a: _recording(post.__get__(self), log)(*a))
    port_eval.main(['--weight', path, '--img_size', str(IMG), '--val_num', '8',
                    '--traditional_nms', '--device', 'cpu',
                    *(f'--{k}={v}' for k, v in data.items())])
    out = capsys.readouterr().out
    assert 'traditional_nms: True' in out
    assert table in out
    assert len(log) == len(ref_log) == 8
    for i, ((d, _), (rd, _)) in enumerate(zip(log, ref_log)):
        assert d.valid.sum() == 100
        np.testing.assert_array_equal(d.valid.numpy(), rd.valid, err_msg=f'image {i}')
        np.testing.assert_array_equal(d.ids.numpy(), rd.ids, err_msg=f'image {i}')
        np.testing.assert_allclose(d.scores.numpy(), rd.scores, rtol=0, atol=ATOL)
