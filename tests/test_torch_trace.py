"""The port's profiler spans and work counters (`utils/trace.py`), on the CPU.

- with no profiler recording, `span` builds no range and `count` keeps
  nothing;
- under a profiler, `detect_fixed` and `__call__` open `yolact.detect`
  holding copy, forward, nms and masks in that order, without overlap;
  `train_step` opens `yolact.train.step` holding copy, forward, loss (the
  matcher inside it), backward, all_reduce and optimizer; a swin forward
  opens two `yolact.swin.glue` spans a block in every block form;
- the counters equal the same sums taken independently;
- an exported swin forward carries no profiler node.
"""
import numpy as np
import pytest
import torch

from yolact_minimal_torch import deploy
from yolact_minimal_torch.config import get_config
from yolact_minimal_torch.models import swin
from yolact_minimal_torch.ops.matching import match
from yolact_minimal_torch.ops.nms import detect_postprocess_batch
from yolact_minimal_torch.pipeline import Detector
from yolact_minimal_torch.train_state import create_train_state, train_step
from yolact_minimal_torch.utils import trace

torch.set_num_threads(1)

IMG = 64
DETECT_LAYERS = ('yolact.detect.copy', 'yolact.detect.forward', 'yolact.detect.nms',
                 'yolact.detect.masks')
TRAIN_LAYERS = ('yolact.train.copy', 'yolact.train.forward', 'yolact.train.loss',
                'yolact.train.backward', 'yolact.train.all_reduce', 'yolact.train.optimizer')


@pytest.fixture(autouse=True)
def _fresh_counters():
    trace.reset()
    yield
    trace.reset()


def _profiled(fn):
    """(fn's result, the `yolact.*` spans it opened as (name, start, end),
    in order of opening)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name.startswith('yolact.'))
    return out, sorted(spans, key=lambda s: s[1])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _in_order_without_overlap(spans):
    return all(a[2] <= b[1] for a, b in zip(spans, spans[1:]))


@pytest.fixture(scope='module')
def detector():
    return Detector(get_config('res50_coco', img_size=IMG, nms_score_thre=0.002),
                    device='cpu', seed=0)


@pytest.fixture(scope='module')
def images():
    return np.random.RandomState(0).randn(2, IMG, IMG, 3).astype(np.float32)


def _train_case():
    cfg = get_config('res50_custom', mode='train', img_size=IMG, max_gt=4, train_bs=2)
    rng = np.random.RandomState(3)
    xy1 = rng.uniform(0, 0.5, size=(2, 4, 2)).astype(np.float32)
    wh = rng.uniform(0.2, 0.45, size=(2, 4, 2)).astype(np.float32)
    batch = dict(image=rng.randn(2, IMG, IMG, 3).astype(np.float32),
                 boxes=np.concatenate([xy1, xy1 + wh], 2),
                 labels=rng.randint(0, 4, size=(2, 4)).astype(np.int32),
                 valid=np.ones((2, 4), bool),
                 masks_proto=(rng.rand(2, 4, IMG // 4, IMG // 4) > 0.5).astype(np.uint8),
                 masks_seg=(rng.rand(2, 4, IMG // 8, IMG // 8) > 0.5).astype(np.uint8))
    return cfg, batch


def test_without_a_profiler_no_range_is_built_and_nothing_is_kept(detector, images,
                                                                   monkeypatch):
    def refuse(name):
        raise AssertionError(f'a range {name!r} was built with no profiler recording')
    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    assert trace.span('yolact.detect') is trace.span('yolact.swin.glue')
    dets, _ = detector.detect_fixed(images, IMG)
    detector(images)
    cfg, batch = _train_case()
    train_step(create_train_state(cfg, 'cpu', seed=0), batch)
    trace.count('detect.valid', dets.valid)
    trace.count('detect.size', lambda: refuse('a counted function'))
    assert trace.counts() == {}


def test_a_counted_function_is_called_while_a_profiler_records():
    trace.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        trace.count('size', lambda: 3)
        trace.count('size', torch.tensor([1, 1]))
    assert trace.counts() == {'size': 5}
    trace.reset()


@pytest.mark.parametrize('call', ['detect_fixed', '__call__'])
def test_detect_spans_nest_in_order(detector, images, call):
    fn = (lambda: detector.detect_fixed(images, IMG)) if call == 'detect_fixed' \
        else (lambda: detector(images))
    _, spans = _profiled(fn)
    outer = [s for s in spans if s[0] == 'yolact.detect']
    layers = [s for s in spans if s[0] in DETECT_LAYERS]
    assert len(outer) == 1
    assert [s[0] for s in layers] == list(DETECT_LAYERS)
    assert all(_inside(s, outer[0]) for s in layers)
    assert _in_order_without_overlap(layers)
    assert {s[0] for s in spans} == {'yolact.detect', *DETECT_LAYERS}


def test_traditional_nms_spans_hold_the_host_tail(images):
    det = Detector(get_config('res50_coco', img_size=IMG, nms_score_thre=0.002,
                              traditional_nms=True), device='cpu', seed=0)
    (dets, _, _), spans = _profiled(lambda: det(images))
    names = [s[0] for s in spans]
    assert names == ['yolact.detect', 'yolact.detect.copy', 'yolact.detect.forward',
                     'yolact.detect.nms']
    assert _in_order_without_overlap(spans[1:])
    assert trace.counts() == {'detect.valid': int(dets.valid.sum())}


def test_train_step_spans_nest_in_order():
    cfg, batch = _train_case()
    state = create_train_state(cfg, 'cpu', seed=0)
    _, spans = _profiled(lambda: train_step(state, batch))
    step = [s for s in spans if s[0] == 'yolact.train.step']
    layers = [s for s in spans if s[0] in TRAIN_LAYERS]
    matches = [s for s in spans if s[0] == 'yolact.train.match']
    assert len(step) == 1 and len(matches) == 1
    assert [s[0] for s in layers] == list(TRAIN_LAYERS)
    assert all(_inside(s, step[0]) for s in layers)
    assert _in_order_without_overlap(layers)
    assert _inside(matches[0], layers[TRAIN_LAYERS.index('yolact.train.loss')])


@pytest.mark.parametrize('form', swin.FORMS)
@pytest.mark.parametrize('training', [False, True])
def test_swin_forward_opens_two_glue_spans_a_block(form, training):
    model = swin.Swin(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8),
                          block_forms=form, drop_path_rate=0.0)
    model.train(training)
    x = torch.randn(1, IMG, IMG, 3)
    with torch.set_grad_enabled(training):
        _, spans = _profiled(lambda: model(x))
    assert [s[0] for s in spans] == ['yolact.swin.glue'] * (2 * 8)


@pytest.mark.parametrize('route', ['plain', 'fused'])
def test_swin_counters_count_the_attention_halves_on_both_glue_routes(monkeypatch, route):
    """Every attention half counts in `swin.attn_blocks`, those that take the
    glue kernels in `swin.glue_fused_blocks` (the route forced here: on the
    CPU its operators run their plain versions), and `swin.rows` /
    `swin.window_rows` count the same rows on either route; the fused route
    opens the same two glue spans a block."""
    model = swin.Swin(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8),
                      drop_path_rate=0.0).eval()
    if route == 'fused':
        monkeypatch.setattr(swin.SwinBlock, '_fused_glue', lambda self, x, rate: True)
    x = torch.randn(1, IMG, IMG, 3)
    with torch.no_grad():
        _, spans = _profiled(lambda: model(x))
    assert [s[0] for s in spans] == ['yolact.swin.glue'] * (2 * 8)
    sides = [IMG // 4 >> i for i in range(4)]                 # 16, 8, 4, 2
    padded = [-(-side // 7) * 7 for side in sides]            # 21, 14, 7, 7
    got = trace.counts()
    assert got['swin.attn_blocks'] == 8
    assert got.get('swin.glue_fused_blocks') == (8 if route == 'fused' else None)
    assert got['swin.rows'] == 2 * sum(side * side for side in sides)
    assert got['swin.window_rows'] == 2 * sum(p * p for p in padded)


@pytest.mark.parametrize('pre_topk', [64, 256, 0])
def test_detect_counters_equal_independent_sums(pre_topk):
    rng = np.random.RandomState(1)
    b, a, c = 2, 300, 5
    class_p = torch.softmax(torch.from_numpy(rng.randn(b, a, c).astype(np.float32) * 3), -1)
    box_p = torch.from_numpy(rng.randn(b, a, 4).astype(np.float32) * 0.1)
    coef_p = torch.from_numpy(rng.randn(b, a, 32).astype(np.float32))
    anchors = torch.from_numpy(np.concatenate([rng.uniform(0.2, 0.8, (a, 2)),
                                               rng.uniform(0.05, 0.3, (a, 2))], 1)
                               .astype(np.float32))
    thre = 0.8
    dets, _ = _profiled(lambda: detect_postprocess_batch(class_p, box_p, coef_p, anchors,
                                                         thre, 0.5, 20, 10, pre_topk))
    best = class_p[..., 1:].amax(-1)
    if pre_topk:
        best = torch.topk(best, pre_topk).values
    assert trace.counts() == {'nms.candidates': int((best > thre).sum())}
    assert int((best > thre).sum()) > 0
    trace.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        Detector._infer(_FakeDetector(class_p, box_p, coef_p, anchors, thre, pre_topk), None)
    got = trace.counts()
    assert got['detect.valid'] == int(dets.valid.sum()) > 0
    assert got['nms.candidates'] == int((best > thre).sum())


class _FakeDetector:
    """What `Detector._infer` reads, with the network's outputs given."""

    def __init__(self, class_p, box_p, coef_p, anchors, thre, pre_topk):
        self.outputs = (class_p, box_p, coef_p, torch.zeros(class_p.shape[0], 4, 4, 32))
        self.anchors = anchors
        self.cfg = get_config('res50_coco', nms_score_thre=thre, nms_iou_thre=0.5, top_k=20,
                              max_detections=10, nms_pre_topk=pre_topk)

    def _forward(self, images):
        return self.outputs


def test_train_counter_equals_the_matchers_positives():
    cfg, batch = _train_case()
    state = create_train_state(cfg, 'cpu', seed=0)
    _profiled(lambda: train_step(state, batch))
    gt = {k: torch.from_numpy(v) for k, v in batch.items()}
    m = match(gt['boxes'], gt['labels'], gt['valid'], state.anchors, cfg.pos_iou_thre,
              cfg.neg_iou_thre)
    positives = int((m.conf_gt > 0).sum())
    assert positives > 0
    assert trace.counts() == {'train.positives': positives}


def test_exported_swin_forward_carries_no_profiler_node(tmp_path):
    cfg = get_config('swin_tiny_coco', img_size=IMG)
    model = Detector(cfg, device='cpu', seed=0).model
    path = deploy.export_model(cfg, model, str(tmp_path / 'swin.pt2'), check_parity=False,
                               device='cpu')
    graph = torch.export.load(path).graph
    targets = [str(n.target) for n in graph.nodes if n.op == 'call_function']
    assert targets and not [t for t in targets if 'profiler' in t or 'record_function' in t]
