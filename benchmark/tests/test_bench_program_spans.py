"""The readers of the program's own spans and counters, on synthetic event
lists and counters."""
import subprocess
import sys

import pytest

from _util import ROOT  # the repository on the path

from benchmark.core import cell as cells, program_spans
from benchmark.core.trace import Event, Trace

MAIN, OTHER = 1, 2
CTX = {'calls': 2, 'batch': 4, 'slots': 10}


class Slice:
    """A slice of two calls on MAIN: program spans on the host, kernels
    launched from them, device gaps where no kernel runs."""

    def __init__(self, start=0.0, end=1000.0):
        self.events = [Event('bench.slice', 'op', start, end, MAIN)]
        self.corr = 100

    def op(self, name, start, end, tid=MAIN):
        self.events.append(Event(name, 'op', start, end, tid))

    def kernel(self, name, launch, start, end, tid=MAIN):
        self.corr += 1
        self.events.append(Event('cudaLaunchKernel', 'runtime', launch, launch + 1, tid,
                                 self.corr))
        self.events.append(Event(name, 'kernel', start, end, 0, self.corr))

    def trace(self):
        return Trace(self.events)


def _detect_slice():
    """Each call (500 us): copy 0-50 (the device idle), forward 50-300 with a
    glue span 100-150 inside it, nms 300-400, masks 400-480. The device
    runs 60-90, 100-140 (glue), 160-200, 310-320 and 420-460; the rest of
    each call is idle. Another thread opens program spans and launches a
    kernel meanwhile, which no reader takes."""
    s = Slice(0, 1000)
    for c in (0, 500):
        s.op('bench.call', c, c + 500)
        s.op('yolact.detect', c, c + 490)
        s.op('yolact.detect.copy', c, c + 50)
        s.op('yolact.detect.forward', c + 50, c + 300)
        s.op('yolact.swin.glue', c + 100, c + 150)
        s.op('yolact.detect.nms', c + 300, c + 400)
        s.op('yolact.detect.masks', c + 400, c + 480)
        s.kernel('conv', c + 55, c + 60, c + 90)
        s.kernel('roll_cuda_kernel', c + 110, c + 100, c + 140)
        s.kernel('conv', c + 160, c + 160, c + 200)
        s.kernel('suppression_kernel', c + 305, c + 310, c + 320)
        s.kernel('mask_finalize_kernel', c + 410, c + 420, c + 460)
        s.op('yolact.detect.nms', c + 300, c + 400, tid=OTHER)
        s.op('yolact.swin.glue', c + 100, c + 150, tid=OTHER)
        s.kernel('elsewhere', c + 320, c + 470, c + 475, tid=OTHER)
    return s.trace()


def _read(name, trace, ctx=CTX):
    return cells.metric_reader(name).read(trace, ctx)


def test_device_time_goes_to_the_innermost_span_of_the_launch_on_the_calling_thread():
    t = _detect_slice()
    assert _read('nms_ms.detect', t) == pytest.approx(0.010)
    assert _read('masks_ms.detect', t) == pytest.approx(0.040)
    assert _read('swin_glue_ms.detect', t) == pytest.approx(0.040)
    forward = program_spans.launched(t, program_spans.DETECT_FORWARD)
    assert sorted(e.name for e in forward) == ['conv'] * 4          # the glue's left out


def test_idle_time_goes_to_the_innermost_span_on_the_calling_thread():
    t = _detect_slice()
    # copy: 0-50 idle; forward: 50-60, 90-100, 150-160, 200-300 idle (the glue's own
    # 140-150 left out); a call's end 480-500 lies in no detect layer
    assert _read('idle_copy_ms.detect', t) == pytest.approx(0.050)
    assert _read('idle_forward_ms.detect', t) == pytest.approx(0.130)
    assert program_spans.idle_ms(t, program_spans.SWIN_GLUE, CTX) == pytest.approx(0.010)
    assert program_spans.idle_ms(t, program_spans.DETECT_NMS, CTX) == pytest.approx(0.090)


def test_a_span_on_another_thread_takes_no_idle_time():
    s = Slice(0, 100)
    s.op('bench.call', 0, 100)
    s.op('yolact.train.copy', 0, 100, tid=OTHER)
    s.kernel('k', 1, 40, 60)
    t = s.trace()
    assert program_spans.idle_ms(t, program_spans.TRAIN_COPY, {'calls': 1}) == 0.0
    assert program_spans.host_ms(t, program_spans.TRAIN_COPY, {'calls': 1}) is None


def test_train_readers_split_the_matcher_from_the_losses():
    s = Slice(0, 1000)
    s.op('bench.call', 0, 1000)
    s.op('yolact.train.step', 0, 990)
    s.op('yolact.train.copy', 0, 100)
    s.op('yolact.train.forward', 100, 400)
    s.op('yolact.train.loss', 400, 600)
    s.op('yolact.train.match', 410, 450)
    s.op('autograd::engine::evaluate_function: AddBackward0', 600, 900, tid=OTHER)
    s.kernel('Memcpy HtoD', 90, 100, 120)
    s.kernel('conv', 150, 150, 390)
    s.kernel('iou', 420, 420, 430)
    s.kernel('argsort', 460, 460, 490)
    s.kernel('bce', 500, 500, 520)
    s.kernel('conv_bwd', 610, 610, 900, tid=OTHER)
    t = s.trace()
    ctx = {'calls': 1, 'batch': 2}
    assert _read('match_ms.train', t, ctx) == pytest.approx(0.010)
    assert _read('loss_terms_ms.train', t, ctx) == pytest.approx(0.050)
    assert _read('copy_host_ms.train', t, ctx) == pytest.approx(0.100)
    assert _read('idle_copy_ms.train', t, ctx) == pytest.approx(0.100)
    assert _read('swin_glue_ms.train', t, ctx) is None


def test_readers_give_none_where_the_slice_holds_no_program_span():
    s = Slice(0, 100)
    s.op('bench.call', 0, 100)
    s.op('bench.forward', 10, 90)
    s.kernel('conv', 20, 20, 40)
    t = s.trace()
    for name in ('nms_ms.detect', 'masks_ms.detect', 'idle_copy_ms.detect',
                 'idle_forward_ms.detect', 'swin_glue_ms.detect', 'match_ms.train',
                 'loss_terms_ms.train', 'copy_host_ms.train', 'idle_copy_ms.train',
                 'swin_glue_ms.train'):
        assert _read(name, t) is None, name


COUNTERS = {'nms_candidates.detect': ('nms.candidates', 8 * 1024, 1024.0),
            'slate_fill.detect': ('detect.valid', 60, 75.0),
            'positives_per_image.train': ('train.positives', 40, 5.0)}


@pytest.mark.parametrize('metric', sorted(COUNTERS))
def test_counter_readers_take_the_programs_counts_a_call_and_image(metric, monkeypatch):
    from yolact_minimal_torch.utils import trace as program_trace
    counter, kept, want = COUNTERS[metric]
    t = Slice(0, 10).trace()
    monkeypatch.setattr(program_trace, 'counts', lambda: {counter: kept})
    assert _read(metric, t) == pytest.approx(want)
    monkeypatch.setattr(program_trace, 'counts', lambda: {})
    assert _read(metric, t) is None
    import yolact_minimal_torch.utils
    monkeypatch.delattr(yolact_minimal_torch.utils, 'trace')
    monkeypatch.setitem(sys.modules, 'yolact_minimal_torch.utils.trace', None)
    assert program_spans.counted(counter) is None          # a program without counters


def test_the_span_reader_loads_nothing_of_the_program():
    code = ('import sys\nsys.path.insert(0, %r)\nimport benchmark.core.program_spans\n'
            'print(sorted({m.split(".")[0] for m in sys.modules}))' % str(ROOT))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert 'yolact_minimal_torch' not in out.stdout and 'jax' not in out.stdout


def test_every_metric_has_its_reader_and_lists_known_cells():
    bench = cells.load_json(ROOT / 'BENCHMARK.json')
    cell_names = {w['name'] for w in bench['workloads']}
    for m in bench['per_layer']:
        assert (ROOT / 'benchmark' / 'metrics' / f'{m["name"]}.py').exists(), m['name']
        assert set(m.get('workloads', ())) <= cell_names, m['name']
