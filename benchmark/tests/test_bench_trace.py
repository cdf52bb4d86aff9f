"""The trace reader and the per-layer readers on synthetic event lists."""
import pytest

from _util import small_cell  # noqa: F401  (the repository on the path)

from benchmark.core import cell as cells, readers
from benchmark.core.trace import Event, Spans, Trace, group_of

MAIN, BWD = 1, 2


class Slice:
    """Builds a slice: spans on the host, kernels launched from them."""

    def __init__(self, start=0.0, end=1000.0):
        self.events = [Event('bench.slice', 'op', start, end, MAIN)]
        self.corr = 100

    def op(self, name, start, end, tid=MAIN):
        self.events.append(Event(name, 'op', start, end, tid))

    def kernel(self, name, launch, start, end, tid=MAIN, kind='kernel'):
        self.corr += 1
        self.events.append(Event('cudaLaunchKernel', 'runtime', launch, launch + 2, tid,
                                 self.corr))
        self.events.append(Event(name, kind, start, end, 0, self.corr))

    def trace(self):
        return Trace(self.events)


def test_busy_is_the_union_of_device_intervals_inside_the_slice():
    s = Slice(0, 100)
    s.kernel('a', 1, 10, 30)
    s.kernel('b', 2, 20, 40)            # overlaps a
    s.kernel('Memcpy HtoD (Pageable -> Device)', 3, 50, 60, kind='memcpy')
    s.kernel('c', 4, 95, 120)           # runs past the slice's end
    t = s.trace()
    assert t.busy_intervals() == [(10, 40), (50, 60), (95, 100)]
    assert t.busy_s == pytest.approx(45e-6)
    assert t.idle_gaps() == [(0, 10), (40, 50), (60, 95)]
    assert readers.idle_percent(t) == pytest.approx(55.0)


def test_kernels_are_attributed_by_their_launch_and_thread():
    s = Slice()
    s.op('bench.call', 0, 500)
    s.op('bench.forward', 10, 200)
    s.op('autograd::engine::evaluate_function: ConvolutionBackward0', 300, 400, tid=BWD)
    s.op('Optimizer.step#SGD.step', 420, 480)
    s.kernel('conv_fwd', 50, 60, 70)                    # forward
    s.kernel('loss_kernel', 250, 260, 262)              # loss: in the call, outside the rest
    s.kernel('conv_bwd', 310, 320, 340, tid=BWD)        # backward, on the engine's thread
    s.kernel('sgd', 430, 440, 445)                      # optimizer
    t = s.trace()
    ctx = {'calls': 1}
    names = lambda evs: sorted(e.name for e in evs)
    fwd = readers.in_spans(t, lambda n: n == readers.FORWARD)
    assert names(fwd) == ['conv_fwd']
    assert names(readers.in_spans(t, lambda n: n.startswith(readers.BACKWARD))) == ['conv_bwd']
    assert names(readers.in_spans(t, lambda n: n.startswith(readers.OPTIMIZER))) == ['sgd']
    assert cells.metric_reader('loss_ms.train').read(t, ctx) == pytest.approx(0.002)
    assert cells.metric_reader('forward_ms.train').read(t, ctx) == pytest.approx(0.010)
    assert cells.metric_reader('backward_ms.train').read(t, ctx) == pytest.approx(0.020)
    assert cells.metric_reader('launches_per_step.train').read(t, ctx) == 4


def test_a_kernel_without_its_runtime_call_falls_back_to_the_linked_operator():
    s = Slice()
    s.op('bench.forward', 10, 200)
    s.events.append(Event('aten::conv', 'op', 20, 30, MAIN, corr=7))
    s.events.append(Event('conv_fwd', 'kernel', 40, 50, 0, corr=999, link=7))
    t = s.trace()
    assert [e.name for e in readers.in_spans(t, lambda n: n == readers.FORWARD)] == ['conv_fwd']


def test_postprocess_is_what_a_call_launches_after_its_forward():
    s = Slice()
    for c0 in (0, 500):
        s.op('bench.call', c0, c0 + 400)
        s.op('bench.forward', c0 + 10, c0 + 200)
        s.kernel('net', c0 + 20, c0 + 30, c0 + 50)
        s.kernel('suppression_kernel', c0 + 250, c0 + 260, c0 + 263)
        s.kernel('Memcpy DtoH', c0 + 300, c0 + 310, c0 + 311, kind='memcpy')
    t = s.trace()
    got = cells.metric_reader('postprocess_ms.detect').read(t, {'calls': 2})
    assert got == pytest.approx(0.003)


def test_rooflines_take_each_launch_at_its_stage_and_block():
    s = Slice()
    ctx = {'calls': 1, 'stages': [dict(windows=10, n_win=5, heads=3, c=96, rows=490),
                                  dict(windows=4, n_win=2, heads=6, c=192, rows=196)]}
    s.op('bench.stage0', 0, 100)
    s.op('bench.stage1', 100, 200)
    s.kernel('window_attention_bf16_kernel', 10, 10, 20)      # stage 0 block 0
    s.kernel('window_attention_bf16_kernel', 30, 30, 40)      # stage 0 block 1 (shifted)
    s.kernel('window_attention_bf16_kernel', 110, 110, 130)   # stage 1 block 0
    t = s.trace()
    events, places = readers.by_stage_block(t, r'window_attention_(bf16|f32)_kernel')
    assert sorted(places) == [(0, 0), (0, 1), (1, 0)]
    from benchmark.roofline import kernels, peaks
    bounds = [peaks.bound_s(*kernels.window_attention(10, 5, 3, 96, False)),
              peaks.bound_s(*kernels.window_attention(10, 5, 3, 96, True)),
              peaks.bound_s(*kernels.window_attention(4, 2, 6, 192, False))]
    want = 100 * sum(bounds) / 40e-6
    got = cells.metric_reader('window_attention_roofline').read(t, ctx)
    assert got == pytest.approx(want)
    assert cells.metric_reader('swin_mlp_roofline').read(t, ctx) is None
    no_swin = {'calls': 1, 'stages': None}
    assert cells.metric_reader('window_attention_roofline').read(t, no_swin) is None


def test_breakdown_names_device_groups_and_what_the_host_did_in_each_gap():
    s = Slice(0, 100)
    s.op('bench.call', 0, 100)
    s.op('aten::pin_memory', 40, 60)
    s.kernel('void cudnn::conv_fwd_kernel', 1, 0, 40)
    s.kernel('void at::native::vectorized_elementwise_kernel', 2, 60, 70)
    t = s.trace()
    br = t.breakdown()
    assert br['device_ops'] == [['convolution / gemm', pytest.approx(40e-6)],
                                ['elementwise / reduce', pytest.approx(10e-6)]]
    assert br['idle_gaps'] == [['bench.call', pytest.approx(30e-6)],
                               ['aten::pin_memory', pytest.approx(20e-6)]]
    s.op('autograd::engine::evaluate_function: AddBackward0', 72, 99, tid=BWD)
    assert s.trace().breakdown()['idle_gaps'][0] == \
        ['autograd::engine::evaluate_function: AddBackward0', pytest.approx(30e-6)]


def test_group_names_follow_the_profile_groups():
    assert group_of('mask_finalize_kernel(float const*)') == 'mask_finalize kernel'
    assert group_of('void mlp_bf16_sm90_kernel<96>') == 'swin_mlp kernel'
    assert group_of('something else') == 'other'


def test_spans_find_the_innermost_open_range():
    sp = Spans([Event('outer', 'op', 0, 100, 1), Event('inner', 'op', 10, 20, 1),
                Event('later', 'op', 30, 40, 1)])
    assert sp.holding(15, 1).name == 'inner'
    assert sp.holding(25, 1).name == 'outer'
    assert sp.holding(25, 2) is None


def test_host_annotations_mirrored_on_the_device_are_left_out():
    import torch
    from benchmark.core.trace import from_profiler

    class K:
        def __init__(self, name, dev, start, end, corr=0, link=0, tid=1):
            self._v = (name, dev, start, end, corr, link, tid)

        def name(self): return self._v[0]
        def device_type(self): return self._v[1]
        def start_ns(self): return self._v[2]
        def end_ns(self): return self._v[3]
        def correlation_id(self): return self._v[4]
        def linked_correlation_id(self): return self._v[5]
        def start_thread_id(self): return self._v[6]

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    raw = [K('bench.call', cpu, 0, 9000), K('bench.call', cuda, 100, 8000),
           K('cudaLaunchKernel', cpu, 10, 20, corr=5), K('gemm', cuda, 30, 90, corr=5)]

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return raw
    kinds = [(e.name, e.kind) for e in from_profiler(Prof)]
    assert kinds == [('bench.call', 'op'), ('cudaLaunchKernel', 'runtime'), ('gemm', 'kernel')]
