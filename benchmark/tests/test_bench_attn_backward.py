"""The reader of kernel 3's backward, `attn_backward_ms.train`, on synthetic
event lists: the kernels launched inside the autograd node of
`yolact_torch::window_attention`, nested ranges (the plain recompute's own
nodes) included, and nothing else."""
import pytest

from _util import ROOT  # noqa: F401  (the repository on the path)

from benchmark.core import cell as cells
from benchmark.core.trace import Event, Trace

MAIN, ENGINE = 1, 2
NODE = ('autograd::engine::evaluate_function: '
        'GeneratedBackwardFor_yolact_torch_window_attention_defaultBackward')


class Slice:
    def __init__(self, start, end):
        self.events = [Event('bench.slice', 'op', start, end, MAIN)]
        self.corr = 100

    def op(self, name, start, end, tid=MAIN):
        self.events.append(Event(name, 'op', start, end, tid))

    def kernel(self, name, launch, start, end, tid=MAIN):
        self.corr += 1
        self.events.append(Event('cudaLaunchKernel', 'runtime', launch, launch + 1, tid,
                                 self.corr))
        self.events.append(Event(name, 'kernel', start, end, 0, self.corr))


def _steps(node_kernels):
    """Two steps of 1000 us: the forward on MAIN launches kernel 3's forward;
    the engine's thread runs kernel 3's node, which launches
    `node_kernels` (name, duration), partly inside a nested node, then a
    gemm's node."""
    s = Slice(0, 2000)
    for c in (0, 1000):
        s.op('bench.call', c, c + 1000)
        s.op('bench.forward', c, c + 300)
        s.kernel('window_attention_bf16_kernel', c + 10, c + 10, c + 20)
        s.op(NODE, c + 400, c + 600, ENGINE)
        s.op('autograd::engine::evaluate_function: SoftmaxBackward0', c + 450, c + 500, ENGINE)
        for i, (name, dur) in enumerate(node_kernels):
            at = c + 410 + 50 * i
            s.kernel(name, at, at, at + dur, ENGINE)
        s.op('autograd::engine::evaluate_function: AddmmBackward0', c + 600, c + 700, ENGINE)
        s.kernel('sm90_gemm', c + 610, c + 610, c + 690, ENGINE)
    return Trace(s.events)


def _read(name, trace):
    return cells.metric_reader(name).read(trace, {'calls': 2, 'batch': 64})


def test_the_kernels_of_kernel_3s_node_a_step_nested_ranges_included():
    recompute = [('elementwise_kernel', 5), ('softmax_warp_backward', 7),
                 ('gemm_f32', 11)]
    t = _steps(recompute)
    assert _read('attn_backward_ms.train', t) == pytest.approx(0.023)
    assert _read('backward_ms.train', t) == pytest.approx(0.023 + 0.080)
    kernel = [('window_attention_bwd_bf16_kernel', 3), ('window_attention_bwd_bias_kernel', 1)]
    assert _read('attn_backward_ms.train', _steps(kernel)) == pytest.approx(0.004)


def test_none_where_no_node_of_kernel_3_ran():
    s = Slice(0, 100)
    s.op('bench.call', 0, 100)
    s.op('autograd::engine::evaluate_function: AddmmBackward0', 10, 90, ENGINE)
    s.kernel('sm90_gemm', 20, 20, 40, ENGINE)
    assert _read('attn_backward_ms.train', Trace(s.events)) is None
