"""The benchmark's plain reference against the program at a tiny size on
the CPU, on weights the benchmark made and handed to both; and what the
benchmark's runs and the reference may load."""
import json
import subprocess
import sys

import pytest
import torch

from _util import ROOT, small_cell

from benchmark.core import guard, traffic, weights
from benchmark.reference import ops, optim, postprocess
from benchmark.reference.losses import losses as reference_losses
from benchmark.reference.yolact import Yolact as Reference

CONFIGS = ('res50_coco', 'swin_tiny_coco')
CPU = torch.device('cpu')


def _program(cell, train):
    from benchmark.core import program
    from yolact_minimal_torch.models.yolact import Yolact
    cfg = program.config(cell, 'train' if train else 'detect')
    return cfg, Yolact(cfg, train_mode=train)


def _pair(name, train, size=64):
    cell = small_cell(f'{name}.train_b64' if train else f'{name}.detect_b16', img_size=size)
    cfg, prog = _program(cell, train)
    sd = weights.make_state_dict(cell.config['model'], train, 7, CPU)
    prog.load_state_dict(sd, strict=True)
    ref = Reference(cell.config['model'], train_mode=train)
    ref.load_state_dict(sd, strict=True)
    return cell, cfg, prog, ref, sd


@pytest.mark.parametrize('name', CONFIGS)
@pytest.mark.parametrize('train', (False, True))
def test_reference_holds_the_programs_names_and_shapes(name, train):
    cell = small_cell(f'{name}.detect_b16')
    _, prog = _program(cell, train)
    ref = Reference(cell.config['model'], train_mode=train)
    got = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    assert got == {k: tuple(v.shape) for k, v in prog.state_dict().items()}


@pytest.mark.parametrize('name', CONFIGS)
def test_reference_forward_equals_the_program_in_float32(name):
    cell, _, prog, ref, _ = _pair(name, False)
    img = traffic.images(2, 64, traffic.generator(3, CPU), CPU)
    with torch.no_grad():
        got, want = prog.eval()(img), ref.eval()(img)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


def test_reference_training_forward_equals_the_program_with_the_same_draws():
    cell, cfg, prog, ref, _ = _pair('swin_tiny_coco', True, size=128)
    img = traffic.images(2, 128, traffic.generator(3, CPU), CPU)
    got = prog.train()(img, torch.Generator().manual_seed(11))
    want = ref.train()(img, torch.Generator().manual_seed(11))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


def test_reference_postprocess_equals_the_programs():
    from yolact_minimal_torch.ops.boxes import make_anchors
    from yolact_minimal_torch.ops.mask_finalize import mask_finalize_plain
    from yolact_minimal_torch.ops.nms import detect_postprocess_batch
    cell, cfg, prog, ref, _ = _pair('res50_coco', False)
    img = traffic.images(2, 64, traffic.generator(4, CPU), CPU)
    with torch.no_grad():
        class_p, box_p, coef_p, proto = prog.eval()(img)
    anchors = postprocess.anchors(64, cfg.aspect_ratios, cfg.base_scales)
    assert torch.equal(anchors, torch.from_numpy(make_anchors(64, cfg.aspect_ratios, cfg.scales)))
    for thre, pre in ((0.002, 1024), (0.0125, 0), (0.0125, 64)):
        want = detect_postprocess_batch(class_p, box_p, coef_p, anchors, thre, 0.5, 200, 100, pre)
        got = postprocess.fast_nms(class_p, box_p, coef_p, anchors, thre, 0.5, 200, 100, pre)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        masks = mask_finalize_plain(proto, want.coefs, want.boxes, want.valid, 64)
        assert torch.equal(postprocess.mask_finalize(proto, got, 64), masks)


def _train_inputs(cell, cfg, seed=5):
    anchors = postprocess.anchors(cfg.img_size, cfg.aspect_ratios, cfg.base_scales)
    pool = traffic.train_pool(cell.traffic, 2, cfg.img_size, cfg.max_gt, cfg.num_classes,
                              len(anchors), seed, CPU)
    return anchors, pool


def test_reference_losses_equal_the_programs():
    from yolact_minimal_torch.ops.losses import compute_loss
    cell, cfg, prog, ref, _ = _pair('res50_coco', True)
    anchors, pool = _train_inputs(cell, cfg)
    b = pool[0]
    gt = {k: torch.from_numpy(b[k]) for k in ('boxes', 'labels', 'valid', 'masks_proto',
                                              'masks_seg')}
    outputs = prog.train()(torch.from_numpy(b['image']))
    want = compute_loss(cfg, outputs, gt, anchors, priorities=b['priorities'])
    got = reference_losses(cell.config['train'], outputs, gt, anchors, b['priorities'])
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('name', CONFIGS)
def test_reference_optimizer_and_schedule_equal_the_programs(name):
    from yolact_minimal_torch.train_state import lr_schedule, make_optimizer
    cell, cfg, prog, ref, _ = _pair(name, True)
    sched = lr_schedule(cfg)
    for step in (0, 1, 250, 499, 500, 501, 40000):
        assert optim.lr_at(cell.config['train'], cfg.train_bs, step) == \
            pytest.approx(sched(step), rel=1e-6)
    params = [torch.nn.Parameter(torch.randn(5, 3, generator=torch.Generator().manual_seed(i)))
              for i in range(2)]
    twins = [torch.nn.Parameter(p.detach().clone()) for p in params]
    theirs = make_optimizer(cfg, torch.nn.ParameterList(params))
    ours = optim.Optimizer(cell.config['train'], twins)
    for step in range(3):
        g = torch.Generator().manual_seed(100 + step)
        for p, q in zip(params, twins):
            p.grad = torch.randn(p.shape, generator=g)
            q.grad = p.grad.clone()
        lr = sched(step)
        for group in theirs.param_groups:
            group['lr'] = lr
        theirs.step()
        ours.step(lr)
    for p, q in zip(params, twins):
        torch.testing.assert_close(q, p, rtol=1e-6, atol=1e-7)


def test_the_train_comparison_reads_nought_for_the_program_on_the_cpu():
    """The whole train entry (program steps, reference steps, comparison) at
    a size where float32 rounding does not grow: swin at 128."""
    from benchmark.entries import train
    cell = small_cell('swin_tiny_coco.train_b64', img_size=128)
    session = train.setup(cell, 2 ** 33 + 5, CPU)
    session.release()
    values = session.judge()
    assert values['loss_gap'] < 1e-5 and values['grad_gap'] < 1e-5, values
    assert values['update_gap'] < 1e-3, values


def test_lower_precision_rounds_every_product_and_its_gradient():
    x = torch.linspace(-3, 3, 97, requires_grad=True)
    w = torch.ones(97, 1)
    with ops.lower_precision():
        y = ops.matmul(x[None], w)
    assert not torch.equal(y, x[None] @ w)
    y.backward(torch.full_like(y, 0.3))
    assert x.grad.unique().numel() == 1 and float(x.grad[0]) != 0.3  # e5m2-rounded


def test_guard_compares_whole_top_level_names():
    names = ['yolact_minimal_torch', 'yolact_minimal_torch.ops', 'jaxtyping', 'flaxen.x']
    assert guard.forbidden_loaded(names) == []
    assert guard.forbidden_loaded(names + ['jax.numpy', 'yolact_minimal_tpu.models']) == \
        ['jax', 'yolact_minimal_tpu']


def _loaded_after(code: str):
    out = subprocess.run([sys.executable, '-c', code + '\nimport sys, json\n'
                          'print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))'],
                         cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env={'PATH': '/usr/bin:/bin', 'JAX_PLATFORMS': 'cpu',
                              'HOME': str(ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_of_each_entry_loads_no_jax():
    tops = _loaded_after(
        'import sys; sys.path.insert(0, "benchmark/tests")\n'
        'import torch, time\n'
        'from _util import small_cell\n'
        'from benchmark.core.run import run_cell\n'
        'import benchmark.run, benchmark.calibrate\n'
        'for name in ("res50_coco.detect_b16", "swin_tiny_coco.train_b64"):\n'
        '    cell = small_cell(name, img_size=64 if "detect" in name else 128)\n'
        '    run_cell(cell, 3, 0.2, True, torch.device("cpu"), (time.perf_counter(), 0.0))\n')
    assert 'yolact_minimal_torch' in tops
    assert not tops & set(guard.FORBIDDEN)


def test_the_reference_and_the_counters_load_nothing_of_the_program():
    tops = _loaded_after(
        'import benchmark.reference.yolact, benchmark.reference.losses\n'
        'import benchmark.reference.optim, benchmark.reference.postprocess\n'
        'import benchmark.roofline.flops, benchmark.roofline.kernels, benchmark.core.trace\n'
        'import benchmark.core.readers, benchmark.core.weights, benchmark.core.traffic\n')
    assert 'torch' in tops
    assert not tops & (set(guard.FORBIDDEN) | {'yolact_minimal_torch'})


def test_run_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a card is present: this test is of the CPU-only case')
    out = subprocess.run([sys.executable, 'benchmark/run.py', '--workload',
                          'res50_coco.detect_b16', '--seed', str(2 ** 31 + 9), '--seconds', '1',
                          '--trace', '0'], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
