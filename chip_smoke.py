#!/usr/bin/env python
"""Drive the PyTorch/CUDA port (yolact_minimal_torch) on one NVIDIA card.

    python3 chip_smoke.py

Two jobs. The kernel table: each hand-written kernel timed alone at the main
paths' shapes. And the card runs that no card test makes: the CLIs as a user
runs them, the eval and export paths, the float32 network against the CPU's,
the 'mixed' training forms and the data-parallel worlds. Whole-path rates are
the benchmark's (benchmark/run.py); the holds tests/test_torch_cuda.py makes
are its own. Phases, in order; any failure exits nonzero:
  1. the card's name and power limit, torch's CUDA version, nvcc's version,
     whether triton, cv2 and PIL import;
  2. build the CUDA kernels from yolact_minimal_torch/csrc/ (nvcc, sm_90a,
     one process per source, started together);
  3. the kernel table at 544, batch 16 (the swin kernels in bf16, at the
     shapes of benchmark/configs/, regions shifted): every timed call is held once
     to its plain version on the timed inputs (`_held`), then timed with CUDA
     events (median of 20 after warm-up) and in device time (torch.profiler),
     beside the plain version's times, the bound of benchmark/roofline/ and
     the launch geometry; kernels 3-6 are held, not timed, also in float32
     and without the shift at the same shapes. Kernel 1 on (a), a fixture with invalid slots and
     zero-area boxes (and a composition of PyTorch calls), and (b), all
     valid; kernel 2 on (a), a fixture with crop (and a composition), (b), the
     same without, and (c), a res50_coco slate; kernels 3-6 at swin_tiny_coco's
     four stages, kernel 3 beside SDPA, kernel 4 beside a composition, kernel
     5 beside cuBLAS qkv + kernel 3 + cuBLAS proj, kernel 6 beside the block
     as PyTorch calls; kernels 3 (144 tokens) and 4 at swin_large_coco's four
     stages; the attention half's two glue kernels (to_windows,
     from_windows) at both configs' four stage maps, beside their plain
     versions (the PyTorch compositions they replace), with a byte bound
     counted here; kernel 3's backward kernel at swin_tiny_coco's stages at
     batches 8 and 64, beside the plain recompute. Kernel 4's wide form and
     kernel 6 at C = 768 also by launch, in device time. Then the main
     paths, one Detector.detect_fixed call each after a warm-up, seeded:
     res50_coco and swin_tiny_coco (each block form) in bf16 at batch 16,
     swin_large_coco in bf16 at 16 and float32 at 2; each launches kernels 1
     and 2 once and every block its form's kernels, and fills the slate;
  4. the detect CLI on two seeded PNGs with a seeded res50_coco .pth, cv2
     hidden: both drawn images at their input shapes, kernel 1 once an image;
  5. the eval CLI on seeded res50_custom and res101_custom .ckpt files over
     custom_dataset/ at 544 (finite box and mask rows), res50_custom once more
     with --coco_api (both jsons, 24 COCO stats); then evaluate() in this
     process, the planes kernel 1 got on each batch held exactly to its plain
     version, batch 0 timed as kernel 1's input (c);
  6. one image, float32 with TF32 off, res50_coco and swin_tiny_coco in each
     block form ('composed', 'attn_block', 'whole', 'mixed'): the card's
     network outputs against the CPU's (the forms' kernels launched, and
     against the composed form's on the card), the card's slate and masks
     against the CPU's on the same head outputs, and a bf16 Detector's
     network and sorted slate scores against the float32 run;
  7. training: swin_tiny_coco at 544, train_bs 8 in the 'mixed' forms (two
     bf16 steps launching kernels 6 / 5 / 3 / 4 1 / 2 / 9 / 0 times a step
     and kernel 3's backward kernel 9 times; one float32 step against the
     'composed' step from the same init: first losses within 1e-4); the
     train CLI on res50_custom at 256 for 220 steps with a validation at
     step 200 (the logged loss falls, both checkpoints written);
  8. export and video: the export CLI on a seeded res50_coco .ckpt prints
     its parity line, the driver draws two seeded PNGs at their shapes; an
     11-frame mp4 through `detect --video --video_bs 4` and the driver's
     `--video`, each writing 11 frames at the clip's size;
  9. the flags: the eval CLI with --traditional_nms; the detect CLI with
     --traditional_nms --save_lincomb (kernel 1 not launched, the grids
     written); the train CLI with --backbone_weight and --remat;
  10. data parallelism: a world of two gloo processes on cuda:0
     (`chip_smoke.py --dp-worker`) against the one-process step on the same
     global batch (res50_coco float32 and float64, swin_tiny_coco bf16); the
     train CLI in a one-process nccl world; the eval CLI with
     --data_parallel 1 (the plain eval table row for row) and 2 (refused).
Each phase prints its seconds. The line before the last is the kernel table
as a JSON object {"kernels": [...]}, a row a kernel with its measurements by
input or stage (`inputs`, `per_stage`; the top level repeats the first, or
for swin_mlp_wide C = 768), its `launches` on its own path and
`launches_by_path` (the main paths, the detect CLI and the 'mixed' bf16
training steps; ROW_LAUNCHES); the last is {"ok": true, "device": {...}}. Needs
no JAX, flax or cv2.
"""
import contextlib
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

from benchmark.roofline import kernels as roofline
from benchmark.roofline import peaks, windows

ROOT = os.path.dirname(os.path.abspath(__file__))
IMG, BATCH, SLOTS = 544, 16, 100
SCORE_THRE = 0.002      # below the ~1/81 random-init scores: the slate fills
# Float32 card-vs-CPU limits for phase 6: convolutions sum in another order
# (no TF32), so each network output is held to 1e-4 of its largest
# magnitude; postprocess on identical inputs differs only by libm ulps.
NET_REL_TOL = 1e-4
POST_ATOL = 1e-6
MASK_MISMATCH = 1e-4
# bf16 against float32 on the card: each network output within 5e-2 of its
# largest magnitude (bf16 keeps 8 mantissa bits through ~60 layers) and not
# equal to it (the network did run in bf16). Slates are compared by their
# sorted scores: random-init scores are near-ties, so the ids reorder.
BF16_REL_TOL = 5e-2
BF16_SCORE_RTOL = 5e-2
# The swin kernels against their plain versions, as a share of the plain
# output's largest magnitude. float32: both sum up to 6144 products, in
# another order. bf16: both round at the same places, so a difference is a
# float32 value that rounds to the other bf16 neighbour, at most one ulp
# (2^-7 of the magnitude).
SWIN_F32_REL_TOL = 1e-5
SWIN_BF16_REL_TOL = 2.0 ** -7
# The yardsticks made of PyTorch's own calls (SDPA, the compositions) round
# at other places than the plain versions: held to 5e-2 of max |plain|, which
# says they compute the same function, not how closely.
YARDSTICK_REL_TOL = 5e-2
# Kernel 3's backward kernel against the plain recompute it replaced, at the
# training shapes of batch 8 and of the benchmark's swin_tiny_coco.train_b64
# cell: each of dq, dk, dv and d_bias within 5e-4 in relative L2 (both round
# at the same places: the kernel reads under 1.4e-4, a backward that rounds
# dS to bf16 ~2.6e-3, tests/test_torch_window_attention_backward.py).
WA_BACKWARD_BATCHES = (8, 64)
WA_BACKWARD_GAP = 5e-4
# The eval phase: the configs the eval CLI runs at IMG on custom_dataset/ (48
# images, cfg.val_bs 8).
EVAL_CONFIGS = ('res50_custom', 'res101_custom')
EVAL_BS = 8
# The swin kernels each block form launches, once per block and forward, and
# the swin paths: the form of each stage's blocks. 'mixed' is the whole-block
# kernel at stage 0, the attention half-block kernel at stage 1 and the
# composed form after: the path that drives kernels 5 and 6 in one forward.
SWIN_KERNELS = ('window_attention', 'swin_mlp', 'attn_block', 'swin_block', 'to_windows',
                'from_windows')
SWIN_FORM_LAUNCHES = {'composed': ('window_attention', 'swin_mlp', 'to_windows', 'from_windows'),
                      'attn_block': ('attn_block', 'swin_mlp'),
                      'whole': ('swin_block',)}
SWIN_PATHS = {'composed': ('composed',) * 4, 'attn_block': ('attn_block',) * 4,
              'whole': ('whole',) * 4,
              'mixed': ('whole', 'attn_block', 'composed', 'composed')}
# Float32 network outputs of two block forms on the card: the same function
# up to summation order, each output within 1e-4 of its largest magnitude.
FORM_REL_TOL = 1e-4
# Training: train_bs, the batches phase 7 and phase 10 take from the loader,
# its worker processes, and the train CLI's image size, steps and validation
# step. In a swin_tiny_coco training step kernel 3 runs in all 12 blocks and
# its backward kernel once a launch (bf16), kernel 4 only where stochastic
# depth is off (block 0 of stage 0). The 'mixed' forms, as the JAX block
# routes them: stage 0 'whole' runs kernel 6 in block 0 (rate 0) and falls
# back to kernel 3 and the plain MLP in block 1; stage 1 'attn_block' runs
# kernel 5 in both blocks; stages 2-3 'composed' run kernel 3 in their 8
# blocks; kernel 4 nowhere (every block after block 0 has a nonzero
# drop_path rate).
TRAIN_BS = 8
TRAIN_BATCHES = 2
TRAIN_WORKERS = 6
TRAIN_CLI_IMG, TRAIN_CLI_STEPS, TRAIN_CLI_VAL = 256, 220, 200
TRAIN_LAUNCHES_PER_STEP = {'window_attention': 12, 'swin_mlp': 1,
                           'window_attention_backward': 12}
MIXED_TRAIN_LAUNCHES_PER_STEP = {'swin_block': 1, 'attn_block': 2, 'window_attention': 9,
                                 'swin_mlp': 0, 'window_attention_backward': 9}
# The seeded clip: frames (not a multiple of the video batch), the detect
# CLI's video batch, width x height.
VIDEO_FRAMES, VIDEO_BS, VIDEO_SIZE = 11, 4, (640, 480)
# The train CLI's runs with --backbone_weight and --remat and in an nccl
# world: image size and steps (the log prints its losses at step 10, so 11
# steps show one line). The eval CLI's images with --traditional_nms: with
# random weights every anchor passes the score threshold for each of
# res50_custom's 4 classes, so greedy NMS takes ~1.7 s an image on the host.
FLAGS_CLI_IMG, FLAGS_CLI_STEPS = 256, 11
FLAGS_EVAL_IMAGES = 2 * EVAL_BS


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _time_ms(fn, warmup=3, iters=20):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms_by_kernel(fn, patterns, iters=20):
    """Device ms of one call of fn by CUDA kernel name, under torch.profiler
    over `iters` calls: {name: ms} for each pattern of `patterns` (name ->
    regex, first match wins). Unlike _time_ms it leaves out the host's launch
    overhead, which sets a floor under a small kernel's event time. The
    profiler can lose a trace's kernel events: a trace in which a pattern
    matches nothing is taken again, up to four times."""
    import torch
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ms = dict.fromkeys(patterns, 0.0)
        for e in prof.key_averages():
            name = next((n for n, pat in patterns.items() if re.search(pat, e.key)), None)
            if e.device_type == torch.autograd.DeviceType.CUDA and name is not None:
                ms[name] += e.self_device_time_total / iters / 1e3
        if all(ms.values()):
            return ms
    raise AssertionError(f'torch.profiler recorded no kernel of {patterns}: {ms}')


def _device_ms(fn, iters=20):
    """Device ms of one call of fn: all the CUDA kernels it launches."""
    return _device_ms_by_kernel(fn, {'all': ''}, iters)['all']


def _bound(n_bytes, n_flops, peak=peaks.BF16_FLOPS):
    """The least ms the card could take (benchmark/roofline/peaks.py), and
    whether the bytes or the operations set it."""
    by = 'bytes' if peaks.bound_s(n_bytes, 0) >= peaks.bound_s(0, n_flops, peak) else 'operations'
    return peaks.bound_s(n_bytes, n_flops, peak) * 1e3, by


def _rel_gap(got, ref):
    """max |got - ref| over max |ref|, in float32; infinite where the dtypes
    or shapes differ (a NaN reads NaN, which no limit holds)."""
    if got.dtype != ref.dtype or got.shape != ref.shape:
        return math.inf
    got, ref = got.float(), ref.float()
    return ((got - ref).abs().max() / ref.abs().max()).item()


def _exact_gap(got, ref):
    """max |got - ref| where ref is a number; infinite where the NaN
    positions differ."""
    import torch
    nan = torch.isnan(ref)
    if got.shape != ref.shape or not torch.equal(torch.isnan(got), nan):
        return math.inf
    return (got[~nan] - ref[~nan]).abs().max().item() if (~nan).any() else 0.0


def _mismatch(got, ref):
    """The share of the bool mask pixels that differ."""
    return (got != ref).float().mean().item() if got.shape == ref.shape else math.inf


def _backward_gap(got, ref):
    """The largest relative L2 gap of dq, dk, dv and d_bias."""
    (d_qkv, d_bias), (r_qkv, r_bias) = got, ref
    pairs = list(zip(d_qkv.chunk(3, -1), r_qkv.chunk(3, -1))) + [(d_bias, r_bias)]
    return max(((a.float() - b.float()).norm() / b.float().norm()).item() for a, b in pairs)


def _hold(what, call, plain, gap, limit):
    """call() against plain() on the same inputs, gap(got, ref) held to
    `limit`. Returns the gap."""
    import torch
    got = call()
    torch.cuda.synchronize()
    measured = gap(got, plain())
    _check(measured <= limit, f'{what}: {measured:.3g} from the plain version (limit {limit:.3g})')
    return measured


def _held(what, call, plain, gap, limit):
    """The one path by which the table times a call: `_hold`, then `call`
    timed with CUDA events and in device time. So no row can time a call
    that computes something else. Returns (gap, ms, device ms)."""
    return _hold(what, call, plain, gap, limit), _time_ms(call), _device_ms(call)


def _forms(kernel, plain, forms):
    """The untimed holds of `_measure`: (name, call, plain call, limit) of
    `kernel` and `plain` on the args of each (name, args, limit) of `forms`."""
    return [(name, lambda a=args: kernel(*a), lambda a=args: plain(*a), limit)
            for name, args, limit in forms]


def _measure(what, call, plain, gap, limit, cost, peak=peaks.BF16_FLOPS, yardsticks=(),
             holds=(), **fields):
    """One measurement of the table: each of `holds` (name, call, plain,
    limit: the kernel's other dtypes and masks at the same shape) held to its
    plain version by `_rel_gap` and not timed, `call` held to `plain` and
    timed (`_held`), the plain version timed, `cost` (bytes, operations) as a
    bound, and each yardstick (name, call, reference or None for `plain`,
    gap, limit) held to its reference and timed the same way. Prints the
    numbers and returns them, after `fields`."""
    m = dict(fields, limit=limit)
    if holds:
        m['holds'] = {name: _hold(f'{what}, {name}', hcall, hplain, _rel_gap, hlimit)
                      for name, hcall, hplain, hlimit in holds}
    m['gap'], m['ms'], m['device_ms'] = _held(what, call, plain, gap, limit)
    m['plain_ms'], m['plain_device_ms'] = _time_ms(plain, warmup=1, iters=5), _device_ms(plain, 5)
    m['bound_ms'], m['bound_by'] = _bound(*cost, peak)
    line = (f'{what}: {m["ms"]:.4f} ms, device {m["device_ms"]:.4f}, bound {m["bound_ms"]:.5f} '
            f'({m["bound_by"]}; {m["bound_ms"] / m["device_ms"]:.1%} of the device time); plain '
            f'{m["plain_ms"]:.4f}, device {m["plain_device_ms"]:.4f}; gap {m["gap"]:.3g} '
            f'(<= {limit:.3g})')
    for name, ycall, ref, ygap, ylimit in yardsticks:
        got = _held(f'{what}, {name}', ycall, ref or plain, ygap, ylimit)
        m[f'{name}_gap'], m[f'{name}_ms'], m[f'{name}_device_ms'] = got
        line += f'; {name} {got[1]:.4f} ms, device {got[2]:.4f}, gap {got[0]:.3g}'
    if holds:
        line += '; held, not timed: ' + ', '.join(
            f'{name} {m["holds"][name]:.3g} (<= {hlimit:.3g})' for name, _, _, hlimit in holds)
    print(line)
    return m


def _row(name, source, replaces, agreement, measured, top=0):
    """A swin kernel's entry in the kernels line: its measurements by stage,
    those of stage `top` also at the top level. `replaces` None: no TPU
    kernel (XLA fuses that work in the JAX package)."""
    replaces = 'none: XLA fuses it' if replaces is None else f'yolact_minimal_tpu/ops/{replaces}'
    return dict(name=name, source=f'yolact_minimal_torch/csrc/{source}', replaces=replaces,
                agreement=agreement,
                **measured[top], peak=peaks.BF16_FLOPS, per_stage=measured)


def _stages(config, batch=BATCH):
    """The swin stages of benchmark/configs/{config}.json at IMG and `batch`,
    as benchmark/roofline/kernels.py::swin_stages lays them out (side, padded
    side, windows of an image `n_win` and of the batch `windows`, heads, C,
    MLP rows, depth), with the window and its tokens."""
    with open(os.path.join(ROOT, 'benchmark', 'configs', f'{config}.json')) as f:
        model = json.load(f)['model']
    stages = roofline.swin_stages(model, batch, IMG)
    for s in stages:
        s.update(window=model['backbone']['window'], tokens=windows.stage_tokens(s))
    return stages


def _regions(dev, s):
    """The region ids of stage `s`'s shifted windows on its padded map."""
    import torch
    from yolact_minimal_torch.models.swin import shifted_window_regions
    return torch.from_numpy(shifted_window_regions(s['padded'], s['padded'], s['window'],
                                                   s['window'] // 2)).to(dev)


def _sms(dev):
    import torch
    return torch.cuda.get_device_properties(dev).multi_processor_count


def phase_env():
    import torch
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0])
    print(f'torch {torch.__version__}, torch.version.cuda {torch.version.cuda}')
    from yolact_minimal_torch.ops import _build
    nvcc = subprocess.run([_build.nvcc_path(), '--version'], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print('nvcc:', nvcc.splitlines()[-1])
    try:
        import triton
        print(f'triton {triton.__version__} imports')
    except ImportError as e:
        print(f'triton does not import: {e}')
    # found without importing them: the detect CLI runs with cv2 hidden
    import importlib.metadata
    import importlib.util
    dists = importlib.metadata.packages_distributions()
    libs = []
    for name in ('cv2', 'PIL'):
        if importlib.util.find_spec(name) is None:
            libs.append(f'{name} is not installed')
        else:
            versions = ', '.join(f'{d} {importlib.metadata.version(d)}'
                                 for d in sorted(set(dists.get(name, ()))))
            libs.append(f'{name} is installed ({versions or "no distribution record"})')
    print(f'image libraries: {"; ".join(libs)}')
    return smi.splitlines()[0]


def phase_build():
    from yolact_minimal_torch.ops import _build
    t0 = time.perf_counter()
    libs = _build.build(['suppression', 'mask_finalize', 'window_attention', 'swin_mlp',
                         'attn_block', 'swin_block', 'swin_glue'])
    print(f'built {sorted(libs)} in {time.perf_counter() - t0:.2f} s')


# --- phase 3: the kernel table ------------------------------------------------------

def _suppression_inputs(dev, all_valid):
    """Kernel 1's inputs at [B*C, K] = [1280, 200]: (a) the fixture, boxes
    0-0.4 wide, 5 % of them zero-area (0/0 pairs), 20 % of the slots and every
    seventh row invalid; (b) all valid, as the res50 path's rows are (with
    >= 200 anchors above the threshold every class row is full)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(0)
    rows, k = BATCH * 80, 200
    xy = torch.rand(2, rows, k, device=dev, generator=g) * 0.8
    wh = torch.rand(2, rows, k, device=dev, generator=g) * 0.4
    x1, y1 = xy[0].contiguous(), xy[1].contiguous()
    x2, y2 = (x1 + wh[0]).clamp(max=1.0), (y1 + wh[1]).clamp(max=1.0)
    flat = torch.rand(rows, k, device=dev, generator=g) < 0.05
    valid = torch.rand(rows, k, device=dev, generator=g) > 0.2
    if all_valid:
        return x1, y1, x2, y2, torch.ones_like(valid)
    for t in (x1, y1, x2, y2):
        t[flat] = 1.0                    # clipped fully off-image: 0/0 pairs
    valid[::7] = False                   # whole rows without candidates
    return x1, y1, x2, y2, valid


def _suppression_composition(x1, y1, x2, y2, valid):
    """Kernel 1's function as PyTorch calls on the planes: pairwise IoU by
    broadcasting, invalid pairs 0, the strict upper triangle, amax over the
    higher-scored axis. The same arithmetic in the same order as the plain
    version (box_iou on stacked boxes), so held to it exactly."""
    import torch
    lo = lambda a: a[:, :, None]
    hi = lambda a: a[:, None, :]
    iw = (torch.minimum(lo(x2), hi(x2)) - torch.maximum(lo(x1), hi(x1))).clamp(min=0.0)
    ih = (torch.minimum(lo(y2), hi(y2)) - torch.maximum(lo(y1), hi(y1))).clamp(min=0.0)
    inter = iw * ih
    area = (x2 - x1) * (y2 - y1)
    iou = inter / (lo(area) + hi(area) - inter)
    iou = iou.masked_fill(~(lo(valid) & hi(valid)), 0.0).triu(diagonal=1)
    return iou.amax(dim=1)


def _measure_suppression(what, args, composition=False):
    """Kernel 1 on the planes `args`: exact against its plain version, NaN
    positions equal; the bound from the valid pairs j < i of each row, ~12
    float32 operations each."""
    import torch
    from yolact_minimal_torch.ops.suppression import (suppression_iou_max,
                                                      suppression_iou_max_plain)
    rows, k = args[0].shape
    n = args[4].to(torch.int64).sum(1)
    pairs = (n * (n - 1) // 2).sum().item()
    yardsticks = [('composition', lambda: _suppression_composition(*args), None, _exact_gap,
                   0.0)] if composition else []
    return _measure(f'kernel suppression_iou_max [{rows}, {k}] {what}',
                    lambda: suppression_iou_max(*args), lambda: suppression_iou_max_plain(*args),
                    _exact_gap, 0.0, (rows * k * (4 * 4 + 1 + 4), pairs * 12),
                    peaks.FLOAT32_FLOPS, yardsticks, shape=[rows, k], pairs=pairs)


def table_suppression(dev):
    """Kernel 1 at [B*C, K] = [1280, 200] on inputs (a), beside a composition
    of PyTorch calls (`_suppression_composition`), and (b); phase 5 adds
    input (c), the planes the eval path gave the kernel."""
    import torch
    from yolact_minimal_torch.ops.suppression import kernel_geometry, suppression_iou_max_plain
    a, b = _suppression_inputs(dev, False), _suppression_inputs(dev, True)
    _check(torch.isnan(suppression_iou_max_plain(*a)).any().item(),
           'kernel 1 fixture has no NaN pair')
    inputs = {'a_fixture': _measure_suppression('(a) fixture', a, composition=True),
              'b_all_valid': _measure_suppression('(b) all valid', b)}
    geo = kernel_geometry(*inputs['a_fixture']['shape'], dev.index or 0)
    print(f'  geometry: {json.dumps(geo)}')
    return dict(name='suppression_iou_max', source='yolact_minimal_torch/csrc/suppression.cu',
                replaces='yolact_minimal_tpu/ops/pallas_nms.py:67',
                agreement='exact, NaN positions equal', **inputs['a_fixture'],
                peak=peaks.FLOAT32_FLOPS, geometry=geo, inputs=inputs)


def _mask_fixture(dev):
    """Kernel 2's fixture: B=16, D=100, proto 136x136x32, boxes 0.1-0.4
    wide, 30 % of the slots invalid."""
    import torch
    g = torch.Generator(device=dev).manual_seed(1)
    ph = IMG // 4
    proto = torch.randn(BATCH, ph, ph, 32, device=dev, generator=g)
    coefs = torch.tanh(torch.randn(BATCH, SLOTS, 32, device=dev, generator=g))
    xy = torch.rand(BATCH, SLOTS, 2, device=dev, generator=g) * 0.6
    wh = 0.1 + torch.rand(BATCH, SLOTS, 2, device=dev, generator=g) * 0.3
    boxes = torch.cat([xy, (xy + wh).clamp(max=1.0)], dim=-1).contiguous()
    valid = torch.rand(BATCH, SLOTS, device=dev, generator=g) > 0.3
    return proto, coefs, boxes, valid


def _res50_slate(dev):
    """Kernel 2's inputs on a res50_coco slate: proto, coefs, boxes and valid
    of one bf16 detect call at 544, batch 16, seeded weights and images."""
    import torch
    from yolact_minimal_torch.config import get_config
    from yolact_minimal_torch.pipeline import Detector
    cfg = get_config('res50_coco', img_size=IMG, nms_score_thre=SCORE_THRE,
                     compute_dtype='bfloat16')
    det = Detector(cfg, device=dev, seed=0)
    images = torch.randn(BATCH, IMG, IMG, 3, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(2))
    with torch.inference_mode():
        dets, proto = det._infer(images)
    _check(bool(dets.valid.all()), 'the res50_coco slate did not fill')
    return proto, dets.coefs.contiguous(), dets.boxes.contiguous(), dets.valid.contiguous()


def _mask_composition(proto, coefs, boxes, valid, out_size):
    """Kernel 2's function (with crop) as PyTorch calls: bmm, sigmoid, the
    box crop and validity as one mask, F.interpolate (bilinear,
    align_corners=False), > 0.5. The plain version takes a broadcast matmul
    and the port's own bilinear resize, so the two may differ where a value
    sits at 0.5: held to the mismatch fraction the kernel is held to."""
    import torch
    import torch.nn.functional as F
    from yolact_minimal_torch.ops.boxes import sanitize_coordinates
    b, ph, pw, c = proto.shape
    masks = torch.sigmoid(torch.bmm(coefs, proto.reshape(b, ph * pw, c).transpose(1, 2)))
    x1, x2 = sanitize_coordinates(boxes[..., 0], boxes[..., 2], pw, 1)
    y1, y2 = sanitize_coordinates(boxes[..., 1], boxes[..., 3], ph, 1)
    cols = torch.arange(pw, dtype=torch.float32, device=proto.device)
    rows = torch.arange(ph, dtype=torch.float32, device=proto.device)[:, None]
    box = lambda t: t[..., None, None]
    keep = (cols >= box(x1)) & (cols < box(x2)) & (rows >= box(y1)) & (rows < box(y2)) & \
        box(valid)
    masks = masks.reshape(b, -1, ph, pw) * keep
    return F.interpolate(masks, size=(out_size, out_size), mode='bilinear',
                         align_corners=False) > 0.5


def table_mask_finalize(dev):
    """Kernel 2 at B=16, D=100, proto 136x136x32 -> 544x544 on (a), the
    fixture with crop, beside a composition of PyTorch calls
    (`_mask_composition`), (b), the same without crop, and (c), a res50_coco
    slate with crop; each within MASK_MISMATCH of the plain version."""
    from yolact_minimal_torch.ops.mask_finalize import (_tables, kernel_geometry, mask_finalize,
                                                        mask_finalize_plain)
    fixture, slate = _mask_fixture(dev), _res50_slate(dev)
    inputs = {}
    for key, args, crop in (('a_crop', fixture, True), ('b_no_crop', fixture, False),
                            ('c_path', slate, True)):
        proto, coefs, _, valid = args
        b, ph, pw, nc = proto.shape
        cost = roofline.mask_finalize(b, coefs.shape[1], ph, pw, nc, IMG)
        yardsticks = [('composition', lambda: _mask_composition(*args, IMG), None, _mismatch,
                       MASK_MISMATCH)] if key == 'a_crop' else []
        inputs[key] = _measure(f'kernel mask_finalize [{BATCH}, {SLOTS}, {IMG}, {IMG}] {key}',
                               lambda: mask_finalize(*args, IMG, crop),
                               lambda: mask_finalize_plain(*args, IMG, crop), _mismatch,
                               MASK_MISMATCH, cost, peaks.FLOAT32_FLOPS, yardsticks,
                               valid_slots=int(valid.sum()))
    ph = fixture[0].shape[1]
    geo = kernel_geometry(BATCH * SLOTS, IMG, 32, _tables(ph, ph, IMG, dev)[1], ph,
                          dev.index or 0)
    print(f'  geometry: {json.dumps(geo)}')
    return dict(name='mask_finalize', source='yolact_minimal_torch/csrc/mask_finalize.cu',
                replaces='yolact_minimal_tpu/ops/pallas_masks.py:160',
                agreement=f'mismatch fraction < {MASK_MISMATCH}', **inputs['a_crop'],
                peak=peaks.FLOAT32_FLOPS, geometry=geo, inputs=inputs)


def table_window_attention(dev, config):
    """Kernel 3 at `config`'s four stage shapes (49 or 144 tokens), beside
    one F.scaled_dot_product_attention call on the same q, k, v with the bias
    and the region mask folded into attn_mask; held also in float32, shifted
    and unshifted, and in bf16 unshifted."""
    import torch
    import torch.nn.functional as F
    from yolact_minimal_torch.ops.window_attention import (NEG, kernel_attributes,
                                                           kernel_geometry, wide_geometry,
                                                           window_attention,
                                                           window_attention_plain)
    g = torch.Generator(device=dev).manual_seed(3)
    per_stage = []
    for i, s in enumerate(_stages(config)):
        bnw, nw, c, heads, n = s['windows'], s['n_win'], s['c'], s['heads'], s['tokens']
        region = _regions(dev, s)
        qkv32 = torch.randn(bnw, n, 3 * c, device=dev, generator=g)
        bias32 = torch.randn(heads, n, n, device=dev, generator=g) * 0.1
        qkv, bias = qkv32.bfloat16(), bias32.bfloat16()
        q, k, v = qkv.view(bnw, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
        fill = torch.where(region[:, :, None] != region[:, None, :], NEG, 0.0)
        mask = (bias.float()[None] + fill[:, None]).bfloat16().repeat(bnw // nw, 1, 1, 1)
        sdpa = ('sdpa', lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask), None,
                lambda got, ref: _rel_gap(got.transpose(1, 2).reshape(ref.shape), ref),
                YARDSTICK_REL_TOL)
        wide = n != 49
        geo = (wide_geometry if wide else kernel_geometry)(bnw, heads, _sms(dev))
        per_stage.append(_measure(
            f'kernel window_attention stage {i} qkv [{bnw}, {n}, {3 * c}] heads {heads}',
            lambda: window_attention(qkv, bias, region, heads),
            lambda: window_attention_plain(qkv, bias, region, heads), _rel_gap,
            SWIN_BF16_REL_TOL, windows.window_attention(bnw, nw, heads, c, True, n),
            yardsticks=[sdpa], shape=[bnw, n, 3 * c], heads=heads,
            holds=_forms(window_attention, window_attention_plain, [
                ('float32 unshifted', (qkv32, bias32, None, heads), SWIN_F32_REL_TOL),
                ('float32 shifted', (qkv32, bias32, region, heads), SWIN_F32_REL_TOL),
                ('bf16 unshifted', (qkv, bias, None, heads), SWIN_BF16_REL_TOL)]),
            geometry=dict(dataclasses.asdict(geo), **kernel_attributes(wide=wide))))
        del qkv, bias, qkv32, bias32, q, k, v, mask
        torch.cuda.empty_cache()
    return per_stage


def _mlp_params(dev, g, c):
    """Kernel 4's float32 LayerNorm and Linear parameters at width c."""
    import torch
    rand = lambda *shape: torch.randn(*shape, device=dev, generator=g)
    return (1.0 + 0.1 * rand(c), 0.1 * rand(c), 0.05 * rand(4 * c, c), 0.05 * rand(4 * c),
            0.05 * rand(c, 4 * c), 0.05 * rand(c))


def table_swin_mlp(dev, config):
    """Kernel 4 at `config`'s four stage shapes (row counts that no tile
    divides), the weights in bf16 as models/swin.py hands them over, beside
    the composition bf16 F.layer_norm (float32 statistics) -> F.linear ->
    F.gelu -> F.linear -> + x, which the port never calls; held also in
    float32; the wide form's three launches and the fused kernel's one also
    in device time alone, with each launch's geometry."""
    import torch
    import torch.nn.functional as F
    from yolact_minimal_torch.ops.swin_mlp import (kernel_geometry, mlp_block, mlp_block_plain,
                                                   mlp_form)
    g = torch.Generator(device=dev).manual_seed(4)
    per_stage = []
    for i, s in enumerate(_stages(config)):
        rows, c = s['rows'], s['c']
        x32 = torch.randn(rows, c, device=dev, generator=g)
        x = x32.bfloat16()
        p = _mlp_params(dev, g, c)
        args = (x, p[0], p[1], p[2].bfloat16(), p[3], p[4].bfloat16(), p[5])
        bf = [t.bfloat16() for t in p]
        composition = ('composition', lambda: x + F.linear(F.gelu(F.linear(
            F.layer_norm(x, (c,), bf[0], bf[1], 1e-5), bf[2], bf[3])), bf[4], bf[5]), None,
            _rel_gap, YARDSTICK_REL_TOL)
        form = mlp_form(c, torch.bfloat16)
        launches = {'ln': r'mlp_wide_ln_kernel', 'fc1': r'mlp_wide_gemm_kernel<\d+,\s*false>',
                    'fc2': r'mlp_wide_gemm_kernel<\d+,\s*true>'} if form == 'wide' else \
            {'fused': r'mlp_bf16_sm90_kernel'}
        m = _measure(f'kernel swin_mlp stage {i} x [{rows}, {c}], {form} form',
                     lambda: mlp_block(*args), lambda: mlp_block_plain(*args), _rel_gap,
                     SWIN_BF16_REL_TOL, roofline.swin_mlp(rows, c), yardsticks=[composition],
                     shape=[rows, c], form=form,
                     holds=_forms(mlp_block, mlp_block_plain,
                                  [('float32', (x32, *p), SWIN_F32_REL_TOL)]),
                     geometry={k: kernel_geometry(c, rows, k)
                               for k in (('fc1', 'fc2') if form == 'wide' else ('fused',))})
        m['device_ms_by_launch'] = _device_ms_by_kernel(lambda: mlp_block(*args), launches)
        print(f'  device ms by launch {m["device_ms_by_launch"]}; geometry '
              f'{json.dumps(m["geometry"])}')
        per_stage.append(m)
        del x, x32, p, args, bf
        torch.cuda.empty_cache()
    return per_stage


def table_swin_glue(dev):
    """The attention half's two glue kernels at swin_tiny_coco's and
    swin_large_coco's four stage maps (shifted; held also unshifted and in
    float32): to_windows (norm1 into the shifted, padded windows) held to
    its plain version (the composition F.layer_norm in float32, rounded,
    pad, roll, partition) within one ulp, from_windows (the windows back
    onto the shortcut) exactly; each timed beside its plain version. The
    bound counts each byte read and written once: to_windows reads the
    image rows and writes the window rows, from_windows reads the image
    rows' windows and shortcut and writes them. Returns (to_windows' rows,
    from_windows' rows)."""
    import torch
    from yolact_minimal_torch.ops.swin_glue import (from_windows, from_windows_plain,
                                                    to_windows, to_windows_plain)
    g = torch.Generator(device=dev).manual_seed(5)
    to_rows, from_rows = [], []
    for config in ('swin_tiny_coco', 'swin_large_coco'):
        for i, s in enumerate(_stages(config)):
            c, win, side, hp = s['c'], s['window'], s['side'], s['padded']
            shift = win // 2
            x32 = torch.randn(BATCH, side, side, c, device=dev, generator=g)
            ln = (1 + 0.1 * torch.randn(c, device=dev, generator=g),
                  0.1 * torch.randn(c, device=dev, generator=g))
            x = x32.bfloat16()
            rows, window_rows = BATCH * side * side, BATCH * hp * hp
            y32 = torch.randn(window_rows // win ** 2, win ** 2, c, device=dev, generator=g)
            y = y32.bfloat16()
            what = f'{config} stage {i} [{BATCH}, {side}, {side}, {c}] window {win}'
            to_rows.append(_measure(
                f'kernel to_windows {what}', lambda: to_windows(x, *ln, win, shift),
                lambda: to_windows_plain(x, *ln, win, shift), _rel_gap, SWIN_BF16_REL_TOL,
                (2 * (rows + window_rows) * c + 8 * c, 0), config=config, shape=[rows, c],
                window_rows=window_rows,
                holds=_forms(to_windows, to_windows_plain, [
                    ('bf16 unshifted', (x, *ln, win, 0), SWIN_BF16_REL_TOL),
                    ('float32 shifted', (x32, *ln, win, shift), SWIN_F32_REL_TOL)])))
            from_rows.append(_measure(
                f'kernel from_windows {what}', lambda: from_windows(y, x, win, shift),
                lambda: from_windows_plain(y, x, win, shift), _exact_gap, 0.0,
                (3 * 2 * rows * c, 0), config=config, shape=[rows, c], window_rows=window_rows,
                holds=_forms(from_windows, from_windows_plain, [
                    ('bf16 unshifted', (y, x, win, 0), 0.0),
                    ('float32 shifted', (y32, x32, win, shift), 0.0)])))
            del x, x32, y, y32
            torch.cuda.empty_cache()
    return to_rows, from_rows


def _block_inputs(dev, g, s):
    """Seeded float32 inputs of the two block kernels at swin_tiny stage `s`:
    x, LayerNorm parameters, Linear weights and biases scaled so that every
    activation stays O(1) at every width, the relative-position bias, and the
    padded map's tables: the region ids of the shifted partition and the
    rowmasks of the unshifted (`rowmask0`) and the shifted block."""
    import torch
    from yolact_minimal_torch.models.swin import pad_rowmask
    c, heads, bnw = s['c'], s['heads'], s['windows']
    rand = lambda *shape: torch.randn(*shape, device=dev, generator=g)
    rowmask0, rowmask = [torch.from_numpy(pad_rowmask(
        s['side'], s['side'], s['padded'], s['padded'], shift)).to(dev)
        for shift in (0, s['window'] // 2)]
    _check(0 < rowmask.mean().item() < 1, 'the rowmask marks no padding')
    return dict(
        x=rand(bnw, 49, c), bias=0.1 * rand(heads, 49, 49),
        ln1=(1.0 + 0.1 * rand(c), 0.1 * rand(c)), ln2=(1.0 + 0.1 * rand(c), 0.1 * rand(c)),
        qkv=(rand(3 * c, c) * c ** -0.5, 0.05 * rand(3 * c)),
        proj=(rand(c, c) * c ** -0.5, 0.05 * rand(c)),
        fc1=(rand(4 * c, c) * c ** -0.5, 0.05 * rand(4 * c)),
        fc2=(rand(c, 4 * c) * (4 * c) ** -0.5, 0.05 * rand(c)),
        region=_regions(dev, s), rowmask0=rowmask0, rowmask=rowmask)


def _bf16(p):
    """`_block_inputs` as models/swin.py hands them over in bf16: x, the bias
    and the Linear weights in bf16, LayerNorm parameters and biases float32."""
    import torch
    q = dict(p, x=p['x'].bfloat16(), bias=p['bias'].bfloat16())
    for k in ('qkv', 'proj', 'fc1', 'fc2'):
        q[k] = (p[k][0].to(torch.bfloat16), p[k][1])
    return q


def _block_flops(s, whole):
    """Operations of one launch at stage `s`: the qkv, q k^T, p v and proj
    products, and the two MLP products for the whole block."""
    rows, c = s['windows'] * 49, s['c']
    return 2 * rows * c * 3 * c + 4 * rows * 49 * c + 2 * rows * c * c + \
        (16 * rows * c * c if whole else 0)


def table_attn_block(dev):
    """Kernel 5 at swin_tiny_coco's four stage shapes, beside what it
    replaces: cuBLAS qkv, kernel 3, cuBLAS proj on the same rows; held also
    in float32, shifted and unshifted, and in bf16 unshifted. Bound: x, the
    weights and the bias read and the output written once in bf16, the
    biases and the region ids in 4 bytes."""
    import torch
    import torch.nn.functional as F
    from yolact_minimal_torch.ops.attn_block import (attn_block, attn_block_plain,
                                                     kernel_attributes, kernel_geometry)
    from yolact_minimal_torch.ops.window_attention import window_attention
    g = torch.Generator(device=dev).manual_seed(5)
    per_stage = []
    for i, s in enumerate(_stages('swin_tiny_coco')):
        p32 = _block_inputs(dev, g, s)
        p = _bf16(p32)
        c, heads = s['c'], s['heads']
        x, (wqkv, bqkv), (wproj, bproj), bias, region = p['x'], p['qkv'], p['proj'], \
            p['bias'], p['region']

        def block_args(q, region):
            return (q['x'], *q['qkv'], q['bias'], region, *q['proj'], heads)
        args = block_args(p, region)
        bqkv16, bproj16 = bqkv.bfloat16(), bproj.bfloat16()
        composed = ('composed', lambda: F.linear(window_attention(
            F.linear(x, wqkv, bqkv16), bias, region, heads), wproj, bproj16),
            None, _rel_gap, YARDSTICK_REL_TOL)
        n_bytes = (2 * x.numel() + wqkv.numel() + wproj.numel() + bias.numel()) * 2 + \
            (4 * c + region.numel()) * 4
        per_stage.append(_measure(
            f'kernel attn_block stage {i} x [{s["windows"]}, 49, {c}] heads {heads}',
            lambda: attn_block(*args), lambda: attn_block_plain(*args), _rel_gap,
            SWIN_BF16_REL_TOL, (n_bytes, _block_flops(s, False)), yardsticks=[composed],
            holds=_forms(attn_block, attn_block_plain, [
                ('float32 unshifted', block_args(p32, None), SWIN_F32_REL_TOL),
                ('float32 shifted', block_args(p32, region), SWIN_F32_REL_TOL),
                ('bf16 unshifted', block_args(p, None), SWIN_BF16_REL_TOL)]),
            shape=list(x.shape), heads=heads,
            geometry=dict(dataclasses.asdict(kernel_geometry(s['windows'], c, _sms(dev))),
                          kernels=kernel_attributes(c))))
        del p, p32, x, args
        torch.cuda.empty_cache()
    return per_stage


def _library_block(p, heads):
    """Kernel 6's yardstick: the block as PyTorch's own calls on the same
    windowed bf16 rows, F.layer_norm -> F.linear -> SDPA (bias + the -100
    region fill as attn_mask) -> F.linear -> add -> F.layer_norm -> F.linear
    -> F.gelu -> F.linear -> add (no rowmask: the shifted block of an
    unpadded map). The port never calls it. Returns the call."""
    import torch
    import torch.nn.functional as F
    bf = torch.bfloat16
    x = p['x']
    bnw, n, c = x.shape
    nw = p['region'].shape[0]
    differ = p['region'][:, :, None] != p['region'][:, None, :]
    mask = (p['bias'][None] + torch.where(differ, -100.0, 0.0)[:, None].to(bf))
    ln1, ln2 = [tuple(t.to(bf) for t in p[k]) for k in ('ln1', 'ln2')]
    (wqkv, bqkv), (wproj, bproj), (w1, b1), (w2, b2) = [
        tuple(t.to(bf) for t in p[k]) for k in ('qkv', 'proj', 'fc1', 'fc2')]

    def block():
        xn = F.layer_norm(x, (c,), *ln1)
        q, k, v = F.linear(xn, wqkv, bqkv).reshape(bnw // nw, nw, n, 3, heads, c // heads) \
            .permute(3, 0, 1, 4, 2, 5).unbind(0)
        a = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        h = x + F.linear(a.permute(0, 1, 3, 2, 4).reshape(bnw, n, c), wproj, bproj)
        return h + F.linear(F.gelu(F.linear(F.layer_norm(h, (c,), *ln2), w1, b1)), w2, b2)
    return block


def table_swin_block(dev):
    """Kernel 6 at swin_tiny_coco's four stage shapes with the padded map's
    rowmask, beside the block as PyTorch's own calls (`_library_block`, held
    to the plain version without the rowmask); held also in float32
    unshifted, shifted and shifted without the rowmask, and in bf16
    unshifted; at C = 768 each of its six launches in device time alone.
    Bound: x read and written, the weights
    and the bias read once in bf16, LayerNorm parameters, biases and the two
    tables in 4 bytes."""
    import torch
    from yolact_minimal_torch.ops.swin_block import (FLAT_LAUNCHES, SCRATCH_WIDTHS,
                                                     kernel_attributes, kernel_geometry,
                                                     swin_block, swin_block_plain)
    g = torch.Generator(device=dev).manual_seed(6)
    per_stage = []
    for i, s in enumerate(_stages('swin_tiny_coco')):
        p32 = _block_inputs(dev, g, s)
        p = _bf16(p32)
        c, heads, bnw, nw = s['c'], s['heads'], s['windows'], s['n_win']

        def block_args(q, rowmask, region):
            return (q['x'], rowmask, *q['ln1'], *q['qkv'], q['bias'], region, *q['proj'],
                    *q['ln2'], *q['fc1'], *q['fc2'], heads)
        args, free = block_args(p, p['rowmask'], p['region']), block_args(p, None, p['region'])
        library = ('library', _library_block(p, heads), lambda: swin_block_plain(*free),
                   _rel_gap, YARDSTICK_REL_TOL)
        n_bytes = (2 * bnw * 49 * c + 12 * c * c + heads * 49 * 49) * 2 + \
            (13 * c + 2 * nw * 49) * 4
        m = _measure(f'kernel swin_block stage {i} x [{bnw}, 49, {c}] heads {heads}',
                     lambda: swin_block(*args), lambda: swin_block_plain(*args), _rel_gap,
                     SWIN_BF16_REL_TOL, (n_bytes, _block_flops(s, True)), yardsticks=[library],
                     holds=_forms(swin_block, swin_block_plain, [
                         ('float32 unshifted', block_args(p32, p['rowmask0'], None),
                          SWIN_F32_REL_TOL),
                         ('float32 shifted', block_args(p32, p['rowmask'], p['region']),
                          SWIN_F32_REL_TOL),
                         ('float32 shifted, no rowmask', block_args(p32, None, p['region']),
                          SWIN_F32_REL_TOL),
                         ('bf16 unshifted', block_args(p, p['rowmask0'], None),
                          SWIN_BF16_REL_TOL)]),
                     shape=[bnw, 49, c], heads=heads,
                     geometry=dict(dataclasses.asdict(kernel_geometry(bnw, c, _sms(dev))),
                                   kernels=kernel_attributes(c)))
        if c in SCRATCH_WIDTHS:
            m['device_ms_by_launch'] = _device_ms_by_kernel(
                lambda: swin_block(*args), {k: rf'swin_block_{k}_kernel' for k in FLAT_LAUNCHES})
            print(f'  device ms by launch {m["device_ms_by_launch"]}')
        per_stage.append(m)
        del p, p32, args, free, library
        torch.cuda.empty_cache()
    return per_stage


def table_window_attention_backward(dev):
    """Kernel 3's backward kernel (ops/window_attention.py::
    window_attention_backward) beside the plain recompute under autograd
    (window_attention_backward_plain) at each swin_tiny_coco stage, batches
    WA_BACKWARD_BATCHES at 544, shifted. Bound: qkv and the incoming
    gradient read and d_qkv written once, 14 C bytes a padded row, against
    five products of 2 * 49 * 49 * 32 operations a (window, head)."""
    import torch
    from yolact_minimal_torch.ops.window_attention import (window_attention_backward,
                                                           window_attention_backward_plain)
    g = torch.Generator(device=dev).manual_seed(10)
    per_stage = []
    for batch in WA_BACKWARD_BATCHES:
        for i, s in enumerate(_stages('swin_tiny_coco', batch)):
            bnw, c, heads = s['windows'], s['c'], s['heads']
            region = _regions(dev, s)
            qkv = torch.randn(bnw, 49, 3 * c, device=dev, generator=g).bfloat16()
            bias = (torch.randn(heads, 49, 49, device=dev, generator=g) * 0.1).bfloat16()
            grad = torch.randn(bnw, 49, c, device=dev, generator=g).bfloat16()
            per_stage.append(_measure(
                f'kernel window_attention_backward batch {batch} stage {i} qkv [{bnw}, 49, '
                f'{3 * c}]', lambda: window_attention_backward(qkv, bias, region, heads, grad),
                lambda: window_attention_backward_plain(qkv, bias, region, heads, grad),
                _backward_gap, WA_BACKWARD_GAP,
                (14 * c * bnw * 49, 5 * 2 * 49 * 49 * 32 * bnw * heads), batch=batch,
                shape=[bnw, 49, 3 * c], heads=heads))
            del qkv, bias, grad
            torch.cuda.empty_cache()
    return per_stage


def phase_kernels(dev):
    """Phase 3: the kernel table. Returns its rows."""
    bf16 = (f'bf16 within {SWIN_BF16_REL_TOL:.3g} and float32 within {SWIN_F32_REL_TOL:.3g} '
            f'of max |plain|')
    rows = [table_suppression(dev), table_mask_finalize(dev)]
    for config, attention, mlp, mlp_top in (
            ('swin_tiny_coco', 'window_attention', 'swin_mlp', 0),
            ('swin_large_coco', 'window_attention_n144', 'swin_mlp_wide', 2)):
        rows += [_row(attention, 'window_attention.cu', 'window_attention.py:154',
                      f'{bf16}, {config}', table_window_attention(dev, config)),
                 _row(mlp, 'swin_mlp.cu', 'swin_mlp.py:128', f'{bf16}, {config}',
                      table_swin_mlp(dev, config), top=mlp_top)]
    to_rows, from_rows = table_swin_glue(dev)
    rows += [_row('to_windows', 'swin_glue.cu', None, f'{bf16}, swin_tiny_coco and '
                  'swin_large_coco', to_rows),
             _row('from_windows', 'swin_glue.cu', None, 'bit-equal, swin_tiny_coco and '
                  'swin_large_coco', from_rows),
             _row('attn_block', 'attn_block.cu', 'window_attention.py:316', bf16,
                  table_attn_block(dev)),
             _row('swin_block', 'swin_block.cu', 'swin_block.py:198', bf16,
                  table_swin_block(dev)),
             _row('window_attention_backward', 'window_attention.cu', 'window_attention.py:154',
                  f'dq, dk, dv and d_bias within {WA_BACKWARD_GAP} in relative L2 of the plain '
                  f'recompute', table_window_attention_backward(dev))]
    return rows


# --- the launch counters ----------------------------------------------------------

def _counters(name):
    """The launch-counting wrappers of the kernels on a config's path."""
    from yolact_minimal_torch.ops.attn_block import attn_block
    from yolact_minimal_torch.ops.mask_finalize import mask_finalize
    from yolact_minimal_torch.ops.suppression import suppression_iou_max
    from yolact_minimal_torch.ops.swin_block import swin_block
    from yolact_minimal_torch.ops.swin_glue import from_windows, to_windows
    from yolact_minimal_torch.ops.swin_mlp import mlp_block
    from yolact_minimal_torch.ops.window_attention import window_attention
    counters = {'suppression_iou_max': suppression_iou_max, 'mask_finalize': mask_finalize}
    if name.startswith('swin'):
        counters.update(window_attention=window_attention, swin_mlp=mlp_block,
                        attn_block=attn_block, swin_block=swin_block, to_windows=to_windows,
                        from_windows=from_windows)
    return counters


def _zero_counters(counters):
    """Sets the launch counters of `counters` to 0, and kernel 3's backward
    kernel's (window_attention.backward_launches)."""
    from yolact_minimal_torch.ops.window_attention import window_attention
    for fn in counters.values():
        fn.launches = 0
    window_attention.backward_launches = 0


def _read_counters(counters):
    """The launches since _zero_counters, kernel 3's backward kernel's under
    'window_attention_backward' (on every path: 0 where no bf16 kernel 3
    runs backward)."""
    from yolact_minimal_torch.ops.window_attention import window_attention
    launches = {k: fn.launches for k, fn in counters.items()}
    launches['window_attention_backward'] = window_attention.backward_launches
    return launches


def _swin_launches(path, config='swin_tiny_coco'):
    """The launches of each swin kernel that one forward pass of `config` on
    swin path `path` must make: every block its form's kernels, once."""
    depths = [s['depth'] for s in _stages(config)]
    return {k: sum(depth for depth, form in zip(depths, SWIN_PATHS[path])
                   if k in SWIN_FORM_LAUNCHES[form]) for k in SWIN_KERNELS}


def phase_main_paths(dev):
    """The main paths, one call each: Detector.detect_fixed at IMG with
    seeded weights and images, res50_coco and swin_tiny_coco (on each path of
    SWIN_PATHS) in bf16 at BATCH, swin_large_coco in bf16 at BATCH and in
    float32 at batch 2. After a warm-up call the counters are set to 0, and
    one call must launch kernels 1 and 2 once and each swin kernel as often
    as `_swin_launches` says, and fill the slate (every slot valid, finite
    scores, boxes and coefficients, bool masks at IMG with pixels set).
    Returns the launches by path."""
    import torch
    from yolact_minimal_torch.config import get_config
    from yolact_minimal_torch.pipeline import Detector
    images = torch.randn(BATCH, IMG, IMG, 3, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(2))
    by_path = {}
    for name, dtype, batch, forms in (
            ('res50_coco', 'bfloat16', BATCH, (None,)),
            ('swin_tiny_coco', 'bfloat16', BATCH, tuple(SWIN_PATHS)),
            ('swin_large_coco', 'bfloat16', BATCH, (None,)),
            ('swin_large_coco', 'float32', 2, (None,))):
        cfg = get_config(name, img_size=IMG, nms_score_thre=SCORE_THRE, compute_dtype=dtype)
        det, counters = Detector(cfg, device=dev, seed=0), _counters(name)
        for form in forms:
            path = name if form is None else f'{name}/{form}'
            path += '' if dtype == 'bfloat16' else f'/{dtype} b{batch}'
            if form is not None:
                det.model.backbone.set_block_forms(SWIN_PATHS[form])
            det.detect_fixed(images[:batch], IMG)                       # warm-up
            torch.cuda.synchronize()
            _zero_counters(counters)
            dets, masks = det.detect_fixed(images[:batch], IMG)
            torch.cuda.synchronize()
            launches = by_path[path] = _read_counters(counters)
            want = dict(suppression_iou_max=1, mask_finalize=1, window_attention_backward=0)
            if name.startswith('swin'):
                want.update(_swin_launches(form or 'composed', name))
            n_valid = int(dets.valid.sum())
            print(f'main path {path}: detect_fixed at {IMG}, batch {batch}, {dtype}: launches '
                  f'{launches}; {n_valid}/{batch * SLOTS} valid, '
                  f'{masks.float().mean().item():.4f} of mask pixels set')
            _check(launches == want, f'{path}: expected launches {want}, got {launches}')
            _check(masks.shape == (batch, SLOTS, IMG, IMG) and masks.dtype == torch.bool,
                   f'{path}: detect_fixed masks {tuple(masks.shape)} {masks.dtype}')
            _check(all(torch.isfinite(t).all().item()
                       for t in (dets.scores, dets.boxes, dets.coefs)), f'{path}: non-finite slate')
            _check(n_valid == batch * SLOTS and masks.any().item(), f'{path}: the slate did not fill')
        del det, dets, masks
        torch.cuda.empty_cache()
    return by_path


# Each row of the kernel table: its launch counter and the path whose count
# is its `launches`; its `launches_by_path` has the counts of every path of
# that path's config (every path for kernels 1 and 2).
ROW_LAUNCHES = {'suppression_iou_max': ('suppression_iou_max', 'res50_coco'),
                'mask_finalize': ('mask_finalize', 'res50_coco'),
                'window_attention': ('window_attention', 'swin_tiny_coco/composed'),
                'swin_mlp': ('swin_mlp', 'swin_tiny_coco/composed'),
                'window_attention_n144': ('window_attention', 'swin_large_coco'),
                'swin_mlp_wide': ('swin_mlp', 'swin_large_coco'),
                'attn_block': ('attn_block', 'swin_tiny_coco/attn_block'),
                'swin_block': ('swin_block', 'swin_tiny_coco/whole'),
                'to_windows': ('to_windows', 'swin_tiny_coco/composed'),
                'from_windows': ('from_windows', 'swin_tiny_coco/composed'),
                'window_attention_backward': ('window_attention_backward',
                                              'swin_tiny_coco/mixed train bf16 2 steps')}


def _add_launches(rows, by_path):
    """Sets each row's `launches` and `launches_by_path` (ROW_LAUNCHES)."""
    for row in rows:
        counter, own = ROW_LAUNCHES[row['name']]
        row['launches'] = by_path[own][counter]
        _check(row['launches'] > 0, f'kernel {row["name"]} was not launched on {own}')
        config = own.split('/')[0] if counter not in ('suppression_iou_max', 'mask_finalize') \
            else None
        row['launches_by_path'] = {p: c[counter] for p, c in by_path.items()
                                   if counter in c and config in (None, p.split('/')[0])}


# --- phases 4-5: the detect and eval CLIs -------------------------------------------

@contextlib.contextmanager
def _without_cv2():
    """cv2 does not import inside the block, as on a machine without it."""
    from yolact_minimal_torch.utils import image_io
    saved = {k: v for k, v in sys.modules.items() if k.split('.')[0] == 'cv2'}
    for k in saved:
        del sys.modules[k]
    sys.modules['cv2'] = None
    image_io.backend.cache_clear()
    try:
        yield
    finally:
        del sys.modules['cv2']
        sys.modules.update(saved)
        image_io.backend.cache_clear()


def _seeded_pngs(folder, seed):
    """Two seeded PNGs of different shapes (colour ramps plus noise) in
    `folder`; returns {name: (h, w)}."""
    import numpy as np
    from yolact_minimal_torch.utils import image_io
    rng = np.random.RandomState(seed)
    shapes = {'wide.png': (480, 640), 'square.png': (IMG, IMG)}
    os.makedirs(folder)
    for name, (h, w) in shapes.items():
        ramp = np.linspace(0, 200, w)[None, :, None] + np.linspace(0, 50, h)[:, None, None]
        img = np.clip(ramp + rng.randint(0, 40, (h, w, 3)), 0, 255).astype(np.uint8)
        image_io.imwrite(os.path.join(folder, name), img)
    return shapes


def _seeded_res50_coco(dev):
    """A seeded res50_coco state_dict on the CPU, its class head's bias for
    class 1 raised by 6 at every anchor, so that detections pass the CLIs'
    thresholds and the drawing has work."""
    from yolact_minimal_torch.config import get_config
    from yolact_minimal_torch.pipeline import Detector
    det = Detector(get_config('res50_coco', img_size=IMG), device=dev, seed=0)
    sd = {k: v.cpu() for k, v in det.model.state_dict().items()}
    sd['prediction_layers.conf_layer.bias'][1::81] += 6.0
    return sd


def _detect_cli(dev, flags):
    """yolact_minimal_torch.detect.main on two seeded PNGs with a seeded
    res50_coco .pth, from a temporary working directory, with `flags`; both
    drawn images must read back at their input shapes and differ from the
    input. Returns (the launches of the run, the PNGs' shapes, the lincomb
    grids' shapes where written)."""
    import tempfile
    import numpy as np
    import torch
    from yolact_minimal_torch.detect import main as detect_main
    from yolact_minimal_torch.utils import image_io
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        shapes = _seeded_pngs(os.path.join(tmp, 'images'), 8)
        weight = os.path.join(tmp, 'seeded_res50_coco.pth')
        torch.save(_seeded_res50_coco(dev), weight)
        counters = _counters('res50_coco')
        _zero_counters(counters)
        os.chdir(tmp)
        try:
            detect_main(['--weight', weight, '--image', os.path.join(tmp, 'images'),
                         '--img_size', str(IMG), *flags])
        finally:
            os.chdir(cwd)
        torch.cuda.synchronize()
        launches, grids = _read_counters(counters), {}
        for name, shape in shapes.items():
            out = image_io.imread(os.path.join(tmp, 'results', 'images', name))
            src = image_io.imread(os.path.join(tmp, 'images', name))
            _check(out.shape == shape + (3,), f'{name}: drawn image {out.shape}, input {shape}')
            _check(not np.array_equal(out, src), f'{name}: nothing was drawn')
            lincomb = os.path.join(tmp, 'results', 'images', f'lincomb_{name}')
            if os.path.exists(lincomb):
                grids[name] = image_io.imread(lincomb).shape
    return launches, shapes, grids


def phase_detect_cli(dev):
    """Phase 4: the detect CLI as a user runs it, with cv2 hidden (so the
    images go through PIL and val_aug through F.interpolate). Returns the
    launches."""
    from yolact_minimal_torch.utils import image_io
    with _without_cv2():
        library = image_io.backend()
        launches, shapes, _ = _detect_cli(dev, [])
    _check(launches['suppression_iou_max'] == len(shapes),
           f'the CLI made {launches} kernel launches for {len(shapes)} images')
    print(f'detect CLI: {len(shapes)} PNGs {list(shapes.values())}, cv2 hidden, image library '
          f'{library}; both drawn images at their input shapes; launches {launches}')
    return launches


def _run_cli(module, args, cwd, env=None, timeout=600):
    """`python -m yolact_minimal_torch.MODULE ARGS` in a subprocess from `cwd`,
    as a user runs it (the environment with `env` over it); fails unless it
    exits 0. Returns its output."""
    env = dict(os.environ, **(env or {}), PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get('PYTHONPATH')) if p))
    proc = subprocess.run([sys.executable, '-m', f'yolact_minimal_torch.{module}', *args],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout)
    _check(proc.returncode == 0, f'{module} {args} exited {proc.returncode}:\n'
                                 f'{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}')
    return proc.stdout


def _table_rows(out):
    """The box and mask rows of the mAP table the eval CLI printed, as floats."""
    rows = {}
    for line in out.splitlines():
        cells = [c.strip() for c in line.strip().strip('|').split('|')]
        if cells[0] in ('box', 'mask'):
            rows[cells[0]] = [float(c) for c in cells[1:]]
    _check(set(rows) == {'box', 'mask'} and all(len(r) == 11 for r in rows.values()),
           f'no box and mask rows in the eval output:\n{out[-2000:]}')
    _check(all(math.isfinite(v) and 0 <= v <= 100 for r in rows.values() for v in r),
           f'eval table values outside [0, 100]: {rows}')
    return rows


def _seeded_ckpt(dev, name, folder):
    """A seeded Detector of config `name` at IMG written as a .ckpt file by the
    port's save_checkpoint; returns its path."""
    from yolact_minimal_torch.config import get_config
    from yolact_minimal_torch.pipeline import Detector
    from yolact_minimal_torch.utils.checkpoint import save_checkpoint
    from yolact_minimal_torch.utils.weights import to_jax_variables
    det = Detector(get_config(name, img_size=IMG), device=dev, seed=0)
    path = os.path.join(folder, f'seeded_{name}_0.ckpt')
    save_checkpoint(path, to_jax_variables(det.model.state_dict()))
    return path


def phase_eval(dev, kernel1):
    """Phase 5: the eval path on the card. `python -m yolact_minimal_torch.eval
    --weight W --img_size 544` on seeded res50_custom and res101_custom .ckpt
    files over the 48 images of custom_dataset/, and on res50_custom once
    more with --coco_api from a temporary working directory (both jsons
    written, the COCO stats printed). Then evaluate() on res50_custom in this
    process, recording the planes kernel 1 got on each batch and what it
    gave: each batch is held exactly to the plain version, and batch 0 is
    timed as `kernel1`'s input (c). Returns the CLI's rows by config."""
    import tempfile
    import torch
    from yolact_minimal_torch.config import get_config
    from yolact_minimal_torch.eval import evaluate
    from yolact_minimal_torch.ops import nms
    from yolact_minimal_torch.ops.suppression import suppression_iou_max_plain
    from yolact_minimal_torch.pipeline import load_detector

    data = ['--val_imgs', os.path.join(ROOT, 'custom_dataset', 'images'),
            '--val_ann', os.path.join(ROOT, 'custom_dataset', 'annotations.json')]
    with tempfile.TemporaryDirectory() as tmp:
        ckpts = {name: _seeded_ckpt(dev, name, tmp) for name in EVAL_CONFIGS}
        torch.cuda.empty_cache()
        cli_rows = {}
        for name, path in ckpts.items():
            rows = cli_rows[name] = _table_rows(_run_cli('eval', ['--weight', path, '--img_size',
                                                                  str(IMG)], ROOT))
            print(f'eval CLI {name} {IMG}, 48 images of custom_dataset/, val_bs {EVAL_BS}, '
                  f'float32: box row {rows["box"]}, mask row {rows["mask"]}')
        work = os.path.join(tmp, 'work')
        os.makedirs(work)
        out = _run_cli('eval', ['--weight', ckpts['res50_custom'], '--img_size', str(IMG),
                                '--coco_api', *data], work)
        for name in ('bbox_detections.json', 'mask_detections.json'):
            with open(os.path.join(work, 'results', name)) as f:
                n = len(json.load(f))
            _check(n > 0, f'--coco_api wrote an empty {name}')
            print(f'eval CLI --coco_api: results/{name} holds {n} detections')
        stats = re.findall(r' (bbox|segm) +(\w+): (-?[\d.]+)', out)
        _check(len(stats) == 24 and all(math.isfinite(float(v)) for _, _, v in stats),
               f'--coco_api printed {len(stats)} of 24 COCO stats:\n{out[-2000:]}')
        print('eval CLI --coco_api: ' +
              ', '.join(f'{k} {n} {v}' for k, n, v in stats if n in ('AP', 'AP50', 'AR100')))

        cfg = get_config('res50_custom', mode='val', img_size=IMG)
        det = load_detector(ckpts['res50_custom'], cfg, device=dev)
        planes, kernel = [], nms.suppression_iou_max

        def recording(*args):
            out = kernel(*args)
            planes.append(([a.clone() for a in args], out.clone()))
            return out
        nms.suppression_iou_max = recording
        try:
            evaluate(det, cfg)
        finally:
            nms.suppression_iou_max = kernel
        batches = -(-48 // EVAL_BS)
        _check(len(planes) == batches, f'recorded {len(planes)} kernel 1 calls of {batches} '
                                        f'batches')
        for b, (args, got) in enumerate(planes):
            gap = _exact_gap(got, suppression_iou_max_plain(*args))
            _check(gap == 0.0, f'kernel 1 on eval batch {b}: {gap} from the plain version')
        print(f'res50_custom evaluate() in this process: kernel 1 once a batch ({batches}), '
              f'each batch\'s planes exact against the plain version')
        kernel1['inputs']['c_eval_path'] = _measure_suppression('(c) eval path, batch 0',
                                                               planes[0][0])
        del det, planes
    torch.cuda.empty_cache()
    return cli_rows


# --- phase 6: numerics --------------------------------------------------------------

def phase_numerics(dev, name, forms):
    """One image through config `name`, on swin in each block form of
    `forms` (paths of SWIN_PATHS). Float32 with TF32 off: the card's network
    outputs against the CPU's (on the CPU the swin kernels' plain versions
    run; on the card the form's kernels must launch), for the other forms
    also against the composed form's on the card; then the card's
    postprocess and mask kernel against the CPU's plain versions on the
    same head outputs (random-init scores sit near 1/81, so two slates from
    two forward passes may reorder under float noise). Then a bf16 Detector
    (float32 parameters and statistics) against the card's float32 run."""
    import torch
    from yolact_minimal_torch.config import get_config
    from yolact_minimal_torch.ops.mask_finalize import mask_finalize
    from yolact_minimal_torch.ops.nms import detect_postprocess_batch
    from yolact_minimal_torch.pipeline import Detector

    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(name, img_size=IMG, nms_score_thre=SCORE_THRE)
    gpu, cpu = Detector(cfg, device=dev, seed=0), Detector(cfg, device='cpu', seed=0)
    bf16 = Detector(cfg.replace(compute_dtype='bfloat16'), device=dev, seed=0)
    _check(all(t.dtype in (torch.float32, torch.int64)
               for t in list(bf16.model.parameters()) + list(bf16.model.buffers())),
           'a parameter or buffer is not float32 under bf16')
    image = torch.randn(1, IMG, IMG, 3, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(2))
    counters, names, composed = _counters(name), ('class', 'box', 'coef', 'proto'), None
    try:
        for form in forms:
            what = f'{name}/{form}' if name.startswith('swin') else name
            if name.startswith('swin'):
                for det in (gpu, cpu, bf16):
                    det.model.backbone.set_block_forms(SWIN_PATHS[form])
            _zero_counters(counters)
            with torch.inference_mode():
                out_gpu = gpu.model(image)
                if name.startswith('swin'):
                    ran = {k: v for k, v in _read_counters(counters).items() if k in SWIN_KERNELS}
                    _check(ran == _swin_launches(form),
                           f'float32 {form}: expected launches {_swin_launches(form)}, got {ran}')
                out_cpu = cpu.model(image.cpu())
                out_bf16 = bf16.model(image)
            for out, a, b in zip(names, out_gpu, out_cpu):
                rel = ((a.cpu() - b).abs().max() / b.abs().max()).item()
                print(f'  {what} network {out}: max |card - cpu| / max |cpu| = {rel:.3g}')
                _check(rel < NET_REL_TOL, f'{what}: network output {out} off by {rel}')
            if composed is not None:
                for out, a, b in zip(names, out_gpu, composed):
                    # 0 is possible: in float32 the half-block kernel sums in
                    # index order, as cuBLAS does at these sizes
                    rel = ((a - b).abs().max() / b.abs().max()).item()
                    print(f'  {what} network {out}: max |{form} - composed| / max |composed| '
                          f'on the card = {rel:.3g} (< {FORM_REL_TOL})')
                    _check(rel < FORM_REL_TOL, f'form {form}: network output {out} off by {rel}')
            composed = out_gpu if composed is None else composed

            post = (gpu.anchors, SCORE_THRE, cfg.nms_iou_thre, cfg.top_k, cfg.max_detections,
                    cfg.nms_pre_topk)
            with torch.inference_mode():
                d_gpu = detect_postprocess_batch(*out_gpu[:3], *post)
                heads_cpu = [t.cpu() for t in out_gpu]
                d_cpu = detect_postprocess_batch(*heads_cpu[:3], gpu.anchors.cpu(), *post[1:])
                m_gpu = mask_finalize(out_gpu[3], d_gpu.coefs, d_gpu.boxes, d_gpu.valid, IMG)
                m_cpu = mask_finalize(heads_cpu[3], d_cpu.coefs, d_cpu.boxes, d_cpu.valid, IMG)
                d_bf16 = detect_postprocess_batch(*out_bf16[:3], *post)
            _check(torch.equal(d_gpu.valid.cpu(), d_cpu.valid) and
                   torch.equal(d_gpu.ids.cpu(), d_cpu.ids),
                   f'{what}: card and CPU slates differ in ids or validity')
            box_err = (d_gpu.boxes.cpu() - d_cpu.boxes).abs().max().item()
            score_err = (d_gpu.scores.cpu() - d_cpu.scores).abs().max().item()
            mismatch = (m_gpu.cpu() != m_cpu).float().mean().item()
            print(f'  {what} slate: ids equal ({int(d_cpu.valid.sum())} valid), boxes max err '
                  f'{box_err:.3g}, scores max err {score_err:.3g} (atol {POST_ATOL}), mask '
                  f'mismatch {mismatch:.3g} (< {MASK_MISMATCH})')
            _check(box_err <= POST_ATOL and score_err <= POST_ATOL, f'{what}: slate off')
            _check(mismatch < MASK_MISMATCH, f'{what}: mask mismatch {mismatch}')

            for out, a, b in zip(names, out_bf16, out_gpu):
                _check(a.dtype == torch.float32, f'bf16 network output {out} is {a.dtype}')
                rel = ((a - b).abs().max() / b.abs().max()).item()
                print(f'  {what} network {out}: max |bf16 - f32| / max |f32| = {rel:.3g} '
                      f'(< {BF16_REL_TOL})')
                _check(0 < rel < BF16_REL_TOL, f'{what}: bf16 network output {out} off by {rel}')
            _check(bool(d_bf16.valid.all()) and bool(d_gpu.valid.all()), 'a slate did not fill')
            s_bf16 = d_bf16.scores.sort(descending=True).values
            s_f32 = d_gpu.scores.sort(descending=True).values
            rel = ((s_bf16 - s_f32).abs().max() / s_f32.abs().max()).item()
            print(f'  {what} slate: sorted scores max |bf16 - f32| / max f32 = {rel:.3g} '
                  f'(< {BF16_SCORE_RTOL})')
            _check(rel < BF16_SCORE_RTOL, f'{what}: bf16 slate scores off by {rel}')
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    del gpu, cpu, bf16
    torch.cuda.empty_cache()


# --- phase 7: training ---------------------------------------------------------------

def _train_batches(n):
    """n batches of custom_dataset/ at IMG, TRAIN_BS a batch, from the port's
    TrainLoader (seed 0, worker processes); the loader is closed after."""
    from yolact_minimal_torch.config import get_config
    from yolact_minimal_torch.data.coco import COCODetection, TrainLoader
    cfg = get_config('res50_coco', mode='train', img_size=IMG, train_bs=TRAIN_BS,
                     train_imgs=os.path.join(ROOT, 'custom_dataset/images'),
                     train_ann=os.path.join(ROOT, 'custom_dataset/annotations.json'))
    loader = TrainLoader(COCODetection(cfg, mode='train'), cfg, batch_size=TRAIN_BS,
                         num_workers=TRAIN_WORKERS, seed=0)
    batches = []
    try:
        while len(batches) < n:
            for batch in loader:
                batches.append(batch)
                if len(batches) == n:
                    break
    finally:
        loader.close()
    print(f'train batches: {n} of {TRAIN_BS} at {IMG} from custom_dataset/ through TrainLoader '
          f'({TRAIN_WORKERS} worker processes)')
    return batches


def phase_train_mixed(dev, batches):
    """swin_tiny_coco at IMG, train_bs TRAIN_BS in the 'mixed' forms (kernels
    6 and 5 under autograd in a training step). bf16: two steps, the counters
    set to 0 before and read after, each step launching exactly
    MIXED_TRAIN_LAUNCHES_PER_STEP, losses finite. float32 (TF32 off): one step
    in 'mixed' and one in 'composed' from the same seeded init on the same
    batch and step generator; the first losses within FORM_REL_TOL of each
    other, the gradients' distance printed. Returns the bf16 steps'
    launches."""
    import torch
    from yolact_minimal_torch.config import get_config
    from yolact_minimal_torch.train_state import create_train_state, train_step
    mixed = SWIN_PATHS['mixed']
    name = 'swin_tiny_coco'
    cfg = get_config(name, mode='train', img_size=IMG, train_bs=TRAIN_BS,
                     compute_dtype='bfloat16')
    state = create_train_state(cfg, dev, seed=0)
    state.model.backbone.set_block_forms(mixed)
    counters = _counters(name)
    _zero_counters(counters)
    totals = [float(train_step(state, batch).total) for batch in batches[:2]]
    torch.cuda.synchronize()
    launches = _read_counters(counters)
    want = {k: 2 * n for k, n in MIXED_TRAIN_LAUNCHES_PER_STEP.items()}
    _check(all(math.isfinite(t) for t in totals), f'{name} mixed bf16: non-finite loss {totals}')
    _check({k: launches[k] for k in want} == want and launches['suppression_iou_max'] == 0 and
           launches['mask_finalize'] == 0, f'{name} mixed train: expected {want} launches over '
           f'2 steps, got {launches}')
    print(f'{name} train bfloat16 {IMG}/b{TRAIN_BS} in the forms {mixed}: total loss '
          f'{totals[0]:.4f} -> {totals[1]:.4f}; launches over 2 steps {launches} (a step: '
          f'{MIXED_TRAIN_LAUNCHES_PER_STEP})')
    bf16_launches = launches
    del state
    torch.cuda.empty_cache()
    cfg = get_config(name, mode='train', img_size=IMG, train_bs=TRAIN_BS, compute_dtype='float32')
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    _zero_counters(counters)
    try:
        runs = {}
        for forms in ('composed', mixed):
            state = create_train_state(cfg, dev, seed=0)
            state.model.backbone.set_block_forms(forms)
            runs[forms] = (train_step(state, batches[0]),
                           {k: p.grad for k, p in state.model.named_parameters()
                            if p.grad is not None})
            del state
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    float32_backward = _read_counters(counters)['window_attention_backward']
    _check(float32_backward == 0, f'{name} float32 steps launched kernel 3\'s backward kernel '
                                  f'{float32_backward} times (the plain recompute runs there)')
    (ref, ref_g), (got, got_g) = runs['composed'], runs[mixed]
    rel = [abs(float(a) - float(b)) / abs(float(b)) for a, b in zip(got, ref)]
    _check(max(rel) <= FORM_REL_TOL, f'{name} float32 mixed step: losses {[float(t) for t in got]}'
           f' against composed {[float(t) for t in ref]} ({max(rel):.3g} > {FORM_REL_TOL})')
    _check(got_g.keys() == ref_g.keys(), f'{name} float32: the forms reach other parameters')
    # in float64: the sums of squares of some gradients overflow float32
    per_tensor = {k: ((got_g[k].double() - g.double()).norm() / g.double().norm()).item()
                  for k, g in ref_g.items()}
    total = math.sqrt(sum(((got_g[k].double() - g.double()) ** 2).sum().item()
                          for k, g in ref_g.items()) /
                      sum((g.double() ** 2).sum().item() for g in ref_g.values()))
    worst = max(per_tensor, key=per_tensor.get)
    backbone = max(v for k, v in per_tensor.items() if k.startswith('backbone.'))
    print(f'{name} train float32 (TF32 off), one step in {mixed} against composed from the '
          f'same init and batch: losses within {max(rel):.3g} relative (<= {FORM_REL_TOL}); '
          f'gradients {total:.3g} of their L2 norm apart, the backbone\'s tensors at most '
          f'{backbone:.3g}, the worst tensor {worst} {per_tensor[worst]:.3g}')
    return bf16_launches


def _logged_losses(out, what):
    """The train CLI's logged (l_class, l_box, l_mask, l_semantic), all
    finite."""
    logged = [tuple(float(x) for x in m) for m in re.findall(
        r'l_class: (\S+) \| l_box: (\S+) \| l_mask: (\S+) \| l_semantic: (\S+) \|', out)]
    _check(logged and all(math.isfinite(v) for l in logged for v in l),
           f'{what} logged no finite losses:\n{out[-2000:]}')
    return logged


def _train_cli_args(img, steps):
    data = [os.path.join(ROOT, p) for p in ('custom_dataset/images',
                                            'custom_dataset/annotations.json')]
    return ['--cfg', 'res50_custom', '--img_size', str(img), '--train_bs', '8', '--max_steps',
            str(steps), '--num_workers', str(TRAIN_WORKERS), '--train_imgs', data[0],
            '--train_ann', data[1], '--val_imgs', data[0], '--val_ann', data[1]]


def phase_train_cli():
    """`python -m yolact_minimal_torch.train` as a user runs it: res50_custom
    at TRAIN_CLI_IMG, train_bs 8, lr 2e-4, TRAIN_CLI_STEPS steps with one
    validation at step TRAIN_CLI_VAL over custom_dataset/'s 48 images, from a
    temporary working directory. The logged total loss must fall (mean of
    the last 10 log lines below the first 10), the latest and best
    checkpoints must be written. Prints the validation's box and mask
    rows."""
    import tempfile
    with tempfile.TemporaryDirectory() as cwd:
        out = _run_cli('train', _train_cli_args(TRAIN_CLI_IMG, TRAIN_CLI_STEPS) +
                       ['--lr', '2e-4', '--val_interval', str(TRAIN_CLI_VAL)], cwd)
        weights = sorted(os.listdir(os.path.join(cwd, 'weights')))
    totals = [sum(l) for l in _logged_losses(out, 'the train CLI')]
    _check(len(totals) >= 20, f'the train CLI logged {len(totals)} steps:\n{out[-2000:]}')
    first, last = statistics.mean(totals[:10]), statistics.mean(totals[-10:])
    _check(last < first, f'the train CLI loss did not fall: {totals}')
    rows = _table_rows(out)
    _check(f'latest_res50_custom_{TRAIN_CLI_STEPS}.ckpt' in weights and
           any(w.startswith('best_') and w.endswith(f'_res50_custom_{TRAIN_CLI_VAL}.ckpt')
               for w in weights), f'the train CLI wrote {weights}')
    print(f'train CLI res50_custom {TRAIN_CLI_IMG}/b8 lr 2e-4, {TRAIN_CLI_STEPS} steps: logged '
          f'total loss (l_class + l_box + l_mask + l_semantic) mean of the first 10 log lines '
          f'{first:.3f} -> last 10 {last:.3f}; wrote {weights}')
    print(f'  validation at step {TRAIN_CLI_VAL} over custom_dataset/ (48 images), '
          f'thresholds all, 50, 55, ..., 95:')
    for k in ('box', 'mask'):
        print(f'  {k:4s} ' + ' '.join(f'{v:6.2f}' for v in rows[k]))


# --- phase 8: export and video ---------------------------------------------------------

def _frames_of(path):
    """(frame count, (width, height)) of a video file, as cv2 reads them."""
    from yolact_minimal_torch.utils import video
    cv2 = video.import_cv2()
    vid = cv2.VideoCapture(path)
    try:
        return (round(vid.get(cv2.CAP_PROP_FRAME_COUNT)),
                (round(vid.get(cv2.CAP_PROP_FRAME_WIDTH)),
                 round(vid.get(cv2.CAP_PROP_FRAME_HEIGHT))))
    finally:
        vid.release()


def _frames_done(out, what):
    m = re.findall(r'Finished, (\d+) frames', out)
    _check(m, f'{what} printed no frame count:\n{out[-2000:]}')
    return int(m[-1])


def phase_export(dev):
    """Phase 8: the export CLI on a seeded res50_coco .ckpt (544, float32,
    batch 1) must print the parity line, and the driver must draw two seeded
    PNGs at their shapes; a seeded VIDEO_FRAMES-frame mp4 through the detect
    CLI (--video_bs VIDEO_BS) and the driver must come back as every frame
    at the clip's size."""
    import tempfile
    import numpy as np
    from yolact_minimal_torch.utils import image_io, video
    from yolact_minimal_torch.utils.checkpoint import save_checkpoint
    from yolact_minimal_torch.utils.weights import to_jax_variables

    with tempfile.TemporaryDirectory() as tmp:
        weight = os.path.join(tmp, 'seeded_res50_coco.ckpt')
        save_checkpoint(weight, to_jax_variables(_seeded_res50_coco(dev)))
        on = ['--device', dev.type]
        out = _run_cli('export', ['--weight', weight, '--img_size', str(IMG), *on], tmp)
        _check('Export parity check passed.' in out,
               f'the export CLI printed no parity line:\n{out}')
        artifact = os.path.join(tmp, 'seeded_res50_coco.pt2')
        shapes = _seeded_pngs(os.path.join(tmp, 'images'), 9)
        _run_cli('detect_with_export', ['--artifact', artifact, '--image',
                                        os.path.join(tmp, 'images'), *on], tmp)
        for name, shape in shapes.items():
            path = os.path.join(tmp, 'results', 'export_images', name)
            _check(os.path.exists(path), f'the driver wrote no {name}')
            drawn = image_io.imread(path)
            _check(drawn.shape == shape + (3,), f'{name}: drawn {drawn.shape}, input {shape}')
            _check(not np.array_equal(drawn, image_io.imread(os.path.join(tmp, 'images', name))),
                   f'{name}: nothing was drawn')
        print(f'export CLI, res50_coco {IMG} float32 batch 1: parity line printed; artifact '
              f'{os.path.getsize(artifact) / 2 ** 20:.1f} MiB; driver --image: both drawn PNGs '
              f'{list(shapes.values())} at their shapes')

        cv2 = video.import_cv2()
        clip = os.path.join(tmp, 'clip.mp4')
        rng = np.random.RandomState(10)
        writer = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*'mp4v'), 10, VIDEO_SIZE)
        w, h = VIDEO_SIZE
        for i in range(VIDEO_FRAMES):
            ramp = np.linspace(0, 200, w)[None, :, None] + np.linspace(5 * i, 50, h)[:, None, None]
            writer.write(np.clip(ramp + rng.randint(0, 40, (h, w, 3)), 0, 255).astype(np.uint8))
        writer.release()
        _check(_frames_of(clip) == (VIDEO_FRAMES, VIDEO_SIZE), f'the clip reads {_frames_of(clip)}')
        for what, module, args, written in (
                ('the detect CLI', 'detect', ['--weight', weight, '--video', clip, '--video_bs',
                                              str(VIDEO_BS), '--img_size', str(IMG)], 'videos'),
                ('the driver', 'detect_with_export', ['--artifact', artifact, '--video', clip],
                 'export_videos')):
            frames = _frames_done(_run_cli(module, [*args, *on], tmp), what)
            got = _frames_of(os.path.join(tmp, 'results', written, 'clip.mp4'))
            _check(frames == VIDEO_FRAMES and got == (VIDEO_FRAMES, VIDEO_SIZE),
                   f'{what} wrote {got} from {frames} frames')
        print(f'video, {VIDEO_FRAMES} frames {w}x{h}, res50_coco {IMG}: the detect CLI '
              f'(--video_bs {VIDEO_BS}) and the driver (artifact batch 1) each wrote every frame '
              f'at the clip\'s size')


# --- phase 9: the flags (--traditional_nms, --save_lincomb, --remat, --backbone_weight)

def phase_flags(dev):
    """Phase 9. The eval CLI with --traditional_nms on a seeded res50_custom
    .ckpt over the first FLAGS_EVAL_IMAGES images of custom_dataset/ (finite
    rows); the detect CLI with --traditional_nms --save_lincomb on two seeded
    PNGs (drawn at their shapes, a lincomb_<name> grid of 4 x 8 prototypes
    for each, kernel 1 not launched); the train CLI with --backbone_weight
    (a seeded backbone .pth) and --remat on res50_custom at FLAGS_CLI_IMG for
    FLAGS_CLI_STEPS steps (the 'Backbone is initiated' line, finite
    losses)."""
    import tempfile
    import torch
    from yolact_minimal_torch.config import get_config
    from yolact_minimal_torch.pipeline import Detector
    with tempfile.TemporaryDirectory() as tmp:
        out = _run_cli('eval', ['--weight', _seeded_ckpt(dev, 'res50_custom', tmp), '--img_size',
                                str(IMG), '--traditional_nms', '--val_num',
                                str(FLAGS_EVAL_IMAGES)], ROOT)
    _check('traditional_nms: True' in out, 'the eval CLI did not take --traditional_nms')
    rows = _table_rows(out)
    print(f'eval CLI --traditional_nms, res50_custom {IMG}, the first {FLAGS_EVAL_IMAGES} '
          f'images of custom_dataset/, float32: box row {rows["box"]}, mask row {rows["mask"]}')

    launches, shapes, grids = _detect_cli(dev, ['--traditional_nms', '--save_lincomb'])
    _check(not any(launches.values()), f'the traditional detect CLI launched {launches}')
    _check(grids.keys() == shapes.keys() and all(g == (IMG, 2 * IMG, 3) for g in grids.values()),
           f'--save_lincomb wrote the grids {grids}')
    print(f'detect CLI --traditional_nms --save_lincomb on {len(shapes)} PNGs: drawn images at '
          f'their input shapes; lincomb grids {grids}; launches {launches}')

    with tempfile.TemporaryDirectory() as cwd:
        det = Detector(get_config('res50_custom', img_size=FLAGS_CLI_IMG), device='cpu', seed=7)
        backbone = {k[len('backbone.'):]: v for k, v in det.model.state_dict().items()
                    if k.startswith('backbone.')}
        weight = os.path.join(cwd, 'seeded_backbone.pth')
        torch.save(backbone, weight)
        del det
        out = _run_cli('train', _train_cli_args(FLAGS_CLI_IMG, FLAGS_CLI_STEPS) +
                       ['--backbone_weight', weight, '--remat'], cwd)
    _check(f'Backbone is initiated with {weight}.' in out,
           f'the train CLI did not read the backbone:\n{out[-2000:]}')
    _check('remat: True' in out, 'the train CLI did not take --remat')
    print(f'train CLI res50_custom {FLAGS_CLI_IMG}/b8 --backbone_weight (seeded, '
          f'{len(backbone)} tensors) --remat, {FLAGS_CLI_STEPS} steps: printed "Backbone is '
          f'initiated"; logged losses {_logged_losses(out, "the train CLI")}')


# --- phase 10: data parallelism ---------------------------------------------------

# A world of DP_PROCESSES gloo processes, all on cuda:0 (NCCL refuses two
# ranks on one card; gloo all-reduces CUDA tensors through the host), each
# with TRAIN_BS / DP_PROCESSES rows of phase 7's batches, DP_STEPS steps of
# res50_coco (float32, TF32 off, base_lr DP_LR so that an update is visible
# beside float32 noise, as tests/test_torch_cuda.py's train steps) and of
# swin_tiny_coco (bf16, stochastic depth at its 0.2), and one res50 step in
# float64; each process's timeout. Limits: res50 float32, the losses within
# DP_LOSS_RTOL and the running statistics within DP_BN_REL_TOL of their
# largest magnitude (tests/test_torch_cuda.py's card-vs-CPU float32 limits);
# res50 float64, each gradient and updated parameter within DP_F64_TOL of its
# norm (tests/test_torch_train_step.py's RES50_TOL with no noise floor: the
# CPU's two-process float64 gradients lie within 4e-13). float32 updates are
# only printed: at a random init BatchNorm amplifies float32 rounding until a
# world's step (other convolution batches, other sums) differs from one
# process's as much as either differs from float64 (0.987 of
# test_torch_cuda.py's allowance, measured on an H100 80GB HBM3 at 700 W).
# swin's losses within one bf16 ulp (SWIN_BF16_REL_TOL).
DP_WORKER_FLAG = '--dp-worker'
DP_PROCESSES, DP_STEPS, DP_LR, DP_TIMEOUT = 2, 2, 0.1, 300
DP_LOSS_RTOL = 1e-4
DP_BN_REL_TOL = 1e-3
DP_F64_TOL = 1e-5
# (config, dtype, steps) of the world
DP_RUNS = (('res50_coco', 'float32', DP_STEPS), ('res50_coco', 'float64', 1),
           ('swin_tiny_coco', 'bfloat16', DP_STEPS))


def _dp_state(name, dev, dtype):
    """The seed-0 train state of `name` in `dtype` (res50 at base_lr
    DP_LR)."""
    from yolact_minimal_torch.config import get_config
    from yolact_minimal_torch.train_state import create_train_state
    res50 = name.startswith('res50')
    cfg = get_config(name, mode='train', img_size=IMG, train_bs=TRAIN_BS,
                     compute_dtype='float32' if dtype == 'float64' else dtype,
                     **(dict(base_lr=DP_LR) if res50 else {}))
    state = create_train_state(cfg, dev, seed=0)
    if dtype == 'float64':
        state.model.double()
    return state


def _dp_batch(batch, dtype):
    import numpy as np
    return dict(batch, image=batch['image'].astype(np.float64)) if dtype == 'float64' else batch


def dp_worker(spec_path):
    """One process of the gloo world (run as `chip_smoke.py --dp-worker SPEC`,
    YOLACT_* set): joins through parallel/mesh.py, takes its rows of each
    batch in SPEC's npz, runs each of DP_RUNS from a fresh state with the
    launch counters at 0 before, and writes the first step's losses summed
    over the world, per-tensor checksums of the weights and the launches to
    out_{process}.npz; process 0 also res50's state_dict and gradients after
    its first step."""
    import numpy as np
    import torch
    from yolact_minimal_torch.parallel import mesh
    from yolact_minimal_torch.train_state import train_step
    with open(spec_path) as f:
        spec = json.load(f)
    _check(mesh.initialize_distributed(backend='gloo', device='cuda'),
           'YOLACT_COORDINATOR is not set')
    try:
        rank, world = mesh.process_index(), mesh.process_count()
        dev = mesh.local_device('cuda')
        data = np.load(spec['batches'])
        rows = slice(rank * TRAIN_BS // world, (rank + 1) * TRAIN_BS // world)
        batches = [{k[len(f'{i}/'):]: data[k][rows] for k in data.files
                    if k.startswith(f'{i}/')} for i in range(DP_STEPS)]
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        out = {}
        for name, dtype, steps in DP_RUNS:
            run = f'{name}/{dtype}'
            state = _dp_state(name, dev, dtype)
            counters = _counters(name)
            _zero_counters(counters)
            losses = train_step(state, _dp_batch(batches[0], dtype))
            out[f'{run}/losses'] = mesh.global_sum(torch.stack(losses)).double().cpu().numpy()
            if name.startswith('res50') and rank == 0:
                for k, v in state.model.state_dict().items():
                    out[f'{run}/state/{k}'] = v.cpu().numpy().copy()
                for k, p in state.model.named_parameters():
                    out[f'{run}/grad/{k}'] = p.grad.cpu().numpy().copy()
            for batch in batches[1:steps]:
                train_step(state, _dp_batch(batch, dtype))
            torch.cuda.synchronize()
            launches = _read_counters(counters)
            out[f'{run}/launches'] = np.array(list(launches.values()))
            out[f'{run}/kernels'] = np.array(list(launches))
            out[f'{run}/checksum'] = np.array([float(t.double().sum()) for t in
                                               state.model.state_dict().values()])
            del state
            torch.cuda.empty_cache()
        np.savez(os.path.join(spec['out'], f'out_{rank}.npz'), **out)
    finally:
        mesh.destroy()
    return 0


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def _spawn_world(spec_path, n):
    """n processes of dp_worker; fails if one exits nonzero or outlives
    DP_TIMEOUT (all are killed)."""
    port = _free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, YOLACT_COORDINATOR=f'127.0.0.1:{port}',
                   YOLACT_NUM_PROCESSES=str(n), YOLACT_PROCESS_ID=str(rank),
                   PYTHONPATH=os.pathsep.join(p for p in (ROOT, os.environ.get('PYTHONPATH'))
                                              if p))
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                       DP_WORKER_FLAG, spec_path], cwd=ROOT, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=DP_TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    _check(all(p.returncode == 0 for p in procs), 'a process of the gloo world failed:\n' +
           '\n---\n'.join(f'process {i} exited {p.returncode}:\n{log[-3000:]}'
                          for i, (p, log) in enumerate(zip(procs, logs))))


def _one_process_steps(dev, batch):
    """The world's references on the global batch, in this process: each of
    DP_RUNS's first step. Returns {config/dtype: (losses, state_dict,
    gradients)}, the last two for res50 only."""
    import torch
    from yolact_minimal_torch.train_state import train_step
    refs = {}
    for name, dtype, _ in DP_RUNS:
        state = _dp_state(name, dev, dtype)
        losses = [float(t) for t in train_step(state, _dp_batch(batch, dtype))]
        sd = grads = None
        if name.startswith('res50'):
            sd = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
            grads = {k: p.grad.detach().cpu() for k, p in state.model.named_parameters()}
        refs[f'{name}/{dtype}'] = (losses, sd, grads)
        del state
        torch.cuda.empty_cache()
    return refs


def _rel_gaps(ours, ref):
    return [abs(a - b) / abs(b) for a, b in zip(ours, ref)]


def phase_dp_train(dev, batches):
    """The two-process gloo world against the one-process steps on the same
    global batch in this call (limits above DP_WORKER_FLAG). res50 float32:
    the first step's four losses and the running statistics; res50 float64:
    every gradient and updated parameter; swin bf16, drop_path on: the
    losses, and kernels 3 and 4 and kernel 3's backward kernel launched 12,
    1 and 12 times a step in each process. Every process ends with the same
    weights."""
    import tempfile
    import numpy as np
    import torch
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        refs = _one_process_steps(dev, batches[0])
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(os.path.join(tmp, 'batches.npz'), **{f'{i}/{k}': v for i, b in
                                                      enumerate(batches) for k, v in b.items()})
        spec = os.path.join(tmp, 'spec.json')
        with open(spec, 'w') as f:
            json.dump(dict(batches=os.path.join(tmp, 'batches.npz'), out=tmp), f)
        _spawn_world(spec, DP_PROCESSES)
        outs = [dict(np.load(os.path.join(tmp, f'out_{r}.npz'))) for r in range(DP_PROCESSES)]
    out = outs[0]
    for name, dtype, _ in DP_RUNS:
        for other in outs[1:]:
            _check(np.array_equal(other[f'{name}/{dtype}/checksum'],
                                  out[f'{name}/{dtype}/checksum'], equal_nan=True),
                   f'{name} {dtype}: the processes of the gloo world hold different weights')
    state = lambda run, k: torch.from_numpy(out[f'{run}/state/{k}'])
    # res50 float32: losses and running statistics
    run = 'res50_coco/float32'
    one, sd32, _ = refs[run]
    rel = _rel_gaps(out[f'{run}/losses'], one)
    _check(max(rel) <= DP_LOSS_RTOL, f'res50 float32 gloo world losses '
                                     f'{out[f"{run}/losses"].tolist()} against one process {one}')
    worst_bn, update_ratio = 0.0, (0.0, '')
    _, sd64, _ = refs['res50_coco/float64']
    for k, ref in sd32.items():
        got = state(run, k)
        if k.endswith('num_batches_tracked'):
            _check(torch.equal(got, ref), f'{k}: {got} against {ref}')
        elif k.endswith(('running_mean', 'running_var')):
            worst_bn = max(worst_bn, ((got - ref).abs().max() /
                                      ref.abs().max().clamp(min=1e-30)).item())
        else:   # printed only: tests/test_torch_cuda.py's float32 allowance
            allowed = 2 * (sd64[k].float() - ref).norm().item() + 1e-5 * ref.norm().item()
            update_ratio = max(update_ratio, ((got - ref).norm().item() / max(allowed, 1e-30), k))
    _check(worst_bn <= DP_BN_REL_TOL, f'res50 gloo world running statistics {worst_bn:.3g} of '
                                      f'max off the one-process step (> {DP_BN_REL_TOL})')
    # res50 float64: gradients and updated parameters
    run64 = 'res50_coco/float64'
    one64, _, grads64 = refs[run64]
    rel64 = _rel_gaps(out[f'{run64}/losses'], one64)
    _check(max(rel64) <= DP_LOSS_RTOL, f'res50 float64 gloo world losses against one process: '
                                       f'{rel64}')
    worst64, over = (0.0, ''), []
    for what, ref_of, got_of in (
            ('gradient', grads64, lambda k: torch.from_numpy(out[f'{run64}/grad/{k}'])),
            ('updated parameter', {k: sd64[k] for k in grads64}, lambda k: state(run64, k))):
        for k, ref in ref_of.items():
            gap, norm = (got_of(k) - ref).norm().item(), ref.norm().item()
            worst64 = max(worst64, (gap / max(norm, 1e-300), f'{what} {k}'))
            if gap > DP_F64_TOL * norm:
                over.append(f'{what} {k}: {gap:.3g} of {norm:.3g}')
    _check(not over, 'res50 float64 gloo world: ' + '; '.join(over[:10]))
    # swin bf16
    run = 'swin_tiny_coco/bfloat16'
    one_swin = refs[run][0]
    srel = _rel_gaps(out[f'{run}/losses'], one_swin)
    _check(max(srel) <= SWIN_BF16_REL_TOL, f'swin gloo world losses '
                                           f'{out[f"{run}/losses"].tolist()} against {one_swin}')
    by_process = {}
    for rank, o in enumerate(outs):
        for name, dtype, steps in DP_RUNS:
            launches = dict(zip(o[f'{name}/{dtype}/kernels'].tolist(),
                                o[f'{name}/{dtype}/launches'].tolist()))
            by_process[f'{name}/{dtype}/process{rank}'] = launches
            if name.startswith('swin'):
                want = {k: steps * c for k, c in TRAIN_LAUNCHES_PER_STEP.items()}
                _check(all(launches[k] == c for k, c in want.items())
                       and launches['attn_block'] == launches['swin_block'] == 0,
                       f'swin gloo process {rank}: expected {want} over {steps} steps, got '
                       f'{launches}')
    print(f'gloo world of {DP_PROCESSES} processes on cuda:0, {TRAIN_BS // DP_PROCESSES} rows '
          f'each of phase 7\'s batches (global {TRAIN_BS}, {IMG}); the same weights in every '
          f'process')
    print(f'  res50_coco float32 (TF32 off, base_lr {DP_LR}): first step losses '
          f'{out["res50_coco/float32/losses"].tolist()} against one process {one}, largest '
          f'relative gap {max(rel):.3g} (<= {DP_LOSS_RTOL}); running statistics within '
          f'{worst_bn:.3g} of their largest magnitude (<= {DP_BN_REL_TOL}); updated parameters '
          f'(printed only) at most {update_ratio[0]:.3g} of twice the one-process float32 step\'s '
          f'distance from float64 plus 1e-5 of the norm ({update_ratio[1]})')
    print(f'  res50_coco float64: losses within {max(rel64):.3g}; gradients and updated '
          f'parameters within {worst64[0]:.3g} of their norm ({worst64[1]}; <= {DP_F64_TOL})')
    print(f'  swin_tiny_coco bf16, drop_path 0.2: first step losses '
          f'{out[f"{run}/losses"].tolist()} against one process {one_swin}, largest relative '
          f'gap {max(srel):.3g} (<= {SWIN_BF16_REL_TOL:.3g}); launches per process ' + ', '.join(
              f'{p}: {c}' for p, c in by_process.items() if p.startswith('swin')))


def phase_dp_train_cli():
    """`python -m yolact_minimal_torch.train` in a one-process nccl world
    (YOLACT_COORDINATOR set) on res50_custom at FLAGS_CLI_IMG for
    FLAGS_CLI_STEPS steps: the 'Joined distributed runtime' line and finite
    logged losses."""
    import tempfile
    with tempfile.TemporaryDirectory() as cwd:
        out = _run_cli('train', _train_cli_args(FLAGS_CLI_IMG, FLAGS_CLI_STEPS), cwd,
                       env=dict(YOLACT_COORDINATOR=f'127.0.0.1:{_free_port()}'))
    joined = re.findall(r'Joined distributed runtime: .*', out)
    _check(joined and 'backend nccl' in joined[0], f'no nccl join line:\n{out[-2000:]}')
    print(f'train CLI in a one-process nccl world, res50_custom {FLAGS_CLI_IMG}/b8, '
          f'{FLAGS_CLI_STEPS} steps: "{joined[0]}"; logged losses '
          f'{_logged_losses(out, "the nccl train CLI")}')


def phase_dp_eval(dev, plain_rows):
    """`eval.main([... '--data_parallel', '1'])` in this process on a seeded
    res50_custom .ckpt at IMG over custom_dataset/ (phase 5's weights and
    images), the counters at 0 before: its table equals phase 5's plain CLI
    table row for row, kernel 1 launched once a batch; then `python -m
    yolact_minimal_torch.eval --data_parallel 2` must exit nonzero saying
    that there is one CUDA device."""
    import io
    import tempfile
    import torch
    from yolact_minimal_torch import eval as port_eval
    data = ['--val_imgs', os.path.join(ROOT, 'custom_dataset', 'images'),
            '--val_ann', os.path.join(ROOT, 'custom_dataset', 'annotations.json')]
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = _seeded_ckpt(dev, 'res50_custom', tmp)
        counters = _counters('res50_custom')
        _zero_counters(counters)
        tf32 = torch.backends.cudnn.allow_tf32
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                port_eval.main(['--weight', ckpt, '--img_size', str(IMG), '--data_parallel',
                                '1', *data])
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        launches = _read_counters(counters)
        rows = _table_rows(buf.getvalue())
        _check(rows == plain_rows, f'--data_parallel 1 table {rows} differs from the plain '
                                   f'eval CLI\'s {plain_rows}')
        batches = -(-48 // EVAL_BS)
        _check(launches['suppression_iou_max'] == batches and launches['mask_finalize'] == 0,
               f'--data_parallel 1 launched {launches}, expected kernel 1 once a batch')
        proc = subprocess.run([sys.executable, '-m', 'yolact_minimal_torch.eval', '--weight',
                               ckpt, '--img_size', str(IMG), '--data_parallel', '2', *data],
                              cwd=ROOT, capture_output=True, text=True, timeout=300,
                              env=dict(os.environ, PYTHONPATH=ROOT))
    said = (proc.stdout + proc.stderr).strip().splitlines()[-1:]
    _check(proc.returncode != 0 and said and 'this machine has 1 CUDA device' in said[0],
           f'--data_parallel 2 exited {proc.returncode}: {proc.stderr[-2000:]}')
    print(f'eval CLI --data_parallel 1 (in this process), res50_custom {IMG}, 48 images: table '
          f'equal to phase 5\'s plain CLI row for row (box {rows["box"]}, mask {rows["mask"]}); '
          f'launches {launches}; --data_parallel 2 exited {proc.returncode}: "{said[0]}"')


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is false; this script '
              'needs an NVIDIA card', file=sys.stderr)
        return 2
    import yolact_minimal_torch  # noqa: F401  (fails outside a checkout)
    if len(sys.argv) == 3 and sys.argv[1] == DP_WORKER_FLAG:
        return dp_worker(sys.argv[2])
    dev = torch.device('cuda', 0)
    t0 = time.perf_counter()

    def done(phase):
        nonlocal t0
        torch.cuda.empty_cache()
        print(f'phase {phase}: {time.perf_counter() - t0:.2f} s', flush=True)
        t0 = time.perf_counter()
    phase_env()
    done('1 (environment)')
    phase_build()
    done('2 (build)')
    kernels = phase_kernels(dev)
    by_path = phase_main_paths(dev)
    done('3 (kernel table)')
    by_path['res50_coco/cli'] = phase_detect_cli(dev)
    done('4 (detect CLI)')
    eval_rows = phase_eval(dev, kernels[0])
    done('5 (eval)')
    phase_numerics(dev, 'res50_coco', ('composed',))
    phase_numerics(dev, 'swin_tiny_coco', tuple(SWIN_PATHS))
    done('6 (numerics)')
    batches = _train_batches(TRAIN_BATCHES)
    by_path['swin_tiny_coco/mixed train bf16 2 steps'] = phase_train_mixed(dev, batches)
    phase_train_cli()
    done('7 (training)')
    phase_export(dev)
    done('8 (export and video)')
    phase_flags(dev)
    done('9 (flags)')
    phase_dp_train(dev, batches[:DP_STEPS])
    phase_dp_train_cli()
    phase_dp_eval(dev, eval_rows['res50_custom'])
    done('10 (data parallelism)')
    _add_launches(kernels, by_path)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
