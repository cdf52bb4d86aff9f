#!/usr/bin/env python
"""Drive the PyTorch/CUDA port (yolact_minimal_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero:
  1. the card's name and power limit, torch's CUDA version, nvcc's version,
     whether triton, cv2 and PIL import;
  2. build the CUDA kernels from yolact_minimal_torch/csrc/ (nvcc, sm_90a,
     one process per source, started together);
  3. each kernel against its plain PyTorch version on the card, at the main
     paths' shapes, timed with CUDA events (median of 20 after warm-up); the
     four swin kernels at each of the four stage shapes, in bf16 and float32,
     shifted and unshifted (the whole-block kernel with the padded map's
     rowmask and once without), the two block kernels beside the times of
     what they replace (the whole-block kernel also beside the block as
     PyTorch's own calls, and at C = 768 each of its six launches' device
     time), the MLP kernel beside a composition of PyTorch calls,
     the window-attention, MLP and both block kernels with their launch
     geometry and a check that two launches agree bit for bit; the
     suppression kernel with its launch geometry on input (a), a fixture with
     invalid slots and zero-area boxes, and (b), all valid, exact on both and
     timed with events and in device time; the mask
     kernel with its launch geometry on input (a), a fixture with crop, and
     (b), the same without, and after phase 4 on (c), the res50 path's own
     slate, each timed with events and in device time; kernels 1 and 2 also
     beside a composition of PyTorch calls (exact for kernel 1, within the
     mask mismatch limit for kernel 2), timed;
  3b. the detect CLI (yolact_minimal_torch.detect.main) on two seeded PNGs of
     different shapes with a seeded res50_coco .pth, from a temporary working
     directory: both drawn images must come back at their input shapes;
  3c. the eval path: seeded res50_custom and res101_custom Detectors (544,
     float32) written as .ckpt files by the port's save_checkpoint, then
     `python -m yolact_minimal_torch.eval --weight W --img_size 544` on each
     over the 48 images of custom_dataset/ (exit 0, box and mask rows
     finite), res50_custom once more with --coco_api (both jsons, the 24
     COCO stats); evaluate() in this process with the launch counters set
     to 0 before (kernel 1 once a batch, kernel 2 never), eval img/s with
     the host-tail share beside the card's name and power limit; the card's
     float32 table (TF32 off) against the CPU's on the first 8 images;
  4. a main path at full width: res50_coco at 544, batch 16, seeded random
     weights, bf16: Detector.detect_fixed for a few batches (img/s, host
     clock, untraced), then Detector.__call__ + postprocess_host on two
     images; the launch counters are set to 0 before and read after, and the
     path's kernels must all have been launched;
  5. where detect_fixed's device time goes: a few more calls of the same
     Detector on the same images under torch.profiler, device time by kernel
     group, and the device's busy share against phase 4's untraced host time;
  6. numerics on one image: float32 with TF32 off, the card's network
     outputs against the port's own CPU run, and the card's postprocess and
     masks (kernels) against the CPU's plain versions on the same head
     outputs; then phase 4's bf16 network and slate against the card's
     float32 run;
  7. phases 4-6 again for swin_tiny_coco (544, batch 16, bf16), four times
     on one seeded Detector switched between its block forms: 'composed'
     (window attention and the MLP half-block, 12 launches each a forward),
     'attn_block' (the attention half-block kernel and the MLP half-block, 12
     each), 'whole' (the whole-block kernel, 12) and 'mixed' (whole at stage
     0, attn_block at stage 1, composed at stages 2-3); each path must launch
     its forms' kernels
     and no other swin kernel, and its float32 network outputs are
     also held to the composed form's on the card. Then each swin stage's
     blocks alone in each form, timed with CUDA events;
  7b. swin_large_coco (12x12 windows): kernel 3's 144-token kernels at the
     four stage shapes of 544/b16, bf16 and float32, shifted and unshifted,
     and kernel 4 on the same stages' rows (C = 192-768 fused, 1536 in three
     launches), bf16 and float32, each against its plain version and twice
     bit-equal in bf16, timed (events and device time) beside its bound;
     kernel 3's bf16 backward at 144 tokens must refuse; detect_fixed at b16
     bf16 and b2 float32 with the launch counters set to 0 just before (24
     launches each of kernels 3 and 4, none of 5-6), and one profiled bf16
     call's launches and device ms by kernel beside the path's bound;
  8. training: (a) kernels 3-6 under autograd at swin_tiny's training
     shapes (544, train_bs 8, bf16; the block kernels on the shifted windows
     of the padded map): forward and gradients against the plain
     version's autograd, forward and backward (kernel 3's backward kernel,
     the plain recompute for kernels 4-6) timed with CUDA events and in
     device time; then kernel 3's backward kernel beside the plain recompute
     it replaced at batches 8 and 64, shifted: gradient gaps, times and
     bound; (b) res50_coco at 544, train_bs 8
     on custom_dataset/ through the port's TrainLoader, float32 (TF32 off)
     and bf16, and (c) swin_tiny_coco in bf16: train_step with the counters
     set to 0 before and read after (swin: 12 launches of kernel 3 and of
     its backward kernel and 1 of kernel 4 a step; res50: none of the
     backward kernel), finite losses, ms a step, img/s, peak memory and the
     busy share of one profiled step; (d) `python -m
     yolact_minimal_torch.train` on res50_custom at 256 for 220 steps with a
     validation at step 200: the logged loss falls, both checkpoints are
     written, the box and mask rows are printed; (e) swin_tiny_coco in the
     'mixed' forms: two bf16 steps launching kernels 6 / 5 / 3 / 4 exactly
     1 / 2 / 9 / 0 times a step and kernel 3's backward kernel 9 times, with
     finite losses, then one float32 step
     against the 'composed' step from the same init (first losses within
     1e-4, the gradients' distance printed);
  9. export and video: (a) `python -m yolact_minimal_torch.export` on a
     seeded res50_coco .ckpt (544, float32, batch 1) must print the parity
     line, and `python -m yolact_minimal_torch.detect_with_export --image`
     must draw two seeded PNGs at their shapes; (b) swin_tiny_coco (544,
     bf16, batch 8) in the 'mixed' forms through deploy.export_model, loaded
     in a fresh process that imports nothing of models/: one call must launch
     kernels 3-6 as the 'mixed' forward does and no other kernel, its outputs
     must equal the live model's bit for bit, and the numpy tail on them must
     agree with detect_postprocess_batch on the card; (c) a seeded 11-frame
     mp4 through `detect --video --video_bs 4` and the driver's `--video`:
     11 frames at the clip's size each; (d) each artifact call against the
     live forward (CUDA events, median of 20, in turns; device time), the
     export seconds, the CLIs' frame rates.
  10. the flags: (a) `python -m yolact_minimal_torch.eval --traditional_nms`
     on a seeded res50_custom .ckpt over the first 16 images of
     custom_dataset/ (exit 0, finite rows, img/s) after the g++ build of csrc/nms.cc, then one batch in this
     process (kernel 1 not launched; candidates per image; the host tail's
     ms); (b) the detect CLI with --traditional_nms --save_lincomb on two
     seeded PNGs (images at their shapes, the lincomb grids written); (c) a
     swin_tiny_coco bf16 Detector with traditional_nms: kernels 3 and 4 12
     times, kernel 1 never, its slate equal to the numpy tail on the card's
     raw outputs; (d) train_step with and without --remat, res50_coco and
     swin_tiny_coco, bf16, 544/b8: the losses of the first step within 1e-3,
     ms a step, peak memory, the launches of kernels 3 and 4 and of kernel
     3's backward kernel (24, 2 and 12 a remat swin step; none of the last
     in res50); (e) the train CLI with --backbone_weight and --remat.
  11. data parallelism: (a) a world of two gloo processes on cuda:0
     (`chip_smoke.py --dp-worker`, each with a timeout), 4 rows each of phase
     8's first two batches: res50_coco float32 (TF32 off, base_lr 0.1) and
     swin_tiny_coco bf16 (drop_path on) two steps each, res50_coco float64
     one, against the one-process step on the same global batch in this
     process: res50's first-step losses within 1e-4 and its running
     statistics within 1e-3 of their largest magnitude (float32), its
     gradients and updated parameters within 1e-5 of their norm (float64);
     swin's losses within one bf16 ulp; the same
     weights in both processes; kernels 3 and 4 and kernel 3's backward
     kernel 12, 1 and 12 times a step in each; (b) `python -m yolact_minimal_torch.train` in a one-process nccl
     world (YOLACT_COORDINATOR) on res50_custom at 256 for 11 steps: the
     join line, finite losses, its t_step beside phase 8d's; (c) the eval
     CLI with --data_parallel 1 in this process over phase 3c's weights and
     images: phase 3c's table row for row, kernel 1 once a batch; and
     `--data_parallel 2` must exit nonzero saying there is one CUDA device;
     (d) the phase's seconds.
The line before the last is a JSON object {"kernels": [...]}; the last is
{"ok": true, "device": {...}}. Needs no JAX, flax or cv2.

In the kernels line `max_abs_err` is the largest |kernel - plain| over the
output; for the bool masks of mask_finalize that is 0 or 1, and the stated
tolerance holds `mismatch_frac`, the share of mask pixels that differ.
suppression_iou_max's and mask_finalize's `ms` are input (a); `inputs` has
all of each one's inputs. `launches` counts
the res50_coco path for kernels 1-2, the composed
swin_tiny_coco path for kernels 3-4, the 'attn_block' path for kernel 5 and
the 'whole' path for kernel 6; `launches_by_path` has all six paths (the
CLI's, res50_coco/cli, and the eval path's, res50_custom/eval, too), and
for kernels 3-6 the swin artifact's call, swin_tiny_coco/export_mixed.
Kernels 3-6 also carry `train` (their launches a
'composed' and a 'mixed' training step and, per stage, forward and backward
ms under autograd), `backward_ms` and `backward_device_ms` (stage 0) and
`grad_rel_err` (the worst stage). The rows window_attention_n144 and
swin_mlp_wide are phase 7b's (stage 0 and C = 768 at the top level,
`path_device_ms` and `path_bound_ms` over one bf16 call, `launches` of that
call). `launches_by_path` has the four training
paths too (res50_coco/train_float32, res50_coco/train_bfloat16,
swin_tiny_coco/train_bfloat16, swin_tiny_coco/train_mixed_bfloat16, over 8,
8, 8 and 2 steps), and phase 10's: the traditional paths
(res50_custom/eval_traditional, res50_coco/cli_traditional,
swin_tiny_coco/traditional) and the remat pairs
({res50_coco,swin_tiny_coco}/train_{plain,remat}_bfloat16, over 6 steps), and phase 11's:
each process of the gloo world ({res50_coco/dp_train_float32,
res50_coco/dp_train_float64, swin_tiny_coco/dp_train_bfloat16}_process{0,1},
over 2, 1 and 2 steps) and the eval
CLI with --data_parallel 1 (res50_custom/eval_dp1). Kernel 3 also carries
`backward_kernel` (phase 8a's per-stage times and gaps of its backward
kernel beside the plain recompute) and `backward_launches_by_path`
(the backward kernel's launches on each path that counts them). `bound_ms` is held to the peak named in `peak`. The swin kernels' top-level numbers are those of the
stage-0 shape in bf16; `per_stage` lists all four. `ms` is CUDA events
around one call, the wrapper's host work included; the suppression,
window-attention, mask and both block kernels also have `device_ms`, the
kernel's device time under torch.profiler (window attention also SDPA's,
`library_device_ms`), since the host's launch overhead sets a floor under
the event time.
"""
import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): device memory rate; float32 outside the
# tensor cores (kernels 1-2 compute in float32) and dense bf16 on the tensor
# cores (kernels 3-4 on the main path take bf16).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {'fp32 cuda cores, 67 TFLOP/s': 67e12,
              'bf16 tensor cores, 989 TFLOP/s': 989e12}
FP32_PEAK, BF16_PEAK = PEAK_FLOPS

IMG, BATCH, SLOTS = 544, 16, 100
SCORE_THRE = 0.002      # below the ~1/81 random-init scores: the slate fills
# Float32 card-vs-CPU limits for phase 5: convolutions sum in another order
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
PROFILE_ITERS = 5
# The eval phase: the configs the eval CLI runs at IMG on custom_dataset/ (48
# images, cfg.val_bs 8), and the images on which the card's table is held
# to the CPU's.
EVAL_CONFIGS = ('res50_custom', 'res101_custom')
EVAL_BS = 8
EVAL_CPU_IMAGES = 8
# The swin kernels against their plain versions, as a share of the plain
# output's largest magnitude. float32: both sum up to 3072 products, in
# another order. bf16: both round at the same places, so a difference is a
# float32 value that rounds to the other bf16 neighbour, at most one ulp
# (2^-7 of the magnitude).
SWIN_F32_REL_TOL = 1e-5
SWIN_BF16_REL_TOL = 2.0 ** -7
# swin_tiny at 544, batch 16: (windows B*nW, windows per image nW, C, heads,
# MLP rows B*h*w) of stages 0-3. The windows tile the padded map (140, 70,
# 35, 21), the MLP rows the unpadded one (136, 68, 34, 17).
SWIN_STAGES = ((6400, 400, 96, 3, 295936), (1600, 100, 192, 6, 73984),
               (400, 25, 384, 12, 18496), (144, 9, 768, 24, 4624))
SWIN_DEPTHS = (2, 2, 6, 2)
# (side of the stage's feature map, side padded to a multiple of the window)
SWIN_MAPS = ((136, 140), (68, 70), (34, 35), (17, 21))
# swin_large (window 12) at 544, batch 16: (windows B*nW, windows per image
# nW, C, heads, MLP rows B*h*w) of stages 0-3, and (side, padded side).
SWIN_LARGE_STAGES = ((2304, 144, 192, 6, 295936), (576, 36, 384, 12, 73984),
                     (144, 9, 768, 24, 18496), (64, 4, 1536, 48, 4624))
SWIN_LARGE_MAPS = ((136, 144), (68, 72), (34, 36), (17, 24))
# The swin kernels each block form launches, once per block and forward.
SWIN_KERNELS = ('window_attention', 'swin_mlp', 'attn_block', 'swin_block')
SWIN_FORM_LAUNCHES = {'composed': ('window_attention', 'swin_mlp'),
                      'attn_block': ('attn_block', 'swin_mlp'),
                      'whole': ('swin_block',)}
# The swin main paths: the form of each stage's blocks. 'mixed' is the
# whole-block kernel at stage 0, the attention half-block kernel at stage 1
# and the composed form after: what the stage table (phase_stage_forms)
# favoured with the float32-product window-attention kernel. With the
# tensor-core one the composed and attention half-block forms trade places
# at stages 1-2 from run to run, so 'mixed' is not known to be the fastest
# mix (PERF.md, sections 5 and 6); it stays the path that drives kernels 5
# and 6 in one forward.
SWIN_PATHS = {'composed': ('composed',) * 4, 'attn_block': ('attn_block',) * 4,
              'whole': ('whole',) * 4,
              'mixed': ('whole', 'attn_block', 'composed', 'composed')}
# The training phase: swin_tiny at 544, train_bs 8: (windows B*nW, windows
# an image nW, C, heads, MLP rows B*h*w) of stages 0-3; the steps each
# training path takes (2 of them warm-up); the loader's worker processes;
# the train CLI's image size, steps and validation step. Kernel 3 runs in all
# 12 blocks of a training step, kernel 4 only where stochastic depth is off
# (block 0 of stage 0).
TRAIN_BS = 8
TRAIN_SWIN_STAGES = ((3200, 400, 96, 3, 147968), (800, 100, 192, 6, 36992),
                     (200, 25, 384, 12, 9248), (72, 9, 768, 24, 2312))
TRAIN_STEPS = 6
TRAIN_WORKERS = 6
TRAIN_CLI_IMG, TRAIN_CLI_STEPS, TRAIN_CLI_VAL = 256, 220, 200
TRAIN_LAUNCHES_PER_STEP = {'window_attention': 12, 'swin_mlp': 1,
                           'window_attention_backward': 12}
# The 'mixed' forms in training, as the JAX block routes them: stage 0 'whole'
# runs kernel 6 in block 0 (rate 0) and falls back to kernel 3 and the plain
# MLP in block 1; stage 1 'attn_block' runs kernel 5 in both blocks; stages
# 2-3 'composed' run kernel 3 in their 8 blocks; kernel 4 nowhere (every
# block after block 0 has a nonzero drop_path rate). Kernel 3's backward
# kernel runs once a launch of kernel 3, in bf16 only.
MIXED_TRAIN_LAUNCHES_PER_STEP = {'swin_block': 1, 'attn_block': 2, 'window_attention': 9,
                                 'swin_mlp': 0, 'window_attention_backward': 9}
# Float32 network outputs of two block forms on the card: the same function
# up to summation order, each output within 1e-4 of its largest magnitude.
FORM_REL_TOL = 1e-4
# Kernel groups of the profile; first match wins, on the CUDA kernel names
# that torch.profiler reports.
GROUPS = (
    ('suppression kernel', r'suppression_kernel'),
    ('mask_finalize kernel', r'mask_finalize_kernel'),
    ('window_attention kernel', r'window_attention_(n144_)?(bf16|f32)_kernel'),
    ('swin_mlp kernel', r'mlp_bf16_sm90_kernel|mlp_f32_kernel|mlp_wide_\w+_kernel'),
    ('attn_block kernel', r'attn_block_\w*kernel|attn_heads_\w*kernel|proj_rows_\w*kernel'),
    ('swin_block kernel', r'swin_block_\w*kernel'),
    ('layer norm', r'layer_norm|LayerNorm'),
    ('convolution / gemm', r'conv|gemm|xmma|cutlass|cudnn|sm90_|implicit|nvjet|cublas'),
    ('copy / cast / roll / pad', r'copy_kernel|roll_cuda|constant_pad|CatArray'),
    ('sort / top-k', r'sort|radix|topk|Sort'),
    ('batch norm', r'batch_norm|bn_'),
    ('gather / index', r'index|gather|scatter'),
    ('elementwise / reduce', r'elementwise|reduce|vectorized|unrolled'),
)


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


def _device_ms(fn, iters=20):
    """Device time of one call of fn: the CUDA kernels it launches, summed
    over `iters` calls under torch.profiler, over `iters`. Unlike _time_ms it
    leaves out the host's launch overhead, which sets a floor under a small
    kernel's event time. A trace that holds no kernel at all (seen for
    ~10 us calls) measured nothing and is taken again, up to four times."""
    import torch
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
        if total > 0:
            break
    _check(total > 0, 'torch.profiler recorded no kernel of a call that launches one')
    return total / iters / 1e3


def _bound_ms(n_bytes, n_flops, peak):
    """The least ms the card could take: bytes over the memory rate or
    operations over PEAK_FLOPS[peak], whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_FLOPS[peak] * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


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
    # found without importing them: the CLI phase runs with cv2 hidden
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
                         'attn_block', 'swin_block'])
    print(f'built {sorted(libs)} in {time.perf_counter() - t0:.2f} s')


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


def _hold_suppression(what, args, got, timed=True):
    """Kernel 1's output `got` on `args` against the plain version on the same
    inputs: exact, NaN positions equal. When `timed`, times the kernel (events
    and device) and the plain version on `args`. Returns the numbers."""
    import torch
    from yolact_minimal_torch.ops.suppression import (suppression_iou_max,
                                                      suppression_iou_max_plain)
    x1, _, _, _, valid = args
    rows, k = x1.shape
    ref = suppression_iou_max_plain(*args)
    nan_equal = torch.equal(torch.isnan(got), torch.isnan(ref))
    finite = ~torch.isnan(ref)
    err = (got[finite] - ref[finite]).abs().max().item() if finite.any() else 0.0
    _check(nan_equal and err == 0.0,
           f'suppression kernel disagrees on {what}: nan_equal={nan_equal} max_abs_err={err}')
    if not timed:
        print(f'kernel suppression_iou_max [{rows}, {k}] {what}: exact (NaN positions equal)')
        return dict(shape=[rows, k], max_abs_err=err)

    def call():
        return suppression_iou_max(*args)
    ms, dev_ms = _time_ms(call), _device_ms(call)
    plain_ms = _time_ms(lambda: suppression_iou_max_plain(*args), warmup=1)
    vi = valid.to(torch.int64)
    # valid pairs j < i per row: C(n_valid, 2); ~12 fp32 ops per pair IoU
    pairs = (vi.sum(1) * (vi.sum(1) - 1) // 2).sum().item()
    bound, by = _bound_ms(rows * k * (4 * 4 + 1 + 4), pairs * 12, FP32_PEAK)
    print(f'kernel suppression_iou_max [{rows}, {k}] {what}: exact (NaN positions '
          f'equal), {ms:.4f} ms, device {dev_ms:.4f} ms, plain {plain_ms:.4f} ms, '
          f'bound {bound:.5f} ms ({by}, {pairs} valid pairs)')
    return dict(shape=[rows, k], ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, pairs=pairs, max_abs_err=err)


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


def check_suppression(dev):
    """Kernel 1 at [B*C, K] = [1280, 200] on input (a), the fixture with
    zero-area and invalid candidates, and (b), all valid; must equal the plain
    version exactly on both, NaN positions too. Prints the launch geometry
    and each input's event and device time, and on (a) a composition of
    PyTorch calls (`_suppression_composition`), held exactly to the plain
    version and timed. Phase 3c adds input (c), the planes the eval path gave
    the kernel."""
    import torch
    from yolact_minimal_torch.ops.suppression import (kernel_geometry, suppression_iou_max,
                                                      suppression_iou_max_plain)
    inputs = {}
    for key, what, all_valid in (('a_fixture', '(a) fixture', False),
                                 ('b_all_valid', '(b) all valid', True)):
        args = _suppression_inputs(dev, all_valid)
        _check(all_valid or torch.isnan(suppression_iou_max_plain(*args)).any().item(),
               'kernel 1 fixture has no NaN pair')
        got = suppression_iou_max(*args)
        torch.cuda.synchronize()
        inputs[key] = _hold_suppression(what, args, got)
    rows, k = inputs['a_fixture']['shape']
    geo = kernel_geometry(rows, k, dev.index or 0)
    print(f'kernel suppression_iou_max geometry: {geo["blocks"]} blocks (one a row) of '
          f'{geo["threads"]} threads, {geo["smem_bytes"]} B of shared memory a block, '
          f'{geo["blocks_per_sm"]} resident a multiprocessor, {geo["registers"]} registers, '
          f'{geo["spill_bytes"]} B spill')
    a = inputs['a_fixture']
    args = _suppression_inputs(dev, False)
    comp, ref = _suppression_composition(*args), suppression_iou_max_plain(*args)
    finite = ~torch.isnan(ref)
    _check(torch.equal(torch.isnan(comp), ~finite) and torch.equal(comp[finite], ref[finite]),
           'kernel 1: the PyTorch composition disagrees with the plain version on (a)')
    composition_ms = _time_ms(lambda: _suppression_composition(*args))
    composition_device_ms = _device_ms(lambda: _suppression_composition(*args))
    print(f'  composition (broadcast IoU, triu, amax) on (a): exact against the plain version, '
          f'{composition_ms:.4f} ms, device {composition_device_ms:.4f} ms')
    return dict(name='suppression_iou_max', route='cuda',
                source='yolact_minimal_torch/csrc/suppression.cu',
                replaces='yolact_minimal_tpu/ops/pallas_nms.py:67',
                max_abs_err=max(v['max_abs_err'] for v in inputs.values()),
                agreement='exact, NaN positions equal, on inputs (a) and (b)',
                ms=a['ms'], kernel_ms=a['ms'], device_ms=a['device_ms'], plain_ms=a['plain_ms'],
                bound_ms=a['bound_ms'], bound_by=a['bound_by'], peak=FP32_PEAK,
                library_ms=None, composition_ms=composition_ms,
                composition_device_ms=composition_device_ms,
                library='none (no single PyTorch call); composition_ms on (a): broadcast IoU '
                        '-> masked_fill -> triu -> amax, exact against the plain version',
                geometry=geo, inputs=inputs)


def _mask_fixture(dev):
    """Phase 3's mask inputs: B=16, D=100, proto 136x136x32, boxes 0.1-0.4
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


def _hold_mask(what, proto, coefs, boxes, valid, do_crop):
    """The mask kernel against its plain version on one input: the mismatch
    fraction must stay below MASK_MISMATCH and invalid slots empty. Returns
    (mismatch fraction, 1.0 if any pixel differs else 0.0)."""
    import torch
    from yolact_minimal_torch.ops.mask_finalize import mask_finalize, mask_finalize_plain
    got = mask_finalize(proto, coefs, boxes, valid, IMG, do_crop)
    torch.cuda.synchronize()
    ref = mask_finalize_plain(proto, coefs, boxes, valid, IMG, do_crop)
    _check(ref.any().item(), f'mask input {what} is empty')
    diff = got != ref
    mismatch = diff.float().mean().item()
    _check(mismatch < MASK_MISMATCH, f'mask kernel mismatch {mismatch} on {what}')
    _check(not got[~valid].any().item(), f'mask kernel wrote an invalid slot on {what}')
    out = mismatch, float(diff.any().item())
    del got, ref, diff
    torch.cuda.empty_cache()
    return out


def _time_mask(what, proto, coefs, boxes, valid, do_crop):
    """Events and device ms of one mask kernel call, and the share of the
    valid slots' planes inside their output windows."""
    from yolact_minimal_torch.ops.mask_finalize import mask_finalize, output_windows
    ph, pw = proto.shape[1:3]
    win = output_windows(boxes, valid, ph, pw, IMG, do_crop)
    area = ((win[..., 1] - win[..., 0]) * (win[..., 3] - win[..., 2])).sum().item()
    share = area / max(1, int(valid.sum()) * IMG * IMG)

    def call():
        return mask_finalize(proto, coefs, boxes, valid, IMG, do_crop)
    ms, dev_ms = _time_ms(call), _device_ms(call)
    print(f'  {what}: {ms:.4f} ms (events), {dev_ms:.4f} ms (device); windows cover '
          f'{share:.4f} of the valid slots\' planes')
    return ms, dev_ms


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


def check_mask_finalize(dev):
    """Kernel 2 at B=16, D=100, proto 136x136x32 -> 544x544: input (a), the
    fixture with crop, and (b), the same without crop; mismatch fraction vs
    the plain version < 1e-4 and invalid slots empty on both. Prints the
    launch geometry; (c), the res50 path's own slate, follows phase 4
    (check_mask_finalize_path)."""
    from yolact_minimal_torch.ops.boxes import sanitize_coordinates
    from yolact_minimal_torch.ops.mask_finalize import (BAND_ROWS, _tables, kernel_geometry,
                                                        mask_finalize, mask_finalize_plain)
    proto, coefs, boxes, valid = _mask_fixture(dev)
    ph = proto.shape[1]
    checks = [_hold_mask(f'({k}) fixture, do_crop={c}', proto, coefs, boxes, valid, c)
              for k, c in (('a', True), ('b', False))]
    worst, err = max(m for m, _ in checks), max(e for _, e in checks)

    _, tile_rows = _tables(ph, ph, IMG, proto.device)
    geo = kernel_geometry(BATCH * SLOTS, IMG, 32, tile_rows, ph, proto.device.index or 0)
    print(f'kernel mask_finalize geometry: {geo["blocks"]} persistent blocks of '
          f'{geo["threads"]} threads ({geo["blocks_per_sm"]} a multiprocessor on {geo["sms"]}) '
          f'walk {geo["items"]} (slot, band of {BAND_ROWS} rows) items; {geo["smem_bytes"]} B '
          f'of shared memory a block, {geo["registers"]} registers, {geo["spill_bytes"]} B spill')
    ms, dev_ms = _time_mask('(a) fixture, crop', proto, coefs, boxes, valid, True)
    nocrop_ms, nocrop_dev_ms = _time_mask('(b) fixture, no crop', proto, coefs, boxes, valid,
                                          False)
    args = (proto, coefs, boxes, valid, IMG, True)
    plain_ms = _time_ms(lambda: mask_finalize_plain(*args), warmup=1)
    comp_mismatch = (_mask_composition(*args[:5]) !=
                     mask_finalize_plain(*args)).float().mean().item()
    _check(comp_mismatch < MASK_MISMATCH, f'kernel 2: the PyTorch composition mismatches the '
                                         f'plain version on {comp_mismatch} of the pixels')
    composition_ms = _time_ms(lambda: _mask_composition(*args[:5]))
    composition_device_ms = _device_ms(lambda: _mask_composition(*args[:5]))
    print(f'  composition (bmm, sigmoid, crop, F.interpolate, > 0.5) on (a): mismatch '
          f'{comp_mismatch:.3g} against the plain version, {composition_ms:.4f} ms, device '
          f'{composition_device_ms:.4f} ms')
    # bytes: proto, coefs, boxes, valid read once; the bool masks written once.
    n_bytes = proto.numel() * 4 + coefs.numel() * 4 + boxes.numel() * 4 + \
        valid.numel() + BATCH * SLOTS * IMG * IMG
    # operations this data needs: the lincomb (2 per coef + ~4 for the
    # sigmoid) on proto pixels inside valid slots' crop boxes, and the
    # bilinear mix (9) on every output pixel of a valid slot
    x1, x2 = sanitize_coordinates(boxes[..., 0], boxes[..., 2], ph, 1)
    y1, y2 = sanitize_coordinates(boxes[..., 1], boxes[..., 3], ph, 1)
    cols = (x2.ceil() - x1.ceil()).clamp(min=0)
    rows = (y2.ceil() - y1.ceil()).clamp(min=0)
    inside = (cols * rows * valid).sum().item()
    n_ops = inside * (2 * 32 + 4) + valid.sum().item() * IMG * IMG * 9
    bound, by = _bound_ms(n_bytes, n_ops, FP32_PEAK)
    print(f'kernel mask_finalize [{BATCH}, {SLOTS}, {IMG}, {IMG}]: mismatch '
          f'{worst:.3g}, {ms:.4f} ms, device {dev_ms:.4f} ms, plain {plain_ms:.4f} ms, '
          f'bound {bound:.5f} ms ({by})')
    return dict(name='mask_finalize', route='cuda',
                source='yolact_minimal_torch/csrc/mask_finalize.cu',
                replaces='yolact_minimal_tpu/ops/pallas_masks.py:160',
                max_abs_err=err, mismatch_frac=worst,
                agreement=f'mismatch fraction {worst:.3g} < {MASK_MISMATCH} on inputs (a) '
                          f'and (b), and on (c) after phase 4',
                ms=ms, kernel_ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, peak=FP32_PEAK, library_ms=None, composition_ms=composition_ms,
                composition_device_ms=composition_device_ms,
                composition_mismatch_frac=comp_mismatch,
                library='none (no single PyTorch call); composition_ms on (a): bmm -> sigmoid '
                        '-> crop -> F.interpolate -> > 0.5', geometry=geo,
                inputs={'a_crop': {'ms': ms, 'device_ms': dev_ms},
                        'b_no_crop': {'ms': nocrop_ms, 'device_ms': nocrop_dev_ms}})


def check_mask_finalize_path(det, images, entry):
    """Input (c): the slate of one res50_coco detect_fixed call on phase 4's
    images (proto, coefs, boxes and valid from the path), held to the plain
    version and timed; recorded in the mask kernel's `entry`."""
    import torch
    with torch.inference_mode():
        dets, proto = det._infer(images)
    inputs = (proto, dets.coefs.contiguous(), dets.boxes.contiguous(), dets.valid.contiguous())
    mismatch, err = _hold_mask('(c) res50 path slate', *inputs, True)
    ms, dev_ms = _time_mask('(c) res50 path slate', *inputs, True)
    entry['inputs']['c_path'] = {'ms': ms, 'device_ms': dev_ms, 'mismatch_frac': mismatch}
    entry['mismatch_frac'] = max(entry['mismatch_frac'], mismatch)
    entry['max_abs_err'] = max(entry['max_abs_err'], err)


def _rel_err(got, ref):
    """max |got - ref| and the same as a share of max |ref|, in float32."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs().max().item()
    return err, err / ref.abs().max().item()


def check_window_attention(dev):
    """Kernel 3 at the four stage shapes of swin_tiny 544/b16: bf16 and
    float32, shifted (region ids) and unshifted, against the plain version;
    two bf16 launches on the same input must give the same bits. Timed in
    bf16 on the shifted form, beside one F.scaled_dot_product_attention call
    on the same q, k, v with the bias and mask folded into attn_mask. Prints
    the bf16 launch geometry."""
    import torch
    import torch.nn.functional as F
    from yolact_minimal_torch.models.swin import shifted_window_regions
    from yolact_minimal_torch.ops.window_attention import (NEG, kernel_attributes,
                                                           kernel_geometry, window_attention,
                                                           window_attention_plain)
    g = torch.Generator(device=dev).manual_seed(3)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    attrs = kernel_attributes()
    n, per_stage = 49, []
    for stage, (bnw, nw, c, heads, _) in enumerate(SWIN_STAGES):
        side = int(round(nw ** 0.5)) * 7
        region = torch.from_numpy(shifted_window_regions(side, side)).to(dev)
        qkv32 = torch.randn(bnw, n, 3 * c, device=dev, generator=g)
        bias32 = torch.randn(heads, n, n, device=dev, generator=g) * 0.1
        worst = {}
        for dtype, tol in ((torch.float32, SWIN_F32_REL_TOL), (torch.bfloat16, SWIN_BF16_REL_TOL)):
            qkv, bias = qkv32.to(dtype), bias32.to(dtype)
            for reg in (None, region):
                got = window_attention(qkv, bias, reg, heads)
                torch.cuda.synchronize()
                ref = window_attention_plain(qkv, bias, reg, heads)
                _check(got.dtype == dtype and got.shape == (bnw, n, c), 'kernel 3 output type')
                err, rel = _rel_err(got, ref)
                _check(rel <= tol, f'window_attention stage {stage} {dtype} '
                       f'{"shifted" if reg is not None else "unshifted"}: |kernel - plain| '
                       f'{err:.3g} is {rel:.3g} of max |plain| (> {tol:.3g})')
                worst[dtype] = max(worst.get(dtype, (0.0, 0.0)), (err, rel))
                if dtype == torch.bfloat16:
                    _check(torch.equal(got, window_attention(qkv, bias, reg, heads)),
                           f'window_attention stage {stage}: two launches differ')
                del got, ref
        qkv, bias = qkv32.to(torch.bfloat16), bias32.to(torch.bfloat16)
        del qkv32
        ms = _time_ms(lambda: window_attention(qkv, bias, region, heads))
        plain_ms = _time_ms(lambda: window_attention_plain(qkv, bias, region, heads), warmup=1,
                            iters=5)
        hd = c // heads
        q, k, v = qkv.view(bnw, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
        madd = torch.where(region[:, :, None] != region[:, None, :], NEG, 0.0)
        mask = (bias.float()[None] + madd[:, None]).to(torch.bfloat16)       # [nW, heads, N, N]
        mask = mask.repeat(bnw // nw, 1, 1, 1)
        lib = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        _, lib_rel = _rel_err(lib.permute(0, 2, 1, 3).reshape(bnw, n, c),
                              window_attention_plain(qkv, bias, region, heads))
        _check(lib_rel < 5e-2, f'the library yardstick computes something else ({lib_rel})')
        library_ms = _time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
        device_ms = _device_ms(lambda: window_attention(qkv, bias, region, heads))
        library_device_ms = _device_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
        # bytes: qkv, bias and region read once, out written once; operations:
        # the two products of every window and head
        n_bytes = (qkv.numel() + bias.numel() + bnw * n * c) * 2 + region.numel() * 4
        bound, by = _bound_ms(n_bytes, bnw * heads * 4 * n * n * hd, BF16_PEAK)
        print(f'kernel window_attention stage {stage} qkv [{bnw}, {n}, {3 * c}] heads {heads} '
              f'bf16: {ms:.4f} ms (device {device_ms:.4f}), plain {plain_ms:.4f} ms, SDPA '
              f'{library_ms:.4f} ms (device {library_device_ms:.4f}), bound {bound:.5f} ms '
              f'({by}); |kernel - plain| / max |plain|: bf16 '
              f'{worst[torch.bfloat16][1]:.3g} (<= {SWIN_BF16_REL_TOL:.3g}), float32 '
              f'{worst[torch.float32][1]:.3g} (<= {SWIN_F32_REL_TOL:.3g}); two bf16 launches '
              f'bit-equal')
        geo = kernel_geometry(bnw, heads, sms)
        units = [len(range(gr // heads, bnw, geo.per_head)) for gr in range(geo.groups)]
        geometry = dict(blocks=geo.blocks, groups=geo.groups, windows_per_head_step=geo.per_head,
                        units_per_group=[min(units), max(units)], sms=sms, **attrs)
        print(f'  geometry: {geo.blocks} blocks of {attrs["threads"]} threads ('
              f'{attrs["groups_per_block"]} groups of 4 warps, {attrs["blocks_per_sm"]} blocks an '
              f'SM on {sms} SMs) hold {geo.groups} groups, {geo.per_head} a head; '
              f'{min(units)}-{max(units)} (window, head) units a group of {bnw * heads}; '
              f'{attrs["stages"]} ring slots, {attrs["smem_bytes"]} B shared memory a block, '
              f'{attrs["registers"]} registers, {attrs["spill_bytes"]} B local (spill) a thread')
        per_stage.append(dict(shape=[bnw, n, 3 * c], heads=heads, ms=ms, device_ms=device_ms,
                              plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                              library_ms=library_ms, library_device_ms=library_device_ms,
                              geometry=geometry,
                              max_abs_err=worst[torch.bfloat16][0],
                              max_abs_err_f32=worst[torch.float32][0]))
        del qkv, bias, q, k, v, mask, lib
        torch.cuda.empty_cache()
    top = per_stage[0]
    return dict(name='window_attention', route='cuda',
                source='yolact_minimal_torch/csrc/window_attention.cu',
                replaces='yolact_minimal_tpu/ops/window_attention.py:154',
                max_abs_err=top['max_abs_err'],
                agreement=f'bf16 within {SWIN_BF16_REL_TOL:.3g} and float32 within '
                          f'{SWIN_F32_REL_TOL:.3g} of max |plain|, 4 stage shapes, shifted '
                          f'and unshifted; two bf16 launches bit-equal',
                ms=top['ms'], kernel_ms=top['ms'], device_ms=top['device_ms'],
                plain_ms=top['plain_ms'], bound_ms=top['bound_ms'], bound_by=top['bound_by'],
                peak=BF16_PEAK, library_ms=top['library_ms'],
                library='F.scaled_dot_product_attention, attn_mask = bias + mask',
                per_stage=per_stage)


# Kernel 4's bf16 device ms a call before its wide form took these (C, rows):
# the fused kernel (the three-launch form of 128 x 128 tiles at C = 1536),
# from probes/h100_swin_mlp/variants.py --parent on the commit before the
# wide form (PERF.md §6). Printed beside this run's times for the reader only:
# this run did not measure them, so they stay out of the kernels line.
FUSED_DEVICE_MS = {(384, 73984): 0.6447, (384, 18496): 0.2170, (768, 18496): 1.1325,
                   (768, 4624): 0.3639, (1536, 4624): 0.4035}


def _mlp_geometries(c, rows, sms):
    """Kernel 4's bf16 launch geometry for `rows` rows of width c, by
    launch (the fused kernel, or the wide form's fc1 and fc2), printed."""
    from yolact_minimal_torch.ops.swin_mlp import kernel_geometry, mlp_form
    import torch
    launches = ('fc1', 'fc2') if mlp_form(c, torch.bfloat16) == 'wide' else ('fused',)
    geos = {}
    for launch in launches:
        geo = kernel_geometry(c, rows, launch)
        geo['waves'] = geo['tiles'] / geo['blocks']
        geo['rounds'] = -(-geo['tiles'] // geo['blocks'])
        geo['sms'] = sms
        print(f'  {launch} geometry: {geo["rows_per_tile"]} x {geo["cols_per_tile"]} tiles '
              f'({geo["col_tiles"]} across), cluster {geo["cluster"]}, {geo["blocks"]} blocks of '
              f'{geo["threads"]} threads for {geo["tiles"]} tiles on {sms} SMs '
              f'({geo["waves"]:.2f} tiles a block, {geo["rounds"]} rounds), {geo["stages"]} ring '
              f'stages, {geo["smem_bytes"]} B shared memory, {geo["registers"]} registers, '
              f'{geo["spill_bytes"]} B local (spill) a thread')
        geos[launch] = geo
    return geos


def check_swin_mlp(dev):
    """Kernel 4 at the four stage shapes of swin_tiny 544/b16 (row counts that
    no tile divides), bf16 and float32, against the plain version; two bf16
    launches on the same input must give the same bits. Timed in bf16, once
    in float32 for the record, and beside the composition yardstick: bf16
    F.layer_norm (float32 statistics) -> F.linear -> F.gelu -> F.linear -> + x,
    which the port never calls, and where the wide form runs, beside the
    fused kernel's device time before it (FUSED_DEVICE_MS, printed only).
    Prints the bf16 form and each launch's geometry."""
    import torch
    import torch.nn.functional as F
    from yolact_minimal_torch.ops.swin_mlp import mlp_block, mlp_block_plain, mlp_form
    g = torch.Generator(device=dev).manual_seed(4)
    rand = lambda *shape: torch.randn(*shape, device=dev, generator=g)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_stage = []
    for stage, (_, _, c, _, rows) in enumerate(SWIN_STAGES):
        x32 = rand(rows, c)
        params = (1.0 + 0.1 * rand(c), 0.1 * rand(c), 0.05 * rand(4 * c, c),
                  0.05 * rand(4 * c), 0.05 * rand(c, 4 * c), 0.05 * rand(c))
        worst = {}
        for dtype, tol in ((torch.float32, SWIN_F32_REL_TOL), (torch.bfloat16, SWIN_BF16_REL_TOL)):
            x = x32.to(dtype)
            got = mlp_block(x, *params)
            torch.cuda.synchronize()
            ref = mlp_block_plain(x, *params)
            _check(got.dtype == dtype and got.shape == (rows, c), 'kernel 4 output type')
            err, rel = _rel_err(got, ref)
            _check(rel <= tol, f'swin_mlp stage {stage} {dtype}: |kernel - plain| {err:.3g} '
                   f'is {rel:.3g} of max |plain| (> {tol:.3g})')
            _check((ref.float() - x.float()).abs().max().item() > 0.1, 'the MLP term vanished')
            worst[dtype] = (err, rel)
            if dtype == torch.bfloat16:
                again = mlp_block(x, *params)
                _check(torch.equal(got, again), f'swin_mlp stage {stage}: two launches differ')
                del again
            del got, ref
        f32_ms = _time_ms(lambda: mlp_block(x32, *params), warmup=1, iters=3)
        x = x32.to(torch.bfloat16)
        del x32
        # the weights in bf16 once, as models/swin.py hands them over
        args = (x, params[0], params[1], params[2].bfloat16(), params[3],
                params[4].bfloat16(), params[5])
        ms = _time_ms(lambda: mlp_block(*args))
        plain_ms = _time_ms(lambda: mlp_block_plain(*args), warmup=1, iters=5)
        bf = [t.bfloat16() for t in params]

        def composition():
            h = F.linear(F.layer_norm(x, (c,), bf[0], bf[1], 1e-5), bf[2], bf[3])
            return x + F.linear(F.gelu(h), bf[4], bf[5])
        _, comp_rel = _rel_err(composition(), mlp_block_plain(*args))
        _check(comp_rel < 5e-2, f'the composition yardstick computes something else ({comp_rel})')
        composition_ms = _time_ms(composition)
        device_ms = _device_ms(lambda: mlp_block(*args))
        form = mlp_form(c, torch.bfloat16)
        geos = _mlp_geometries(c, rows, sms)
        bound, by = _mlp_bound(rows, c)
        before = FUSED_DEVICE_MS.get((c, rows))
        print(f'kernel swin_mlp stage {stage} x [{rows}, {c}] bf16, {form} form: {ms:.4f} ms '
              f'(device {device_ms:.4f}, {16 * rows * c * c / device_ms / 1e9:.1f} TFLOP/s, '
              f'{bound / device_ms:.1%} of the bound'
              + (f'; the fused kernel before it: device {before:.4f}' if before else '') +
              f'), composition yardstick {composition_ms:.4f} ms, plain '
              f'{plain_ms:.4f} ms, float32 kernel {f32_ms:.4f} ms, bound {bound:.5f} ms ({by}); '
              f'|kernel - plain| / max |plain|: bf16 {worst[torch.bfloat16][1]:.3g} (<= '
              f'{SWIN_BF16_REL_TOL:.3g}), float32 {worst[torch.float32][1]:.3g} (<= '
              f'{SWIN_F32_REL_TOL:.3g}); two launches bit-equal')
        per_stage.append(dict(shape=[rows, c], form=form, ms=ms, device_ms=device_ms,
                              plain_ms=plain_ms, f32_ms=f32_ms,
                              composition_ms=composition_ms,
                              bound_ms=bound, bound_by=by, library_ms=None, geometry=geos,
                              max_abs_err=worst[torch.bfloat16][0],
                              max_abs_err_f32=worst[torch.float32][0]))
        del x, args, params, bf
        torch.cuda.empty_cache()
    top = per_stage[0]
    return dict(name='swin_mlp', route='cuda', source='yolact_minimal_torch/csrc/swin_mlp.cu',
                replaces='yolact_minimal_tpu/ops/swin_mlp.py:128',
                max_abs_err=top['max_abs_err'],
                agreement=f'bf16 within {SWIN_BF16_REL_TOL:.3g} and float32 within '
                          f'{SWIN_F32_REL_TOL:.3g} of max |plain|, 4 stage shapes; two bf16 '
                          f'launches bit-equal',
                ms=top['ms'], kernel_ms=top['ms'], plain_ms=top['plain_ms'],
                bound_ms=top['bound_ms'], bound_by=top['bound_by'], peak=BF16_PEAK,
                library_ms=None,
                library='none (no single PyTorch call); composition_ms in per_stage: bf16 '
                        'F.layer_norm -> F.linear -> F.gelu -> F.linear -> + x',
                per_stage=per_stage)


def _block_inputs(dev, g, stage):
    """Seeded inputs of the two block kernels at stage `stage` of swin_tiny
    544/b16: float32 masters (x, LayerNorm and Linear parameters scaled so
    that every activation stays O(1) at every width, relative-position bias),
    and the real tables of the padded map: region ids of the shifted
    partition and the rowmasks of the unshifted and the shifted block."""
    import torch
    from yolact_minimal_torch.models.swin import pad_rowmask, shifted_window_regions
    bnw, nw, c, heads, _ = SWIN_STAGES[stage]
    side, padded = SWIN_MAPS[stage]
    _check(nw == (padded // 7) ** 2, 'SWIN_STAGES and SWIN_MAPS disagree')
    rand = lambda *shape: torch.randn(*shape, device=dev, generator=g)
    p = dict(
        x=rand(bnw, 49, c), bias=0.1 * rand(heads, 49, 49),
        ln1=(1.0 + 0.1 * rand(c), 0.1 * rand(c)), ln2=(1.0 + 0.1 * rand(c), 0.1 * rand(c)),
        qkv=(rand(3 * c, c) * c ** -0.5, 0.05 * rand(3 * c)),
        proj=(rand(c, c) * c ** -0.5, 0.05 * rand(c)),
        fc1=(rand(4 * c, c) * c ** -0.5, 0.05 * rand(4 * c)),
        fc2=(rand(c, 4 * c) * (4 * c) ** -0.5, 0.05 * rand(c)),
        region=torch.from_numpy(shifted_window_regions(padded, padded)).to(dev),
        rowmask={shift: torch.from_numpy(pad_rowmask(side, side, padded, padded, shift)).to(dev)
                 for shift in (0, 3)})
    _check(0 < p['rowmask'][3].mean().item() < 1, 'the rowmask marks no padding')
    return p


def _hold_to_plain(kernel, plain, what, shape, dtype, tol):
    """Run both, synchronise, check type, shape and the stated limit; returns
    (max |kernel - plain|, the same as a share of max |plain|)."""
    import torch
    got = kernel()
    torch.cuda.synchronize()
    ref = plain()
    _check(got.dtype == dtype and tuple(got.shape) == tuple(shape), f'{what}: output type')
    _check(torch.isfinite(got.float()).all().item(), f'{what}: non-finite output')
    err, rel = _rel_err(got, ref)
    _check(rel <= tol, f'{what} {dtype}: |kernel - plain| {err:.3g} is {rel:.3g} of max '
           f'|plain| (> {tol:.3g})')
    return err, rel


def _block_ops(stage, whole):
    """Operations of one launch: the qkv, q k^T, p v and proj products, and
    the two MLP products for the whole block."""
    bnw, _, c, _, _ = SWIN_STAGES[stage]
    rows = bnw * 49
    return 2 * rows * c * 3 * c + 4 * rows * 49 * c + 2 * rows * c * c + \
        (16 * rows * c * c if whole else 0)


def check_attn_block(dev, attention):
    """Kernel 5 at the four stage shapes: bf16 and float32, shifted and
    unshifted, against the plain version; two bf16 launches must give the same
    bits. Timed in bf16 on the shifted form (events, and device time under
    torch.profiler), beside the composed path's pieces for the same rows:
    cuBLAS qkv, kernel 3, cuBLAS proj in one timing (events and device time),
    and kernel 3's own time from this run; with the launch geometry of the
    form the width runs (tiled at C = 96, two phases above)."""
    import torch
    import torch.nn.functional as F
    from yolact_minimal_torch.ops.attn_block import (TILED_WINDOWS, attn_block,
                                                     attn_block_plain, kernel_attributes,
                                                     kernel_geometry)
    from yolact_minimal_torch.ops.window_attention import window_attention
    g = torch.Generator(device=dev).manual_seed(5)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_stage = []
    for stage, (bnw, nw, c, heads, _) in enumerate(SWIN_STAGES):
        p = _block_inputs(dev, g, stage)
        worst = {}
        for dtype, tol in ((torch.float32, SWIN_F32_REL_TOL), (torch.bfloat16, SWIN_BF16_REL_TOL)):
            x, bias = p['x'].to(dtype), p['bias'].to(dtype)
            for reg in (None, p['region']):
                args = (x, *p['qkv'], bias, reg, *p['proj'], heads)
                what = f'attn_block stage {stage} {"shifted" if reg is not None else "unshifted"}'
                worst[dtype] = max(worst.get(dtype, (0.0, 0.0)), _hold_to_plain(
                    lambda: attn_block(*args), lambda: attn_block_plain(*args), what,
                    (bnw, 49, c), dtype, tol))
        args32 = (p['x'], *p['qkv'], p['bias'], p['region'], *p['proj'], heads)
        f32_ms = _time_ms(lambda: attn_block(*args32), warmup=0, iters=2)
        # bf16 weights once, as models/swin.py hands them over
        bf = torch.bfloat16
        x, bias = p['x'].to(bf), p['bias'].to(bf)
        wqkv, wproj = p['qkv'][0].to(bf), p['proj'][0].to(bf)
        args = (x, wqkv, p['qkv'][1], bias, p['region'], wproj, p['proj'][1], heads)
        got = attn_block(*args)
        _check(torch.equal(got, attn_block(*args)), f'attn_block stage {stage}: two launches differ')
        ms = _time_ms(lambda: attn_block(*args))
        device_ms = _device_ms(lambda: attn_block(*args))
        del got
        plain_ms = _time_ms(lambda: attn_block_plain(*args), warmup=1, iters=5)
        bqkv, bproj = p['qkv'][1].to(bf), p['proj'][1].to(bf)
        composed = lambda: F.linear(window_attention(F.linear(x, wqkv, bqkv), bias, p['region'],
                                                     heads), wproj, bproj)
        composed_ms = _time_ms(composed)
        composed_device_ms = _device_ms(composed)
        n_bytes = (2 * x.numel() + wqkv.numel() + wproj.numel() + bias.numel()) * 2 + \
            (4 * c + p['region'].numel()) * 4
        bound, by = _bound_ms(n_bytes, _block_ops(stage, False), BF16_PEAK)
        k3 = attention['per_stage'][stage]['ms']
        print(f'kernel attn_block stage {stage} x [{bnw}, 49, {c}] heads {heads} bf16: {ms:.4f} ms '
              f'(device {device_ms:.4f}), plain {plain_ms:.4f} ms, float32 kernel {f32_ms:.4f} ms, '
              f'bound {bound:.5f} ms ({by}); what it replaces, this run: cuBLAS qkv + kernel 3 + '
              f'cuBLAS proj {composed_ms:.4f} ms (device {composed_device_ms:.4f}; kernel 3 alone '
              f'{k3:.4f}); |kernel - plain| / '
              f'max |plain|: bf16 {worst[bf][1]:.3g} (<= {SWIN_BF16_REL_TOL:.3g}), float32 '
              f'{worst[torch.float32][1]:.3g} (<= {SWIN_F32_REL_TOL:.3g}); two bf16 launches '
              f'bit-equal')
        geo = kernel_geometry(bnw, c, sms)
        attrs = kernel_attributes(c)
        kernels = ', '.join(f'{name} {a["threads"]} threads, {a["smem_bytes"]} B dynamic shared '
                            f'memory, {a["registers"]} registers, {a["spill_bytes"]} B local '
                            f'(spill) a thread' for name, a in attrs.items())
        if c in TILED_WINDOWS:
            geometry = dict(form='tiled', grid=geo.blocks, tiles=geo.tiles,
                            windows_per_tile=geo.windows_per_tile, rounds=geo.rounds,
                            waves=geo.tiles / geo.blocks, sms=sms, kernels=attrs)
            print(f'  geometry: tiled, grid {geo.blocks} blocks on {sms} SMs for {geo.tiles} tiles '
                  f'of G = {geo.windows_per_tile} windows ({geo.rounds} rounds, '
                  f'{geo.tiles / geo.blocks:.2f} tiles a block), weights resident; {kernels}')
        else:
            geometry = dict(form='two phases', heads_grid=geo.blocks, chunks=geo.chunks,
                            warpgroups=geo.warpgroups, rounds=geo.rounds,
                            row_tiles=geo.row_tiles, proj_grid=geo.proj_blocks, sms=sms,
                            kernels=attrs)
            print(f'  geometry: two phases; phase 1 grid {geo.blocks} blocks ({geo.heads} heads x '
                  f'{geo.chunks} chunks) of {geo.warpgroups} warpgroups, {geo.rounds} windows a '
                  f'warpgroup at most; phase 2 grid {geo.proj_blocks} blocks for {geo.row_tiles} '
                  f'row tiles of 64 on {sms} SMs; {kernels}')
        per_stage.append(dict(shape=[bnw, 49, c], heads=heads, ms=ms, device_ms=device_ms,
                              plain_ms=plain_ms, f32_ms=f32_ms, bound_ms=bound, bound_by=by,
                              library_ms=None, composed_ms=composed_ms,
                              composed_device_ms=composed_device_ms, window_attention_ms=k3,
                              geometry=geometry,
                              max_abs_err=worst[bf][0],
                              max_abs_err_f32=worst[torch.float32][0]))
        del p, x, args, args32
        torch.cuda.empty_cache()
    top = per_stage[0]
    return dict(name='attn_block', route='cuda', source='yolact_minimal_torch/csrc/attn_block.cu',
                replaces='yolact_minimal_tpu/ops/window_attention.py:316',
                max_abs_err=top['max_abs_err'],
                agreement=f'bf16 within {SWIN_BF16_REL_TOL:.3g} and float32 within '
                          f'{SWIN_F32_REL_TOL:.3g} of max |plain|, 4 stage shapes, shifted '
                          f'and unshifted; two bf16 launches bit-equal',
                ms=top['ms'], kernel_ms=top['ms'], device_ms=top['device_ms'],
                plain_ms=top['plain_ms'], bound_ms=top['bound_ms'], bound_by=top['bound_by'],
                peak=BF16_PEAK, library_ms=None, per_stage=per_stage)


def _library_block(p, heads):
    """Kernel 6's yardstick: the block as PyTorch's own calls on the same
    windowed bf16 rows, F.layer_norm -> F.linear -> SDPA (bias + the -100
    region fill as attn_mask) -> F.linear -> add -> F.layer_norm -> F.linear
    -> F.gelu -> F.linear -> add (no rowmask: the shifted block of an
    unpadded map). Timed only; the port never calls it. Returns the call."""
    import torch
    import torch.nn.functional as F
    bf = torch.bfloat16
    x = p['x'].to(bf)
    bnw, n, c = x.shape
    nw = p['region'].shape[0]
    differ = p['region'][:, :, None] != p['region'][:, None, :]
    mask = (p['bias'].to(bf)[None] + torch.where(differ, -100.0, 0.0)[:, None].to(bf))
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


def _flat_launch_device_ms(fn, iters=20):
    """Device ms of each of the flat form's launches (csrc/swin_block.cu at
    C = 768) in one call of fn, under torch.profiler over `iters` calls."""
    import torch
    from yolact_minimal_torch.ops.swin_block import FLAT_LAUNCHES
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ms = dict.fromkeys(FLAT_LAUNCHES, 0.0)
    for e in prof.key_averages():
        m = re.search(r'swin_block_(\w+?)_kernel', e.key)
        if e.device_type == torch.autograd.DeviceType.CUDA and m and m.group(1) in ms:
            ms[m.group(1)] += e.self_device_time_total / iters / 1e3
    _check(all(v > 0 for v in ms.values()), f'the profile misses a launch of the flat form: {ms}')
    return ms


def check_swin_block(dev, attention, mlp):
    """Kernel 6 at the four stage shapes: bf16 and float32, unshifted and
    shifted with the padded map's rowmask, and once with rowmask=None, against
    the plain version; two bf16 launches must give the same bits. Timed in
    bf16 on the shifted form (events, and device time under torch.profiler),
    beside kernel 3 + kernel 4 at the same stage from this run and the block
    as PyTorch's own calls (`library_ms`, events and device time), with the
    launch geometry; at C = 768 each of the six launches' device time."""
    import torch
    from yolact_minimal_torch.ops.swin_block import (GEMM_LAUNCHES, GEMM_ROWS, GEMM_SHAPES,
                                                     KERNEL_SHAPES, kernel_attributes,
                                                     kernel_geometry, launch_shapes,
                                                     swin_block, swin_block_plain)
    g = torch.Generator(device=dev).manual_seed(6)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_stage = []
    for stage, (bnw, nw, c, heads, _) in enumerate(SWIN_STAGES):
        p = _block_inputs(dev, g, stage)

        def block_args(x, bias, rowmask, region, cast=lambda w: w):
            return (x, rowmask, *p['ln1'], cast(p['qkv'][0]), p['qkv'][1], bias, region,
                    cast(p['proj'][0]), p['proj'][1], *p['ln2'], cast(p['fc1'][0]), p['fc1'][1],
                    cast(p['fc2'][0]), p['fc2'][1], heads)
        worst = {}
        for dtype, tol in ((torch.float32, SWIN_F32_REL_TOL), (torch.bfloat16, SWIN_BF16_REL_TOL)):
            x, bias = p['x'].to(dtype), p['bias'].to(dtype)
            for what, rowmask, reg in (('unshifted', p['rowmask'][0], None),
                                       ('shifted', p['rowmask'][3], p['region']),
                                       ('shifted, no rowmask', None, p['region'])):
                args = block_args(x, bias, rowmask, reg)
                worst[dtype] = max(worst.get(dtype, (0.0, 0.0)), _hold_to_plain(
                    lambda: swin_block(*args), lambda: swin_block_plain(*args),
                    f'swin_block stage {stage} {what}', (bnw, 49, c), dtype, tol))
        args32 = block_args(p['x'], p['bias'], p['rowmask'][3], p['region'])
        f32_ms = _time_ms(lambda: swin_block(*args32), warmup=0, iters=2)
        bf = torch.bfloat16
        args = block_args(p['x'].to(bf), p['bias'].to(bf), p['rowmask'][3], p['region'],
                          cast=lambda w: w.to(bf))
        got = swin_block(*args)
        _check(torch.equal(got, swin_block(*args)), f'swin_block stage {stage}: two launches differ')
        del got
        ms = _time_ms(lambda: swin_block(*args))
        device_ms = _device_ms(lambda: swin_block(*args))
        plain_ms = _time_ms(lambda: swin_block_plain(*args), warmup=1, iters=5)
        library = _library_block(p, heads)
        plain_free = swin_block_plain(*block_args(p['x'].to(bf), p['bias'].to(bf), None,
                                                  p['region'], cast=lambda w: w.to(bf)))
        _, library_rel = _rel_err(library(), plain_free)
        del plain_free
        library_ms = _time_ms(library)
        library_device_ms = _device_ms(library)
        n_bytes = (2 * bnw * 49 * c + 12 * c * c + heads * 49 * 49) * 2 + \
            (13 * c + 2 * nw * 49) * 4
        flops = _block_ops(stage, True)
        bound, by = _bound_ms(n_bytes, flops, BF16_PEAK)
        k3, k4 = attention['per_stage'][stage]['ms'], mlp['per_stage'][stage]['ms']
        print(f'kernel swin_block stage {stage} x [{bnw}, 49, {c}] heads {heads} bf16: {ms:.4f} ms '
              f'(device {device_ms:.4f}; {flops / device_ms / 1e9:.1f} TFLOP/s against '
              f'{PEAK_FLOPS[BF16_PEAK] / 1e12:.0f} at the bound), plain {plain_ms:.4f} ms, '
              f'float32 kernel {f32_ms:.4f} ms, bound {bound:.5f} ms ({by}); the block as '
              f'PyTorch calls (library), this run: {library_ms:.4f} ms (device '
              f'{library_device_ms:.4f}; max |library - plain| / max |plain| {library_rel:.3g}, '
              f'no rowmask); kernels 3 + 4 at this stage, this run: {k3:.4f} + {k4:.4f} = '
              f'{k3 + k4:.4f} ms (without the cuBLAS qkv and proj, LayerNorms and adds between '
              f'them); |kernel - plain| / max |plain|: bf16 {worst[bf][1]:.3g} (<= '
              f'{SWIN_BF16_REL_TOL:.3g}), float32 {worst[torch.float32][1]:.3g} (<= '
              f'{SWIN_F32_REL_TOL:.3g}); two bf16 launches bit-equal')
        geo = kernel_geometry(bnw, c, sms)
        attrs = kernel_attributes(c)
        shapes = {k: a['shape'] for k, a in attrs.items()}
        _check(shapes == launch_shapes(c), f'swin_block C = {c}: the compiled tile shapes '
               f'{shapes} are not the wrapper\'s {launch_shapes(c)}')
        if c in KERNEL_SHAPES:
            a = attrs['tiled']
            _, cs, stages = a['shape']
            geometry = dict(grid=geo.blocks, tiles=geo.tiles,
                            windows_per_tile=geo.windows_per_tile, rounds=geo.rounds,
                            waves=geo.tiles / geo.blocks, sms=sms, column_split=cs,
                            stages=stages, **{k: v for k, v in a.items() if k != 'shape'})
            print(f'  geometry: tiled, grid {geo.blocks} blocks of {a["threads"]} threads on '
                  f'{sms} SMs for {geo.tiles} tiles of G = {geo.windows_per_tile} windows '
                  f'({cs} warpgroups a window; {geo.rounds} rounds, '
                  f'{geo.tiles / geo.blocks:.2f} tiles a block), '
                  f'{stages} ring slots, {a["smem_bytes"]} B dynamic shared memory, '
                  f'{a["registers"]} registers, {a["spill_bytes"]} B local (spill) a '
                  f'thread')
        else:
            launch_ms = _flat_launch_device_ms(lambda: swin_block(*args))
            geometry = dict(form='flat rows', rows=geo.rows, ln_grid=geo.ln_blocks,
                            heads_grid=geo.blocks, chunks=geo.chunks,
                            warpgroups=geo.warpgroups, heads_rounds=geo.rounds,
                            row_tiles=geo.row_tiles, tile_rows=GEMM_ROWS,
                            gemm_shapes=GEMM_SHAPES,
                            col_tiles=dict(zip(GEMM_LAUNCHES, geo.col_tiles)),
                            gemm_grids=dict(zip(GEMM_LAUNCHES, geo.gemm_blocks)),
                            gemm_rounds={k: geo.gemm_rounds(k) for k in GEMM_LAUNCHES},
                            sms=sms, kernels=attrs, launch_device_ms=launch_ms)
            print(f'  geometry: flat rows, {geo.rows} rows; LN1 / LN2 grid {geo.ln_blocks}; '
                  f'attention grid {geo.blocks} ({geo.heads} heads x {geo.chunks} chunks) of '
                  f'{geo.warpgroups} warpgroups, {geo.rounds} windows a warpgroup at most; '
                  + '; '.join(f'{k} grid {geo.gemm_blocks[i]} ({GEMM_SHAPES[k][2]} a '
                              f'multiprocessor) over {geo.row_tiles} x {geo.col_tiles[i]} '
                              f'tiles of {GEMM_ROWS} x {GEMM_SHAPES[k][0]}, '
                              f'{GEMM_SHAPES[k][1]} ring slots ({geo.gemm_rounds(k)} rounds)'
                              for i, k in enumerate(GEMM_LAUNCHES)))
            print('  launches: ' + '; '.join(
                f'{k} device {launch_ms[k]:.4f} ms ({a["threads"]} threads, {a["smem_bytes"]} B '
                f'shared, {a["registers"]} registers, {a["spill_bytes"]} B spill)'
                for k, a in attrs.items()) + f'; sum {sum(launch_ms.values()):.4f} ms')
        per_stage.append(dict(shape=[bnw, 49, c], heads=heads, ms=ms, device_ms=device_ms,
                              plain_ms=plain_ms, f32_ms=f32_ms, bound_ms=bound, bound_by=by,
                              library_ms=library_ms, library_device_ms=library_device_ms,
                              window_attention_ms=k3, swin_mlp_ms=k4, geometry=geometry,
                              max_abs_err=worst[bf][0],
                              max_abs_err_f32=worst[torch.float32][0]))
        del p, args, args32, library
        torch.cuda.empty_cache()
    top = per_stage[0]
    return dict(name='swin_block', route='cuda', source='yolact_minimal_torch/csrc/swin_block.cu',
                replaces='yolact_minimal_tpu/ops/swin_block.py:198',
                max_abs_err=top['max_abs_err'],
                agreement=f'bf16 within {SWIN_BF16_REL_TOL:.3g} and float32 within '
                          f'{SWIN_F32_REL_TOL:.3g} of max |plain|, 4 stage shapes, unshifted, '
                          f'shifted and without rowmask; two bf16 launches bit-equal',
                ms=top['ms'], kernel_ms=top['ms'], device_ms=top['device_ms'],
                plain_ms=top['plain_ms'], bound_ms=top['bound_ms'], bound_by=top['bound_by'],
                peak=BF16_PEAK, library_ms=top['library_ms'],
                library_device_ms=top['library_device_ms'], per_stage=per_stage)


def _swin_launches(path, forwards=1):
    """The launches of each swin kernel that `forwards` forward passes on swin
    path `path` must make: every block its form's kernels, once."""
    return {k: forwards * sum(depth for depth, form in zip(SWIN_DEPTHS, SWIN_PATHS[path])
                              if k in SWIN_FORM_LAUNCHES[form]) for k in SWIN_KERNELS}


def _counters(name):
    """The launch-counting wrappers of the kernels on a config's path."""
    from yolact_minimal_torch.ops.attn_block import attn_block
    from yolact_minimal_torch.ops.mask_finalize import mask_finalize
    from yolact_minimal_torch.ops.suppression import suppression_iou_max
    from yolact_minimal_torch.ops.swin_block import swin_block
    from yolact_minimal_torch.ops.swin_mlp import mlp_block
    from yolact_minimal_torch.ops.window_attention import window_attention
    counters = {'suppression_iou_max': suppression_iou_max, 'mask_finalize': mask_finalize}
    if name.startswith('swin'):
        counters.update(window_attention=window_attention, swin_mlp=mlp_block,
                        attn_block=attn_block, swin_block=swin_block)
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


def phase_main_path(dev, name, form='composed', det=None, images=None, n_iters=10):
    """`name` (res50_coco or swin_tiny_coco) at 544, batch 16, bf16, seeded
    random init; for swin on path `form` of SWIN_PATHS, on the Detector and
    images of an earlier call when given, switched to that path's forms. Returns the launch
    counts, the Detector, its images and the untraced host ms per
    detect_fixed call."""
    import torch
    from yolact_minimal_torch.config import get_config
    from yolact_minimal_torch.pipeline import Detector

    if det is None:
        cfg = get_config(name, img_size=IMG, nms_score_thre=SCORE_THRE,
                         compute_dtype='bfloat16')
        det = Detector(cfg, device=dev, seed=0)
        g = torch.Generator(device=dev).manual_seed(2)
        images = torch.randn(BATCH, IMG, IMG, 3, device=dev, generator=g)
    state = list(det.model.parameters()) + list(det.model.buffers())
    _check(all(t.dtype in (torch.float32, torch.int64) for t in state),
           'a parameter or buffer is not float32 under bf16')
    if name.startswith('swin'):
        det.model.backbone.set_block_forms(SWIN_PATHS[form])
        name = f'{name}/{form}'
    print(f'main path: {name} {IMG}x{IMG}, batch {BATCH}, compute_dtype bfloat16 '
          f'(parameters and BatchNorm statistics float32), nms_score_thre {SCORE_THRE} '
          f'(random-init scores ~1/81 pass it, so the slate fills and the mask kernel '
          f'does real work)')

    counters = _counters(name)
    for fn in counters.values():
        fn.launches = 0
    for _ in range(2):                                  # warm-up
        dets, masks = det.detect_fixed(images, IMG)
    torch.cuda.synchronize()
    windows = []
    for _ in range(3):                  # the host clock spreads: three windows
        t0 = time.perf_counter()
        for _ in range(n_iters):
            dets, masks = det.detect_fixed(images, IMG)
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) / n_iters * 1e3)
    host_ms = statistics.median(windows)
    print(f'{name} detect_fixed bf16: {BATCH / host_ms * 1e3:.2f} img/s ({host_ms:.3f} ms per '
          f'batch of {BATCH}, median of 3 windows of {n_iters} calls: '
          f'{", ".join(f"{w:.3f}" for w in windows)} ms; host clock after synchronize)')

    _check(masks.shape == (BATCH, SLOTS, IMG, IMG) and masks.dtype == torch.bool,
           f'detect_fixed masks {tuple(masks.shape)} {masks.dtype}')
    for field, t in (('scores', dets.scores), ('boxes', dets.boxes), ('coefs', dets.coefs)):
        _check(torch.isfinite(t).all().item(), f'non-finite {field}')
    n_valid = int(dets.valid.sum())
    print(f'slate: {n_valid}/{BATCH * SLOTS} valid detections, '
          f'{masks.float().mean().item():.4f} of mask pixels set')
    _check(n_valid == BATCH * SLOTS, 'the random-init slate did not fill')
    _check(masks.any().item(), 'no mask pixel set')

    dets2, masks_proto, proto = det(images[:2])
    for i in range(2):
        one = type(dets2)(*(x[i] for x in dets2))
        ids, scores, boxes, up = det.postprocess_host(one, masks_proto[i], 480, IMG,
                                                      visual_thre=0.0)
        _check(up.shape == (len(ids), 480, IMG) and boxes.shape == (len(ids), 4),
               'postprocess_host shapes')
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    print(f'{name} main-path launches: {launches}')
    forwards = launches['suppression_iou_max']          # one per forward pass
    _check(forwards > 0 and launches['mask_finalize'] > 0,
           f'a kernel was not launched: {launches}')
    if 'swin_mlp' in launches:
        # every block runs its form's kernels once a forward, and no other's
        expected = _swin_launches(form, forwards)
        _check(all(launches[k] == n for k, n in expected.items()),
               f'form {form}: expected {expected} swin kernel launches, got {launches}')
    return launches, det, images, host_ms


def phase_profile(det, images, host_ms):
    """Device time of detect_fixed by kernel group, under torch.profiler, in
    the process and on the inputs whose untraced host time phase 4 took."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_ITERS):
            det.detect_fixed(images, IMG)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) / PROFILE_ITERS * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    per_call = lambda e: e.self_device_time_total / 1e3 / PROFILE_ITERS   # ms
    device_ms = sum(per_call(e) for e in kernels)
    print(f'profile, {PROFILE_ITERS} traced detect_fixed calls: device time per call '
          f'{device_ms:.3f} ms; host time per call {host_ms:.3f} ms untraced '
          f'(phase 4), {traced_ms:.3f} ms traced')
    if device_ms == 0:
        print('  device time not measured: the profiler saw no CUDA kernel')
        return
    print(f'  device busy share (device ms / untraced host ms): {device_ms / host_ms:.3f}')
    groups = dict.fromkeys([name for name, _ in GROUPS] + ['other'], 0.0)
    for e in kernels:
        groups[next((n for n, pat in GROUPS if re.search(pat, e.key)), 'other')] += per_call(e)
    for name, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        if ms:
            print(f'  {name:24s} {ms:9.3f} ms  {ms / device_ms:6.1%}')
    print('  top kernels (ms per call, launches per call):')
    for e in sorted(kernels, key=per_call, reverse=True)[:16]:
        print(f'    {per_call(e):9.3f}  {e.count / PROFILE_ITERS:6.1f}  {e.key[:100]}')


def phase_stage_forms(det, dev):
    """Each swin stage alone in each block form: its blocks (without the patch
    merging) on a seeded bf16 map of the stage's size at 544, batch 16, timed
    with CUDA events. Says which form is fastest at which stage, glue
    included."""
    import torch
    backbone = det.model.backbone
    g = torch.Generator(device=dev).manual_seed(7)
    table = {}
    with torch.inference_mode():
        for form in SWIN_FORM_LAUNCHES:
            backbone.set_block_forms(form)
            table[form] = []
            for stage, (side, _), (_, _, c, _, _) in zip(backbone.layers, SWIN_MAPS, SWIN_STAGES):
                x = torch.randn(BATCH, side, side, c, device=dev, generator=g).to(backbone.dtype)

                def blocks(x=x, stage=stage):
                    for block in stage.blocks:
                        x = block(x)
                    return x
                out = blocks()
                _check(out.shape == x.shape and torch.isfinite(out.float()).all().item(),
                       f'stage output in form {form}')
                table[form].append(_time_ms(blocks, warmup=2, iters=10))
    backbone.set_block_forms('composed')
    print(f'swin stages alone, bf16, batch {BATCH}, ms for the blocks of stages 0-3 (depths '
          f'{SWIN_DEPTHS}), kernels and the glue around them:')
    for form, row in table.items():
        print(f'  {form:10s} ' + ' / '.join(f'{ms:.4f}' for ms in row) + f'   sum {sum(row):.4f}')
    best = [min(table, key=lambda f: table[f][i]) for i in range(len(SWIN_MAPS))]
    print(f'  fastest form per stage: {best}, sum '
          f'{sum(table[f][i] for i, f in enumerate(best)):.4f} ms')


def _kernel_launches(fn, patterns):
    """Device ms and launches of one call of fn by CUDA kernel name pattern
    (first match wins), under torch.profiler."""
    import torch
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {name: dict(device_ms=0.0, launches=0) for name in patterns}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = next((n for n, pat in patterns.items() if re.search(pat, e.key)), None)
        if name is not None:
            out[name]['device_ms'] += e.self_device_time_total / 1e3
            out[name]['launches'] += e.count
    return out


def _window_bound(bnw, heads, c, n, shifted):
    """Kernel 3's least ms at n tokens: qkv, bias and region read once, out
    written once, in bf16; the two products of every window and head."""
    n_bytes = (bnw * n * 4 * c + heads * n * n) * 2 + (bnw * n * 4 if shifted else 0)
    return _bound_ms(n_bytes, bnw * heads * 4 * n * n * (c // heads), BF16_PEAK)


def _mlp_bound(rows, c):
    """Kernel 4's least ms: x and the parameters read once, y written once,
    in bf16; the two products."""
    n_bytes = 2 * rows * c * 2 + 8 * c * c * 2 + 7 * c * 4
    return _bound_ms(n_bytes, 16 * rows * c * c, BF16_PEAK)


def phase_swin_large(dev):
    """swin_large_coco (12x12 windows, C 192-1536) on the card. Kernel 3's
    144-token kernels at the four stage shapes of 544/b16, bf16 and float32,
    shifted and unshifted, against the plain version; kernel 4 on the same
    stages' rows (C = 192 fused, 384 / 768 / 1536 in its wide form's three
    launches) against its plain version; each bf16 form twice bit-equal,
    timed with CUDA events and in device time (the wide form's by launch)
    beside its bound, the fused kernel's device time before the wide form
    (FUSED_DEVICE_MS, printed only) and the bf16 composition yardstick, with each launch's
    geometry. Kernel 3's bf16 backward at
    144 tokens must refuse. Then one seeded swin_large_coco Detector at
    batch 16 in bf16 and at batch 2 in float32: detect_fixed with the launch
    counters set to 0 just before (24 of kernel 3 and 24 of kernel 4, none of
    kernels 5-6), one profiled bf16 call's device ms and launches by kernel
    beside the bound of its launches. Returns the two kernel rows and the
    bf16 path's launch counts."""
    import torch
    from yolact_minimal_torch.config import get_config
    from yolact_minimal_torch.models.swin import shifted_window_regions
    import torch.nn.functional as F
    from yolact_minimal_torch.ops.swin_mlp import mlp_block, mlp_block_plain, mlp_form
    from yolact_minimal_torch.ops.window_attention import (kernel_attributes,
                                                           window_attention,
                                                           window_attention_backward,
                                                           window_attention_plain)
    from yolact_minimal_torch.pipeline import Detector
    g = torch.Generator(device=dev).manual_seed(7)
    rand = lambda *shape: torch.randn(*shape, device=dev, generator=g)
    n, attention, mlp = 144, [], []
    for stage, ((bnw, nw, c, heads, rows), (_, side)) in enumerate(
            zip(SWIN_LARGE_STAGES, SWIN_LARGE_MAPS)):
        region = torch.from_numpy(shifted_window_regions(side, side, 12, 6)).to(dev)
        qkv32, bias32 = rand(bnw, n, 3 * c), rand(heads, n, n) * 0.1
        worst = {}
        for dtype, tol in ((torch.float32, SWIN_F32_REL_TOL), (torch.bfloat16, SWIN_BF16_REL_TOL)):
            qkv, bias = qkv32.to(dtype), bias32.to(dtype)
            for reg in (None, region):
                got = window_attention(qkv, bias, reg, heads)
                torch.cuda.synchronize()
                err, rel = _rel_err(got, window_attention_plain(qkv, bias, reg, heads))
                _check(got.dtype == dtype and rel <= tol,
                       f'window_attention 144 tokens stage {stage} {dtype} '
                       f'{"shifted" if reg is not None else "unshifted"}: |kernel - plain| '
                       f'{err:.3g} is {rel:.3g} of max |plain| (> {tol:.3g})')
                worst[dtype] = max(worst.get(dtype, (0.0, 0.0)), (err, rel))
                if dtype == torch.bfloat16:
                    _check(torch.equal(got, window_attention(qkv, bias, reg, heads)),
                           f'window_attention 144 tokens stage {stage}: two launches differ')
                del got
        qkv, bias = qkv32.bfloat16(), bias32.bfloat16()
        del qkv32, bias32
        if stage == 0:
            try:
                window_attention_backward(qkv, bias, region, heads, qkv[..., :c].contiguous())
                _check(False, 'the bf16 backward at 144 tokens did not refuse')
            except ValueError as e:
                print(f'kernel 3 bf16 backward at 144 tokens refuses: {e}')
        ms = _time_ms(lambda: window_attention(qkv, bias, region, heads))
        device_ms = _device_ms(lambda: window_attention(qkv, bias, region, heads))
        plain_ms = _time_ms(lambda: window_attention_plain(qkv, bias, region, heads), warmup=1,
                            iters=5)
        bound, by = _window_bound(bnw, heads, c, n, True)
        print(f'kernel window_attention_n144 stage {stage} qkv [{bnw}, {n}, {3 * c}] heads '
              f'{heads} bf16 shifted: {ms:.4f} ms (device {device_ms:.4f}), plain '
              f'{plain_ms:.4f} ms, bound {bound:.5f} ms ({by}), {bound / device_ms:.1%} of it; '
              f'|kernel - plain| / max |plain|: bf16 {worst[torch.bfloat16][1]:.3g}, float32 '
              f'{worst[torch.float32][1]:.3g}; two bf16 launches bit-equal')
        attention.append(dict(shape=[bnw, n, 3 * c], heads=heads, ms=ms, device_ms=device_ms,
                              plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                              max_abs_err=worst[torch.bfloat16][0],
                              max_abs_err_f32=worst[torch.float32][0]))
        del qkv, bias, region
        x32 = rand(rows, c)
        params = (1.0 + 0.1 * rand(c), 0.1 * rand(c), 0.05 * rand(4 * c, c),
                  0.05 * rand(4 * c), 0.05 * rand(c, 4 * c), 0.05 * rand(c))
        worst = {}
        for dtype, tol in ((torch.float32, SWIN_F32_REL_TOL), (torch.bfloat16, SWIN_BF16_REL_TOL)):
            x = x32.to(dtype)
            got = mlp_block(x, *params)
            torch.cuda.synchronize()
            err, rel = _rel_err(got, mlp_block_plain(x, *params))
            _check(got.dtype == dtype and rel <= tol,
                   f'swin_mlp C = {c} {dtype}: |kernel - plain| {err:.3g} is {rel:.3g} of max '
                   f'|plain| (> {tol:.3g})')
            worst[dtype] = (err, rel)
            if dtype == torch.bfloat16:
                _check(torch.equal(got, mlp_block(x, *params)),
                       f'swin_mlp C = {c}: two launches differ')
            del got
        x = x32.bfloat16()
        del x32
        args = (x, params[0], params[1], params[2].bfloat16(), params[3],
                params[4].bfloat16(), params[5])
        ms = _time_ms(lambda: mlp_block(*args))
        device_ms = _device_ms(lambda: mlp_block(*args))
        plain_ms = _time_ms(lambda: mlp_block_plain(*args), warmup=1, iters=5)
        bf = [t.bfloat16() for t in params]
        composition_ms = _time_ms(lambda: x + F.linear(F.gelu(F.linear(
            F.layer_norm(x, (c,), bf[0], bf[1], 1e-5), bf[2], bf[3])), bf[4], bf[5]))
        bound, by = _mlp_bound(rows, c)
        form = mlp_form(c, torch.bfloat16)
        by_launch = {k: v['device_ms'] for k, v in _kernel_launches(lambda: mlp_block(*args), {
            'ln': r'mlp_wide_ln_kernel', 'fc1': r'mlp_wide_gemm_kernel<\d+,\s*false>',
            'fc2': r'mlp_wide_gemm_kernel<\d+,\s*true>', 'fused': r'mlp_bf16_sm90_kernel'}).items()
            if v['launches']}
        before = FUSED_DEVICE_MS.get((c, rows))
        print(f'kernel swin_mlp C = {c} x [{rows}, {c}] bf16, {form} form: {ms:.4f} ms (device '
              f'{device_ms:.4f}, {16 * rows * c * c / device_ms / 1e9:.1f} TFLOP/s; by launch '
              f'{by_launch}), bound {bound:.5f} ms ({by}), {bound / device_ms:.1%} of it'
              + (f'; the fused kernel before it: device {before:.4f} ms' if before else '') +
              f'; composition yardstick {composition_ms:.4f} ms, plain {plain_ms:.4f} ms; '
              f'|kernel - plain| / max |plain|: bf16 {worst[torch.bfloat16][1]:.3g}, float32 '
              f'{worst[torch.float32][1]:.3g}')
        geos = _mlp_geometries(c, rows, torch.cuda.get_device_properties(dev).multi_processor_count)
        mlp.append(dict(shape=[rows, c], form=form, ms=ms, device_ms=device_ms,
                        device_ms_by_launch=by_launch, plain_ms=plain_ms, composition_ms=composition_ms, bound_ms=bound,
                        bound_by=by, geometry=geos, max_abs_err=worst[torch.bfloat16][0],
                        max_abs_err_f32=worst[torch.float32][0]))
        del x, args, params, bf
        torch.cuda.empty_cache()

    counters = _counters('swin_large_coco')
    launches = {}
    for dtype, batch in (('float32', 2), ('bfloat16', BATCH)):
        cfg = get_config('swin_large_coco', img_size=IMG, nms_score_thre=SCORE_THRE,
                         compute_dtype=dtype)
        det = Detector(cfg, device=dev, seed=0)
        images = torch.randn(batch, IMG, IMG, 3, device=dev, generator=g)
        det.detect_fixed(images, IMG)                       # warm-up
        torch.cuda.synchronize()
        _zero_counters(counters)
        t0 = time.perf_counter()
        dets, masks = det.detect_fixed(images, IMG)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        launches = _read_counters(counters)
        print(f'swin_large_coco detect_fixed {dtype} b{batch}: {host_ms:.3f} ms a call, '
              f'launches {launches}, {int(dets.valid.sum())}/{batch * SLOTS} valid')
        _check(launches['window_attention'] == 24 and launches['swin_mlp'] == 24 and
               launches['attn_block'] == 0 and launches['swin_block'] == 0 and
               launches['window_attention_backward'] == 0,
               f'swin_large_coco {dtype}: expected 24 launches of kernels 3 and 4 and none '
               f'of kernels 5-6, got {launches}')
        _check(masks.shape == (batch, SLOTS, IMG, IMG) and int(dets.valid.sum()) == batch * SLOTS,
               f'swin_large_coco {dtype}: the slate did not fill')
    by_kernel = _kernel_launches(lambda: det.detect_fixed(images, IMG), {
        'window_attention_n144': r'window_attention_n144_bf16_kernel',
        'window_attention_n49': r'window_attention_(bf16|f32)_kernel',
        'swin_mlp_fused': r'mlp_bf16_sm90_kernel',
        'swin_mlp_wide_ln': r'mlp_wide_ln_kernel',
        'swin_mlp_wide_gemm': r'mlp_wide_gemm_kernel'})
    print(f'swin_large_coco bf16 b{BATCH}, one profiled detect_fixed: {by_kernel}')
    depths = (2, 2, 18, 2)
    want = dict(window_attention_n144=24, window_attention_n49=0, swin_mlp_fused=2,
                swin_mlp_wide_ln=22, swin_mlp_wide_gemm=44)
    _check(all(by_kernel[k]['launches'] == v for k, v in want.items()),
           f'swin_large_coco bf16 kernels by name: expected {want}, got {by_kernel}')
    # the path's bound: each block's launch at its stage's shapes, half of them shifted
    wa_bound = sum(d / 2 * (_window_bound(bnw, h, c, n, False)[0] +
                            _window_bound(bnw, h, c, n, True)[0])
                   for d, (bnw, _, c, h, _) in zip(depths, SWIN_LARGE_STAGES))
    fused_bound = depths[0] * _mlp_bound(SWIN_LARGE_STAGES[0][4], SWIN_LARGE_STAGES[0][2])[0]
    wide_bound = sum(d * _mlp_bound(rows, c)[0]
                     for d, (_, _, c, _, rows) in zip(depths[1:], SWIN_LARGE_STAGES[1:]))
    wa_ms = by_kernel['window_attention_n144']['device_ms']
    fused_ms = by_kernel['swin_mlp_fused']['device_ms']
    wide_ms = sum(by_kernel[k]['device_ms'] for k in ('swin_mlp_wide_ln', 'swin_mlp_wide_gemm'))
    print(f'  path device ms (bound ms): kernel 3 at 144 tokens {wa_ms:.3f} ({wa_bound:.3f}), '
          f'kernel 4 fused at C = 192 {fused_ms:.3f} ({fused_bound:.3f}), kernel 4 wide at '
          f'C = 384-1536 {wide_ms:.3f} ({wide_bound:.3f})')
    del det, images, dets, masks
    torch.cuda.empty_cache()
    found = [
        dict(name='window_attention_n144', route='cuda',
             source='yolact_minimal_torch/csrc/window_attention.cu',
             replaces='yolact_minimal_tpu/ops/window_attention.py:154',
             max_abs_err=attention[0]['max_abs_err'],
             agreement=f'bf16 within {SWIN_BF16_REL_TOL:.3g} and float32 within '
                       f'{SWIN_F32_REL_TOL:.3g} of max |plain|, swin_large 4 stage shapes, '
                       f'shifted and unshifted; two bf16 launches bit-equal',
             ms=attention[0]['ms'], kernel_ms=attention[0]['ms'],
             device_ms=attention[0]['device_ms'], plain_ms=attention[0]['plain_ms'],
             bound_ms=attention[0]['bound_ms'], bound_by=attention[0]['bound_by'],
             peak=BF16_PEAK, path_device_ms=wa_ms, path_bound_ms=wa_bound,
             attributes=kernel_attributes(wide=True), per_stage=attention,
             launches=by_kernel['window_attention_n144']['launches']),
        dict(name='swin_mlp_wide', route='cuda', source='yolact_minimal_torch/csrc/swin_mlp.cu',
             replaces='yolact_minimal_tpu/ops/swin_mlp.py:128',
             max_abs_err=mlp[2]['max_abs_err'],
             agreement=f'bf16 within {SWIN_BF16_REL_TOL:.3g} and float32 within '
                       f'{SWIN_F32_REL_TOL:.3g} of max |plain| at C = 192 / 384 / 768 / 1536 '
                       f'on swin_large rows; two bf16 launches bit-equal',
             ms=mlp[2]['ms'], kernel_ms=mlp[2]['ms'], device_ms=mlp[2]['device_ms'],
             plain_ms=mlp[2]['plain_ms'], bound_ms=mlp[2]['bound_ms'],
             bound_by=mlp[2]['bound_by'], peak=BF16_PEAK, path_device_ms=wide_ms,
             path_bound_ms=wide_bound, fused_path_device_ms=fused_ms,
             fused_path_bound_ms=fused_bound, per_stage=mlp,
             launches=by_kernel['swin_mlp_wide_ln']['launches'])]
    return found, launches


def phase_numerics(dev, name, det_bf16, image, form='composed', composed_out=None):
    """One image through config `name` (swin: on path `form` of SWIN_PATHS). Float32
    with TF32 off: network outputs card vs CPU (on the CPU the swin kernels'
    plain versions run), for a fused form also against `composed_out`, the
    composed form's float32 outputs on the card; then the card's postprocess +
    mask kernel vs the CPU's plain versions on the same head outputs
    (random-init scores sit near 1/81, so two slates from two forward passes
    may reorder under float noise). Then the bf16 Detector of phase 4 against
    the card's float32 run. Returns the card's float32 network outputs."""
    import torch
    from yolact_minimal_torch.config import get_config
    from yolact_minimal_torch.ops.mask_finalize import mask_finalize
    from yolact_minimal_torch.ops.nms import detect_postprocess_batch
    from yolact_minimal_torch.pipeline import Detector

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f'{name} {form} f32 parity: torch.backends.cudnn.allow_tf32=False, '
          'torch.backends.cuda.matmul.allow_tf32=False')
    cfg = get_config(name, img_size=IMG, nms_score_thre=SCORE_THRE)
    gpu = Detector(cfg, device=dev, seed=0)
    cpu = Detector(cfg, device='cpu', seed=0)
    if name.startswith('swin'):
        gpu.model.backbone.set_block_forms(SWIN_PATHS[form])
        cpu.model.backbone.set_block_forms(SWIN_PATHS[form])
    counters = _counters(name)
    before = {k: fn.launches for k, fn in counters.items()}
    with torch.inference_mode():
        out_gpu = gpu.model(image)
        if name.startswith('swin'):     # the float32 run went through this form's kernels
            ran = {k: counters[k].launches - before[k] for k in SWIN_KERNELS}
            expected = _swin_launches(form)
            _check(ran == expected, f'float32 {form}: expected launches {expected}, got {ran}')
        out_cpu = cpu.model(image.cpu())
        out_bf16 = det_bf16.model(image)
    names = ('class', 'box', 'coef', 'proto')
    for out, a, b in zip(names, out_gpu, out_cpu):
        rel = ((a.cpu() - b).abs().max() / b.abs().max()).item()
        print(f'  network {out}: max |card - cpu| / max |cpu| = {rel:.3g}')
        _check(rel < NET_REL_TOL, f'network output {out} off by {rel}')
    if composed_out is not None:
        for out, a, b in zip(names, out_gpu, composed_out):
            rel = ((a - b).abs().max() / b.abs().max()).item()
            print(f'  network {out}: max |{form} - composed| / max |composed| on the card = '
                  f'{rel:.3g} (< {FORM_REL_TOL})')
            # 0 is possible: in float32 the half-block kernel sums in index
            # order, as cuBLAS does at these sizes
            _check(rel < FORM_REL_TOL, f'form {form}: network output {out} off by {rel}')

    post = (gpu.anchors, SCORE_THRE, cfg.nms_iou_thre, cfg.top_k, cfg.max_detections,
            cfg.nms_pre_topk)
    with torch.inference_mode():
        d_gpu = detect_postprocess_batch(*out_gpu[:3], *post)
        heads_cpu = [t.cpu() for t in out_gpu]
        d_cpu = detect_postprocess_batch(*heads_cpu[:3], gpu.anchors.cpu(), *post[1:])
        m_gpu = mask_finalize(out_gpu[3], d_gpu.coefs, d_gpu.boxes, d_gpu.valid, IMG)
        m_cpu = mask_finalize(heads_cpu[3], d_cpu.coefs, d_cpu.boxes, d_cpu.valid, IMG)
    _check(torch.equal(d_gpu.valid.cpu(), d_cpu.valid) and torch.equal(d_gpu.ids.cpu(), d_cpu.ids),
           'card and CPU slates differ in ids or validity')
    box_err = (d_gpu.boxes.cpu() - d_cpu.boxes).abs().max().item()
    score_err = (d_gpu.scores.cpu() - d_cpu.scores).abs().max().item()
    mismatch = (m_gpu.cpu() != m_cpu).float().mean().item()
    print(f'  slate: ids equal ({int(d_cpu.valid.sum())} valid), boxes max err '
          f'{box_err:.3g}, scores max err {score_err:.3g} (atol {POST_ATOL}), '
          f'mask mismatch {mismatch:.3g} (< {MASK_MISMATCH})')
    _check(box_err <= POST_ATOL and score_err <= POST_ATOL, 'slate boxes/scores off')
    _check(mismatch < MASK_MISMATCH, f'mask mismatch {mismatch}')

    print('bf16 (phase 4 Detector) against float32 on the card, same image:')
    for out, a, b in zip(names, out_bf16, out_gpu):
        _check(a.dtype == torch.float32, f'bf16 network output {out} is {a.dtype}')
        rel = ((a - b).abs().max() / b.abs().max()).item()
        print(f'  network {out}: max |bf16 - f32| / max |f32| = {rel:.3g} (< {BF16_REL_TOL})')
        _check(0 < rel < BF16_REL_TOL, f'bf16 network output {out} off by {rel}')
    with torch.inference_mode():
        d_bf16 = detect_postprocess_batch(*out_bf16[:3], *post)
    _check(bool(d_bf16.valid.all()) and bool(d_gpu.valid.all()), 'a slate did not fill')
    s_bf16 = d_bf16.scores.sort(descending=True).values
    s_f32 = d_gpu.scores.sort(descending=True).values
    rel = ((s_bf16 - s_f32).abs().max() / s_f32.abs().max()).item()
    print(f'  slate: sorted scores max |bf16 - f32| / max f32 = {rel:.3g} '
          f'(< {BF16_SCORE_RTOL})')
    _check(rel < BF16_SCORE_RTOL, f'bf16 slate scores off by {rel}')
    return out_gpu


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


def phase_cli(dev):
    """The detect CLI as a user runs it, on the card, with cv2 hidden (so the
    images go through PIL and val_aug through F.interpolate): two seeded PNGs
    of different shapes in a temporary folder, a seeded res50_coco state_dict
    saved as a reference-format .pth (its class head's bias for class 1
    raised by 6 at every anchor, so that detections pass the CLI's
    thresholds and the drawing has work), then
    yolact_minimal_torch.detect.main from a temporary working directory; both
    drawn images must exist, read back at their input shapes and differ from
    the input. Returns the kernel launches of the run."""
    import os
    import tempfile
    import numpy as np
    import torch
    from yolact_minimal_torch.config import get_config
    from yolact_minimal_torch.detect import main as detect_main
    from yolact_minimal_torch.pipeline import Detector
    from yolact_minimal_torch.utils import image_io

    rng = np.random.RandomState(8)
    shapes = {'wide.png': (480, 640), 'square.png': (IMG, IMG)}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp, _without_cv2():
        library = image_io.backend()
        os.makedirs(os.path.join(tmp, 'images'))
        for name, (h, w) in shapes.items():
            # smooth colour ramps plus noise
            ramp = np.linspace(0, 200, w)[None, :, None] + np.linspace(0, 50, h)[:, None, None]
            img = np.clip(ramp + rng.randint(0, 40, (h, w, 3)), 0, 255).astype(np.uint8)
            image_io.imwrite(os.path.join(tmp, 'images', name), img)
        det = Detector(get_config('res50_coco', img_size=IMG), device=dev, seed=0)
        sd = {k: v.cpu() for k, v in det.model.state_dict().items()}
        sd['prediction_layers.conf_layer.bias'][1::81] += 6.0
        weight = os.path.join(tmp, 'seeded_res50_coco.pth')
        torch.save(sd, weight)
        del det, sd
        counters = _counters('res50_coco')
        for fn in counters.values():
            fn.launches = 0
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            detect_main(['--weight', weight, '--image', os.path.join(tmp, 'images'),
                         '--img_size', str(IMG)])
            seconds = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items()}
        for name, shape in shapes.items():
            path = os.path.join(tmp, 'results', 'images', name)
            _check(os.path.exists(path), f'the CLI wrote no {name}')
            out = image_io.imread(path)
            src = image_io.imread(os.path.join(tmp, 'images', name))
            _check(out.shape == shape + (3,), f'{name}: drawn image {out.shape}, input {shape}')
            _check(not np.array_equal(out, src), f'{name}: nothing was drawn')
    _check(launches['suppression_iou_max'] == len(shapes),
           f'the CLI made {launches} kernel launches for {len(shapes)} images')
    print(f'detect CLI on the card: {len(shapes)} PNGs {list(shapes.values())} in {seconds:.2f} s '
          f'(model build and first-call warm-up included), cv2 hidden, image library '
          f'{library}; both drawn images read back at their input shapes; '
          f'launches {launches}')
    return launches


def _run_cli(module, args, cwd, timeout=600):
    """`python -m yolact_minimal_torch.MODULE ARGS` in a subprocess from `cwd`
    (or `python -c CODE` for module None), as a user runs it; fails unless it
    exits 0. Returns (stdout, seconds)."""
    import os
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get('PYTHONPATH')) if p))
    cmd = ['-c', *args] if module is None else ['-m', f'yolact_minimal_torch.{module}', *args]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *cmd], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)
    seconds = time.perf_counter() - t0
    _check(proc.returncode == 0, f'{module or "python -c"} {args if module else ""} exited '
                                 f'{proc.returncode}:\n{proc.stdout[-3000:]}\n'
                                 f'{proc.stderr[-3000:]}')
    return proc.stdout, seconds


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


def _cli_rate(out):
    """The eval CLI's last progress line: (img/s, t_t, t_fetch, t_after_nms,
    t_metric), the times in s a batch."""
    m = re.findall(r'total fps: ([\d.]+) \| t_t: ([\d.]+) \| t_fetch: ([\d.]+) \| '
                   r't_after_nms: ([\d.]+) \| t_metric: ([\d.]+)', out)
    _check(m, 'the eval CLI printed no rate')
    return tuple(float(x) for x in m[-1])


def _rate_line(what, fps, t_t, t_fetch, t_after, t_metric, smi):
    """The eval timer's means: t_t and t_fetch a batch, t_after and t_metric
    an image."""
    tail = EVAL_BS * (t_after + t_metric)
    return (f'{what}: {fps:.2f} img/s ({t_t * 1e3:.3f} ms a batch of {EVAL_BS}; host tail '
            f'after_nms {t_after * 1e3:.3f} + metric {t_metric * 1e3:.3f} ms an image, '
            f'{tail / t_t:.3f} of the batch; waiting on the card (fetch) '
            f'{t_fetch * 1e3:.3f} ms a batch, {t_fetch / t_t:.3f}; first batch left out) on {smi}')


def _hold_slates(log_gpu, log_cpu):
    """The card's slates against the CPU's, image by image: valid flags equal;
    ids equal, boxes and scores within POST_ATOL; the upsampled masks of those
    slots parting in less than MASK_MISMATCH of their pixels. A valid slot
    that parts is exempt only where a measured near-tie explains it: each
    side's pick stands in the other's slate with the same class, its box and
    its score within POST_ATOL, and the two picks score within 3 POST_ATOL
    (two scores that each move by POST_ATOL swap only when they lie within
    2 POST_ATOL), so rounding alone ordered them. Exempt
    slots are printed with both picks. Returns (largest score error, largest
    mask mismatch, number of exempt slots)."""
    import numpy as np

    def found(d, cls, box, score):
        ids, boxes, scores = d.ids.numpy(), d.boxes.numpy(), d.scores.numpy()
        near = ((ids == cls) & d.valid.numpy() & (np.abs(scores - score) <= POST_ATOL)
                & (np.abs(boxes - box).max(-1) <= POST_ATOL))
        return bool(near.any())

    score_err, mismatch, exempt = 0.0, 0.0, 0
    for i, ((dg, og), (dc, oc)) in enumerate(zip(log_gpu, log_cpu)):
        valid = dc.valid.numpy()
        _check(np.array_equal(dg.valid.numpy(), valid),
               f'eval image {i}: the card\'s valid slots differ from the CPU\'s')
        ids_g, ids_c = dg.ids.numpy(), dc.ids.numpy()
        s_g, s_c = dg.scores.numpy(), dc.scores.numpy()
        b_g, b_c = dg.boxes.numpy(), dc.boxes.numpy()
        tie = valid & ((ids_g != ids_c) | (np.abs(s_g - s_c) > POST_ATOL)
                       | (np.abs(b_g - b_c).max(-1) > POST_ATOL))
        for j in np.nonzero(tie)[0]:
            explained = (abs(s_g[j] - s_c[j]) <= 3 * POST_ATOL
                         and found(dc, ids_g[j], b_g[j], s_g[j])
                         and found(dg, ids_c[j], b_c[j], s_c[j]))
            print(f'  eval image {i} slot {j}: card class {ids_g[j]} score {s_g[j]!r}, cpu '
                  f'class {ids_c[j]} score {s_c[j]!r}, gap {abs(s_g[j] - s_c[j]):.3g}: '
                  f'{"a near-tie, exempt" if explained else "not a near-tie"}')
            _check(explained, f'eval image {i} slot {j}: the card\'s slate differs from '
                              f'the CPU\'s where no near-tie explains it')
        same = ~tie
        score_err = max(score_err, float(np.abs(s_g - s_c)[same].max(initial=0.0)))
        box_err = float(np.abs(b_g - b_c)[same & valid].max(initial=0.0))
        _check(score_err <= POST_ATOL and box_err <= POST_ATOL,
               f'eval image {i}: scores part by {score_err}, boxes by {box_err} '
               f'(limit {POST_ATOL})')
        keep = same[valid]          # the masks come in the order of the valid slots
        _check(og[3].shape == oc[3].shape, f'eval image {i}: mask shapes differ')
        if keep.any():
            mismatch = max(mismatch, float((og[3][keep] != oc[3][keep]).mean()))
        _check(mismatch < MASK_MISMATCH, f'eval image {i}: masks part in {mismatch} of '
                                         f'their pixels (limit {MASK_MISMATCH})')
        exempt += int(tie.sum())
    return score_err, mismatch, exempt


def phase_eval(dev, smi, kernel1):
    """The eval path on the card. Seeded res50_custom and res101_custom
    Detectors (float32, 544) are written as .ckpt files by the port's
    save_checkpoint; `python -m yolact_minimal_torch.eval --weight W
    --img_size 544` runs on each over the 48 images of custom_dataset/ in a
    subprocess, and res50_custom once more with --coco_api from a temporary
    working directory (both jsons written, the COCO stats printed). Then in
    this process: evaluate() on res50_custom with the launch counters set to
    0 just before (kernel 1 launches once a batch), and evaluate() on the
    first EVAL_CPU_IMAGES images on the card and on the CPU, float32 with
    TF32 off: the two tables and the slates must agree (`_hold_slates`).
    The planes kernel 1 got on the eval path, and what it gave, are recorded
    in the counted run; after the counts are read each batch is held exactly
    to the plain version and `kernel1` gains input (c). Returns the launch
    counts and the CLI's box and mask rows by config."""
    import os
    import tempfile
    import numpy as np
    import torch
    from yolact_minimal_torch.config import get_config
    from yolact_minimal_torch.data.coco import COCODetection
    from yolact_minimal_torch.eval import evaluate
    from yolact_minimal_torch.ops import nms
    from yolact_minimal_torch.pipeline import Detector, load_detector
    from yolact_minimal_torch.utils import timer
    from yolact_minimal_torch.utils.checkpoint import save_checkpoint
    from yolact_minimal_torch.utils.weights import to_jax_variables

    root = os.path.dirname(os.path.abspath(__file__))
    data = ['--val_imgs', os.path.join(root, 'custom_dataset', 'images'),
            '--val_ann', os.path.join(root, 'custom_dataset', 'annotations.json')]
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ckpts = {}
        for name in EVAL_CONFIGS:
            det = Detector(get_config(name, img_size=IMG), device=dev, seed=0)
            ckpts[name] = os.path.join(tmp, f'seeded_{name}_0.ckpt')
            save_checkpoint(ckpts[name], to_jax_variables(det.model.state_dict()))
            del det
        torch.cuda.empty_cache()
        cli_rows = {}
        for name, path in ckpts.items():
            out, seconds = _run_cli('eval', ['--weight', path, '--img_size', str(IMG)], root)
            rows = cli_rows[name] = _table_rows(out)
            print(f'eval CLI {name} {IMG}, 48 images of custom_dataset/, val_bs {EVAL_BS}, '
                  f'float32: exit 0 in {seconds:.2f} s (start-up, checkpoint read and model '
                  f'build included); box row {rows["box"]}, mask row {rows["mask"]}')
            print(_rate_line(f'  eval CLI {name} at {IMG}', *_cli_rate(out), smi))
        work = os.path.join(tmp, 'work')
        os.makedirs(work)
        out, seconds = _run_cli('eval', ['--weight', ckpts['res50_custom'], '--img_size',
                                         str(IMG), '--coco_api', *data], work)
        for name in ('bbox_detections.json', 'mask_detections.json'):
            with open(os.path.join(work, 'results', name)) as f:
                n = len(json.load(f))
            _check(n > 0, f'--coco_api wrote an empty {name}')
            print(f'eval CLI --coco_api: results/{name} holds {n} detections')
        stats = re.findall(r' (bbox|segm) +(\w+): (-?[\d.]+)', out)
        _check(len(stats) == 24 and all(math.isfinite(float(v)) for _, _, v in stats),
               f'--coco_api printed {len(stats)} of 24 COCO stats:\n{out[-2000:]}')
        print(f'eval CLI --coco_api in {seconds:.2f} s: ' +
              ', '.join(f'{k} {n} {v}' for k, n, v in stats if n in ('AP', 'AP50', 'AR100')))

        tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        cfg = get_config('res50_custom', mode='val', img_size=IMG)
        ds = COCODetection(cfg, mode='val')
        det = load_detector(ckpts['res50_custom'], cfg, device=dev)
        counters = _counters('res50_custom')
        planes, kernel = [], nms.suppression_iou_max

        def recording(*args):
            out = kernel(*args)
            planes.append(([a.clone() for a in args], out.clone()))
            return out
        nms.suppression_iou_max = recording
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        try:
            evaluate(det, cfg)
        finally:
            nms.suppression_iou_max = kernel
        seconds = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        batches = -(-len(ds) // EVAL_BS)
        print(f'res50_custom/eval in this process: {len(ds)} images in {seconds:.2f} s, '
              f'launches {launches} ({batches} batches)')
        _check(launches['suppression_iou_max'] == batches and launches['mask_finalize'] == 0,
               f'the eval path launched {launches}, expected suppression once a batch')
        _check(len(planes) == batches, f'recorded {len(planes)} of {batches} kernel 1 calls')
        held = [_hold_suppression(f'(c) eval path, batch {b}', *p, timed=b == 0)
                for b, p in enumerate(planes)]
        c = dict(held[0], batches=len(held), max_abs_err=max(h['max_abs_err'] for h in held),
                 timed='batch 0')
        kernel1['inputs']['c_eval_path'] = c
        kernel1['max_abs_err'] = max(kernel1['max_abs_err'], c['max_abs_err'])
        kernel1['agreement'] = ('exact, NaN positions equal, on inputs (a), (b) and (c) the '
                                'planes of every res50_custom/eval batch')
        t_t, t_fetch, t_after, t_metric = timer.get_times(['batch', 'fetch', 'after_nms',
                                                             'metric'])
        print(_rate_line(f'  res50_custom evaluate() at {IMG}', EVAL_BS / t_t, t_t, t_fetch,
                         t_after, t_metric, smi))
        x = torch.from_numpy(np.stack([ds.get_val(i)['image'] for i in range(EVAL_BS)])).to(dev)
        card_ms = _time_ms(lambda: det(x), warmup=2, iters=10)
        print(f'  the card\'s part, Detector.__call__ on one batch of {EVAL_BS} (forward, decode, '
              f'NMS, masks at proto size): {card_ms:.3f} ms (CUDA events, median of 10), '
              f'{card_ms / (t_t * 1e3):.3f} of the eval batch: the card idles the rest')

        cfg = get_config('res50_custom', mode='val', img_size=IMG, val_num=EVAL_CPU_IMAGES)
        cpu = load_detector(ckpts['res50_custom'], cfg, device='cpu')
        logs = ([], [])
        for d, log in zip((det, cpu), logs):
            post = d.postprocess_host

            def record(dets, masks_proto, h, w, visual_thre=None, post=post, log=log):
                out = post(dets, masks_proto, h, w, visual_thre)
                log.append((dets, out))
                return out
            d.postprocess_host = record
        t0 = time.perf_counter()
        on_card = evaluate(det, cfg, max_images=EVAL_CPU_IMAGES)
        on_cpu = evaluate(cpu, cfg, max_images=EVAL_CPU_IMAGES)
        print(f'eval card vs CPU, float32, TF32 off, first {EVAL_CPU_IMAGES} images '
              f'({time.perf_counter() - t0:.2f} s): card box {on_card[1]}, mask {on_card[2]}; '
              f'cpu box {on_cpu[1]}, mask {on_cpu[2]}')
        _check(on_card[1:] == on_cpu[1:], 'the card\'s eval table differs from the CPU\'s')
        score_err, mismatch, exempt = _hold_slates(*logs)
        print(f'  slates card vs CPU: {exempt} slots exempt as near-ties, max |score card - '
              f'cpu| {score_err:.3g} (limit {POST_ATOL}), largest mask mismatch '
              f'{mismatch:.3g} (limit {MASK_MISMATCH})')
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        del det, cpu
    torch.cuda.empty_cache()
    print(f'eval phase: {time.perf_counter() - t_phase:.2f} s')
    return launches, cli_rows


# --- phase 8: training ----------------------------------------------------------

def check_train_autograd(dev):
    """Kernels 3-6 under autograd at swin_tiny's training shapes (544,
    train_bs 8), bf16: the kernel forward and its backward (kernel 3's
    backward kernel; for kernels 4-6 the plain version recomputed under
    autograd) against the plain version's forward and autograd on the same
    inputs and cotangent; forward and backward
    timed with CUDA events and in device time. The block kernels take the
    shifted windows of the stage's padded map (region and rowmask), weights
    in bf16 as models/swin.py hands them over. Returns {kernel: per-stage
    list}."""
    import torch
    from yolact_minimal_torch.models.swin import pad_rowmask, shifted_window_regions
    from yolact_minimal_torch.ops.attn_block import attn_block, attn_block_plain
    from yolact_minimal_torch.ops.swin_block import swin_block, swin_block_plain
    from yolact_minimal_torch.ops.swin_mlp import mlp_block, mlp_block_plain
    from yolact_minimal_torch.ops.window_attention import window_attention, window_attention_plain
    g = torch.Generator(device=dev).manual_seed(8)
    g_blocks = torch.Generator(device=dev).manual_seed(9)
    bf16 = torch.bfloat16
    out = {'window_attention': [], 'swin_mlp': [], 'attn_block': [], 'swin_block': []}

    def held(name, stage, fn, plain, inputs, cot):
        """Forward and gradients of fn against plain's; returns the worst
        |kernel - plain| / max |plain| over the output and the gradients,
        and fn's forward and backward times."""
        def run(f):
            leaves = [t.clone().requires_grad_(t.is_floating_point()) for t in inputs]
            y = f(*leaves)
            wanted = [t for t in leaves if t.requires_grad]
            return [y.detach()] + list(torch.autograd.grad(y, wanted, cot))
        worst = 0.0
        for got, ref in zip(run(fn), run(plain)):
            _check(got.dtype == ref.dtype, f'{name} stage {stage}: gradient types differ')
            worst = max(worst, _rel_err(got, ref)[1])
        _check(worst <= SWIN_BF16_REL_TOL, f'{name} stage {stage} under autograd: |kernel - '
               f'plain| is {worst:.3g} of max |plain| (> {SWIN_BF16_REL_TOL:.3g})')
        leaves = [t.clone().requires_grad_(t.is_floating_point()) for t in inputs]
        wanted = [t for t in leaves if t.requires_grad]
        fwd = lambda: fn(*leaves)
        y = fwd()
        bwd = lambda: torch.autograd.grad(y, wanted, cot, retain_graph=True)
        times = dict(ms=_time_ms(fwd), device_ms=_device_ms(fwd), backward_ms=_time_ms(bwd),
                     backward_device_ms=_device_ms(bwd), grad_rel_err=worst)
        print(f'  {name} stage {stage} under autograd, bf16: forward {times["ms"]:.4f} ms (device '
              f'{times["device_ms"]:.4f}), backward {times["backward_ms"]:.4f} '
              f'ms (device {times["backward_device_ms"]:.4f}); output and gradients within '
              f'{worst:.3g} of max |plain| (<= {SWIN_BF16_REL_TOL:.3g})')
        return times

    print('phase 8a: kernels 3-6 under autograd at the training shapes (544, train_bs 8)')
    for stage, (bnw, nw, c, heads, rows) in enumerate(TRAIN_SWIN_STAGES):
        side, padded = SWIN_MAPS[stage]
        region = torch.from_numpy(shifted_window_regions(padded, padded)).to(dev)
        rowmask = torch.from_numpy(pad_rowmask(side, side, padded, padded, 3)).to(dev)
        qkv = torch.randn(bnw, 49, 3 * c, device=dev, generator=g).to(bf16)
        bias = (torch.randn(heads, 49, 49, device=dev, generator=g) * 0.1).to(bf16)
        cot = torch.randn(bnw, 49, c, device=dev, generator=g).to(bf16)
        t = held('window_attention', stage, lambda q, b: window_attention(q, b, region, heads),
                 lambda q, b: window_attention_plain(q, b, region, heads), (qkv, bias), cot)
        out['window_attention'].append(dict(shape=[bnw, 49, 3 * c], heads=heads, **t))
        x = torch.randn(rows, c, device=dev, generator=g).to(bf16)
        f32 = lambda *s, scale=0.05: torch.randn(*s, device=dev, generator=g) * scale
        ln = (f32(c, scale=0.1) + 1.0, f32(c, scale=0.1))
        mlp = (f32(4 * c, c).to(bf16), f32(4 * c), f32(c, 4 * c).to(bf16), f32(c))
        t = held('swin_mlp', stage, mlp_block, mlp_block_plain, (x,) + ln + mlp,
                 torch.randn(rows, c, device=dev, generator=g).to(bf16))
        out['swin_mlp'].append(dict(shape=[rows, c], **t))
        # kernels 5 and 6 draw from their own generator: kernels 3 and 4 keep their inputs
        f32 = lambda *s, scale=0.05: torch.randn(*s, device=dev, generator=g_blocks) * scale
        x = torch.randn(bnw, 49, c, device=dev, generator=g_blocks).to(bf16)
        attn = (f32(3 * c, c).to(bf16), f32(3 * c), bias, f32(c, c).to(bf16), f32(c))
        t = held('attn_block', stage,
                 lambda x, wq, bq, b, wp, bp: attn_block(x, wq, bq, b, region, wp, bp, heads),
                 lambda x, wq, bq, b, wp, bp: attn_block_plain(x, wq, bq, b, region, wp, bp,
                                                               heads), (x,) + attn, cot)
        out['attn_block'].append(dict(shape=[bnw, 49, c], heads=heads, **t))

        def whole(f):
            return lambda x, l1s, l1b, wq, bq, b, wp, bp, *rest: f(
                x, rowmask, l1s, l1b, wq, bq, b, region, wp, bp, *rest, heads)
        t = held('swin_block', stage, whole(swin_block), whole(swin_block_plain),
                 (x,) + ln + attn + ln + mlp, cot)
        out['swin_block'].append(dict(shape=[bnw, 49, c], heads=heads, **t))
        del qkv, bias, x, ln, mlp, attn, cot
        torch.cuda.empty_cache()
    return out


# Kernel 3's backward at the training shapes of TRAIN_BS and of the
# benchmark's swin_tiny_coco.train_b64 cell (8 times the windows), shifted:
# the bf16 kernel against the plain recompute it replaced, each tensor of the
# gradient within WA_BACKWARD_GAP of the plain one in relative L2 (both round
# at the same places: the kernel reads under 1.4e-4, a backward that rounds
# dS to bf16 ~2.6e-3, tests/test_torch_window_attention_backward.py). Bound: qkv and the incoming gradient read and d_qkv
# written once, 14 C bytes a padded row, against five products of
# 2 * 49 * 49 * 32 operations a (window, head).
WA_BACKWARD_BATCHES = (TRAIN_BS, 64)
WA_BACKWARD_GAP = 5e-4


def check_window_attention_backward(dev):
    """Kernel 3's backward (ops/window_attention.py::window_attention_backward,
    the bf16 kernel) beside the plain recompute under autograd
    (window_attention_backward_plain) at each swin_tiny stage, batches
    WA_BACKWARD_BATCHES at 544, shifted: the gaps of dq, dk, dv and d_bias,
    both timed with CUDA events and in device time, and the kernel's bound. Returns a list of per-stage dicts."""
    import torch
    from yolact_minimal_torch.models.swin import shifted_window_regions
    from yolact_minimal_torch.ops.window_attention import (window_attention_backward,
                                                           window_attention_backward_plain)
    g = torch.Generator(device=dev).manual_seed(10)
    bf16 = torch.bfloat16
    out = []
    print('phase 8a: kernel 3\'s backward against the plain recompute, shifted, bf16')
    for batch in WA_BACKWARD_BATCHES:
        for stage, (bnw, nw, c, heads, _) in enumerate(TRAIN_SWIN_STAGES):
            bnw = bnw * batch // TRAIN_BS
            region = torch.from_numpy(shifted_window_regions(*(SWIN_MAPS[stage][1],) * 2)).to(dev)
            qkv = torch.randn(bnw, 49, 3 * c, device=dev, generator=g).to(bf16)
            bias = (torch.randn(heads, 49, 49, device=dev, generator=g) * 0.1).to(bf16)
            grad = torch.randn(bnw, 49, c, device=dev, generator=g).to(bf16)
            kernel = lambda: window_attention_backward(qkv, bias, region, heads, grad)
            plain = lambda: window_attention_backward_plain(qkv, bias, region, heads, grad)
            (got, got_bias), (ref, ref_bias) = kernel(), plain()
            pairs = [(got[..., i * c:(i + 1) * c], ref[..., i * c:(i + 1) * c]) for i in range(3)]
            gaps = [((a.float() - b.float()).norm() / b.float().norm()).item()
                    for a, b in pairs + [(got_bias, ref_bias)]]
            _check(max(gaps) <= WA_BACKWARD_GAP, f'kernel 3 backward, batch {batch} stage '
                   f'{stage}: dq, dk, dv, d_bias gaps {gaps} (> {WA_BACKWARD_GAP})')
            bound, bound_by = _bound_ms(14 * c * bnw * 49, 5 * 2 * 49 * 49 * 32 * bnw * heads,
                                        BF16_PEAK)
            t = dict(batch=batch, stage=stage, shape=[bnw, 49, 3 * c], heads=heads,
                     ms=_time_ms(kernel), device_ms=_device_ms(kernel),
                     plain_ms=_time_ms(plain), plain_device_ms=_device_ms(plain),
                     bound_ms=bound, bound_by=bound_by, gaps=gaps)
            print(f'  batch {batch} stage {stage} {tuple(t["shape"])}: kernel {t["ms"]:.4f} ms '
                  f'(device {t["device_ms"]:.4f}), plain recompute {t["plain_ms"]:.4f} ms (device '
                  f'{t["plain_device_ms"]:.4f}), bound {bound:.5f} ms ({bound_by}); '
                  f'relative L2 gaps dq {gaps[0]:.3g} dk {gaps[1]:.3g} dv {gaps[2]:.3g} '
                  f'd_bias {gaps[3]:.3g}')
            out.append(t)
            del qkv, bias, grad, got, got_bias, ref, ref_bias, pairs
            torch.cuda.empty_cache()
    return out


def _train_batches(n):
    """n batches of custom_dataset/ at IMG, TRAIN_BS a batch, from the port's
    TrainLoader (seed 0, worker processes); the loader is closed after."""
    import os
    from yolact_minimal_torch.config import get_config
    from yolact_minimal_torch.data.coco import COCODetection, TrainLoader
    root = os.path.dirname(os.path.abspath(__file__))
    cfg = get_config('res50_coco', mode='train', img_size=IMG, train_bs=TRAIN_BS,
                     train_imgs=os.path.join(root, 'custom_dataset/images'),
                     train_ann=os.path.join(root, 'custom_dataset/annotations.json'))
    loader = TrainLoader(COCODetection(cfg, mode='train'), cfg, batch_size=TRAIN_BS,
                         num_workers=TRAIN_WORKERS, seed=0)
    batches, t0 = [], time.perf_counter()
    try:
        while len(batches) < n:
            for batch in loader:
                batches.append(batch)
                if len(batches) == n:
                    break
    finally:
        loader.close()
    seconds = time.perf_counter() - t0
    print(f'train batches: {n} of {TRAIN_BS} at {IMG} from custom_dataset/ through TrainLoader '
          f'({TRAIN_WORKERS} worker processes) in {seconds:.2f} s, worker start-up included')
    return batches


def phase_train_path(dev, name, dtype, batches, smi):
    """`name` at IMG, train_bs TRAIN_BS, compute dtype `dtype` (float32 with
    TF32 off), seeded init: train_step over the batches (2 warm-up, then
    timed on the host clock to a synchronize), the launch counters set to 0
    before and read after, losses finite; peak device memory; then one step
    under torch.profiler for the device's busy share. Returns (launches,
    numbers)."""
    import torch
    from yolact_minimal_torch.config import get_config
    from yolact_minimal_torch.train_state import create_train_state, train_step
    cfg = get_config(name, mode='train', img_size=IMG, train_bs=TRAIN_BS, compute_dtype=dtype)
    state = create_train_state(cfg, dev, seed=0)
    counters = _counters(name)
    _zero_counters(counters)
    totals = []
    for batch in batches[:2]:                                   # warm-up
        totals.append(float(train_step(state, batch).total))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    timed = batches[2:]
    t0 = time.perf_counter()
    losses = [train_step(state, batch) for batch in timed]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / len(timed) * 1e3
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    launches = _read_counters(counters)
    steps = len(batches)
    totals += [float(l.total) for l in losses]
    _check(all(math.isfinite(t) for t in totals), f'{name} {dtype}: non-finite loss {totals}')
    if name.startswith('swin'):
        # kernel 3 and its backward kernel in all 12 blocks, kernel 4 where
        # stochastic depth is off (block 0)
        want = {k: n * steps for k, n in TRAIN_LAUNCHES_PER_STEP.items()}
        _check(all(launches[k] == n for k, n in want.items())
               and launches['attn_block'] == launches['swin_block'] == 0,
               f'{name} train: expected {want} launches over {steps} steps, got {launches}')
    else:
        _check(launches['window_attention_backward'] == 0,
               f'{name} train launched kernel 3\'s backward kernel: {launches}')
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t1 = time.perf_counter()
        train_step(state, timed[0])
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t1) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    busy = device_ms / step_ms
    groups = dict.fromkeys([g for g, _ in GROUPS] + ['other'], 0.0)
    for e in kernels:
        groups[next((g for g, pat in GROUPS if re.search(pat, e.key)), 'other')] += \
            e.self_device_time_total / 1e3
    host_ops = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CPU),
                      key=lambda e: -e.self_cpu_time_total)[:6]
    numbers = dict(ms_per_step=step_ms, img_per_s=TRAIN_BS / step_ms * 1e3, peak_gb=peak_gb,
                   device_ms_per_step=device_ms, busy_share=busy, traced_ms=traced_ms,
                   first_loss=totals[0], last_loss=totals[-1])
    print(f'{name} train {dtype} {IMG}/b{TRAIN_BS}: {step_ms:.3f} ms a step ({len(timed)} steps '
          f'after 2 warm-up, host clock to a synchronize; batches on the host, copied in the '
          f'step), {TRAIN_BS / step_ms * 1e3:.2f} img/s, peak device memory {peak_gb:.2f} GiB, '
          f'one profiled step {device_ms:.3f} device ms ({traced_ms:.3f} ms traced): busy '
          f'share {busy:.3f}; total loss {totals[0]:.3f} -> {totals[-1]:.3f}; launches '
          f'{launches}; on {smi}')
    print('  device ms by kernel group: ' + ', '.join(
        f'{g} {ms:.3f}' for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]) if ms) +
          f'; {sum(e.count for e in kernels)} kernel launches')
    print('  host ms by operator (self CPU time, traced): ' + ', '.join(
        f'{e.key} {e.self_cpu_time_total / 1e3:.3f} ({e.count})' for e in host_ops))
    numbers.update(groups_ms=groups, kernel_launches=sum(e.count for e in kernels))
    del state
    torch.cuda.empty_cache()
    return launches, numbers


def phase_train_mixed(dev, batches, smi):
    """8e: swin_tiny_coco at IMG, train_bs TRAIN_BS in the 'mixed' forms
    (kernels 6 and 5 under autograd in a training step). bf16: two steps
    (the first warm-up), the counters set to 0 before and read after, each
    step launching exactly MIXED_TRAIN_LAUNCHES_PER_STEP, losses finite, the
    second step timed. float32 (TF32 off): one step in 'mixed' and one in
    'composed' from the same seeded init on the same batch and step
    generator; the first losses within FORM_REL_TOL of each other, the
    gradients' distance printed. Returns (launches, numbers)."""
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
    totals = [float(train_step(state, batches[0]).total)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    totals.append(float(train_step(state, batches[1]).total))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    launches = _read_counters(counters)
    want = {k: 2 * n for k, n in MIXED_TRAIN_LAUNCHES_PER_STEP.items()}
    _check(all(math.isfinite(t) for t in totals), f'{name} mixed bf16: non-finite loss {totals}')
    _check({k: launches[k] for k in want} == want and launches['suppression_iou_max'] == 0 and
           launches['mask_finalize'] == 0, f'{name} mixed train: expected {want} launches over '
           f'2 steps, got {launches}')
    print(f'8e. {name} train bfloat16 {IMG}/b{TRAIN_BS} in the forms {mixed}: the second step '
          f'{step_ms:.3f} ms (host clock to a synchronize), total loss {totals[0]:.4f} -> '
          f'{totals[1]:.4f}; launches over 2 steps {launches} (a step: '
          f'{MIXED_TRAIN_LAUNCHES_PER_STEP}); on {smi}')
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
    print(f'8e. {name} train float32 (TF32 off), one step in {mixed} against composed from the '
          f'same init and batch: losses within {max(rel):.3g} relative (<= {FORM_REL_TOL}); '
          f'gradients {total:.3g} of their L2 norm apart, the backbone\'s tensors at most '
          f'{backbone:.3g}, the worst tensor {worst} {per_tensor[worst]:.3g}')
    return launches, dict(ms_bf16_second_step=step_ms, losses_bf16=totals,
                          float32_loss_rel=max(rel), float32_grad_rel=total,
                          float32_grad_rel_backbone=backbone,
                          float32_grad_rel_worst={worst: per_tensor[worst]})


def phase_train_cli(smi):
    """`python -m yolact_minimal_torch.train` as a user runs it: res50_custom
    at TRAIN_CLI_IMG, train_bs 8, lr 2e-4, TRAIN_CLI_STEPS steps with one
    validation at step TRAIN_CLI_VAL over custom_dataset/'s 48 images, from a
    temporary working directory. The logged total loss must fall (mean of
    the last 10 log lines below the first 10), the latest and best
    checkpoints must be written. Prints the validation's box and mask
    rows."""
    import os
    import tempfile
    root = os.path.dirname(os.path.abspath(__file__))
    data = [os.path.join(root, p) for p in ('custom_dataset/images',
                                            'custom_dataset/annotations.json')]
    args = ['--cfg', 'res50_custom', '--img_size', str(TRAIN_CLI_IMG), '--train_bs', '8',
            '--lr', '2e-4', '--max_steps', str(TRAIN_CLI_STEPS), '--val_interval',
            str(TRAIN_CLI_VAL), '--num_workers', str(TRAIN_WORKERS),
            '--train_imgs', data[0], '--train_ann', data[1], '--val_imgs', data[0],
            '--val_ann', data[1]]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get('PYTHONPATH')) if p))
    with tempfile.TemporaryDirectory() as cwd:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, '-m', 'yolact_minimal_torch.train', *args],
                              cwd=cwd, env=env, capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        _check(proc.returncode == 0, f'train CLI exited {proc.returncode}:\n'
                                     f'{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}')
        weights = sorted(os.listdir(os.path.join(cwd, 'weights')))
    out = proc.stdout
    logged = [tuple(float(x) for x in m) for m in re.findall(
        r'step: \d+ \| lr: \S+ \| l_class: (\S+) \| l_box: (\S+) \| l_mask: (\S+) \| '
        r'l_semantic: (\S+) \| t_t: (\S+) \| t_d: (\S+) \| t_step: (\S+)', out)]
    _check(len(logged) >= 20, f'the train CLI logged {len(logged)} steps:\n{out[-2000:]}')
    totals = [sum(l[:4]) for l in logged]
    first, last = statistics.mean(totals[:10]), statistics.mean(totals[-10:])
    _check(all(math.isfinite(t) for t in totals) and last < first,
           f'the train CLI loss did not fall: {totals}')
    rows = _table_rows(out)
    _check(f'latest_res50_custom_{TRAIN_CLI_STEPS}.ckpt' in weights and
           any(w.startswith('best_') and w.endswith(f'_res50_custom_{TRAIN_CLI_VAL}.ckpt')
               for w in weights), f'the train CLI wrote {weights}')
    t_t, t_d, t_step = logged[-1][4:]
    print(f'train CLI res50_custom {TRAIN_CLI_IMG}/b8 lr 2e-4, {TRAIN_CLI_STEPS} steps, '
          f'{seconds:.2f} s: logged total loss (l_class + l_box + l_mask + l_semantic) mean of '
          f'the first 10 log lines {first:.3f} -> last 10 {last:.3f}; last t_t {t_t:.3f} s, '
          f't_d {t_d:.3f} s, t_step {t_step:.3f} s; wrote {weights}; on {smi}')
    print(f'  validation at step {TRAIN_CLI_VAL} over custom_dataset/ (48 images), '
          f'thresholds all, 50, 55, ..., 95:')
    for k in ('box', 'mask'):
        print(f'  {k:4s} ' + ' '.join(f'{v:6.2f}' for v in rows[k]))
    return dict(seconds=seconds, first_loss=first, last_loss=last, rows=rows, t_step=t_step)


def phase_train(dev, smi, kernels, batches):
    """Phase 8: kernels 3 and 4 under autograd (8a), res50_coco in float32
    and bf16 and swin_tiny_coco in bf16 at 544, train_bs 8 on
    custom_dataset/ (8b, 8c; `batches` from _train_batches), the train CLI
    (8d). Adds each path's launch counts to `kernels`' launches_by_path
    through the returned dict."""
    import torch
    t_phase = time.perf_counter()
    auto = check_train_autograd(dev)
    backward = check_window_attention_backward(dev)
    for k in kernels:
        if k['name'] == 'window_attention':
            k['backward_kernel'] = backward
        if k['name'] in auto:
            k['train'] = dict(per_stage=auto[k['name']],
                              launches_per_step=TRAIN_LAUNCHES_PER_STEP.get(k['name'], 0),
                              launches_per_step_mixed=MIXED_TRAIN_LAUNCHES_PER_STEP[k['name']])
            k['backward_ms'] = auto[k['name']][0]['backward_ms']
            k['backward_device_ms'] = auto[k['name']][0]['backward_device_ms']
            k['grad_rel_err'] = max(t['grad_rel_err'] for t in auto[k['name']])
    by_path, numbers = {}, {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False      # float32 convolutions in float32
    try:
        for name, dtype in (('res50_coco', 'float32'), ('res50_coco', 'bfloat16'),
                            ('swin_tiny_coco', 'bfloat16')):
            path = f'{name}/train_{dtype}'
            by_path[path], numbers[path] = phase_train_path(dev, name, dtype, batches, smi)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    path = 'swin_tiny_coco/train_mixed_bfloat16'
    by_path[path], numbers[path] = phase_train_mixed(dev, batches, smi)
    numbers['cli'] = phase_train_cli(smi)
    print(f'train phase: {time.perf_counter() - t_phase:.2f} s')
    return by_path, numbers


# --- phase 9: export and video ---------------------------------------------------

# The swin artifact's batch, the path whose forms it is exported with, and
# the name of its launches in the kernels line; the seeded clip: frames (not
# a multiple of the video batch), the detect CLI's video batch, width x height.
EXPORT_SWIN_BATCH = 8
EXPORT_FORMS = 'mixed'
EXPORT_PATH = f'swin_tiny_coco/export_{EXPORT_FORMS}'
VIDEO_FRAMES, VIDEO_BS, VIDEO_SIZE = 11, 4, (640, 480)
EXPORT_TIMED_ITERS = 20
# The fresh process that runs the swin artifact: it imports the operator
# registrations (deploy.py) and the kernel wrappers, nothing of models/; sets
# every launch counter to 0, calls the artifact once on the saved images and
# writes the outputs, then prints the launches, the modules of models/ (or
# JAX) it holds, and the artifact's meta.
EXPORT_CHILD = """
import json, sys
import torch
from yolact_minimal_torch.deploy import load_exported
from yolact_minimal_torch.ops.attn_block import attn_block
from yolact_minimal_torch.ops.mask_finalize import mask_finalize
from yolact_minimal_torch.ops.suppression import suppression_iou_max
from yolact_minimal_torch.ops.swin_block import swin_block
from yolact_minimal_torch.ops.swin_mlp import mlp_block
from yolact_minimal_torch.ops.window_attention import window_attention
artifact, images, out, device = sys.argv[1:5]
counters = dict(suppression_iou_max=suppression_iou_max, mask_finalize=mask_finalize,
                window_attention=window_attention, swin_mlp=mlp_block,
                attn_block=attn_block, swin_block=swin_block)
call, meta, anchors = load_exported(artifact, device=device)
x = torch.load(images).to(device)
for f in counters.values():
    f.launches = 0
outs = call(x)
if device == 'cuda':
    torch.cuda.synchronize()
launches = {k: f.launches for k, f in counters.items()}
held = sorted(k for k in sys.modules if k.startswith('yolact_minimal_torch.models')
              or k.split('.')[0] in ('jax', 'flax', 'yolact_minimal_tpu'))
torch.save([o.cpu() for o in outs], out)
print(json.dumps(dict(launches=launches, held=held, meta=meta)))
"""


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


def _seeded_pngs(folder, seed):
    """Two seeded PNGs of different shapes (colour ramps plus noise) in
    `folder`; returns {name: (h, w)}."""
    import os
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


def _fps_of(out, what):
    m = re.findall(r'Finished, (\d+) frames at ([\d.]+) fps', out)
    _check(m, f'{what} printed no frame rate:\n{out[-2000:]}')
    return int(m[-1][0]), float(m[-1][1])


def phase_export(dev, smi):
    """Phase 9: export and video on the card. (a) the export CLI on a seeded
    res50_coco .ckpt (544, float32, batch 1) must print the parity line, the
    driver must draw two seeded PNGs at their shapes; (b) swin_tiny_coco (544,
    bf16, batch EXPORT_SWIN_BATCH) in the EXPORT_FORMS forms through
    deploy.export_model, loaded in a fresh process without models/: it must
    launch kernels 3-6 as that path's forward does and no other kernel, give
    the live model's outputs bit for bit, and its numpy tail must agree with
    detect_postprocess_batch on the card; (c) a seeded VIDEO_FRAMES-frame mp4
    through the detect CLI (--video_bs VIDEO_BS) and the driver: each must
    write every frame at the clip's size; (d) the artifact calls against the
    live forwards (CUDA events, median of EXPORT_TIMED_ITERS), the export
    seconds, the CLIs' frame rates. Returns (the swin artifact's launches of
    the four swin kernels, the numbers)."""
    import json
    import os
    import tempfile
    import numpy as np
    import torch
    from yolact_minimal_torch import deploy
    from yolact_minimal_torch.config import get_config
    from yolact_minimal_torch.ops.nms import detect_postprocess_batch
    from yolact_minimal_torch.ops.nms_numpy import detect_postprocess_numpy
    from yolact_minimal_torch.pipeline import Detector, load_detector
    from yolact_minimal_torch.utils import image_io, video
    from yolact_minimal_torch.utils.checkpoint import save_checkpoint
    from yolact_minimal_torch.utils.weights import to_jax_variables

    t_phase = time.perf_counter()
    numbers = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) res50_coco: the export CLI, then the driver on two PNGs
        det = Detector(get_config('res50_coco', img_size=IMG), device=dev, seed=0)
        sd = {k: v.cpu() for k, v in det.model.state_dict().items()}
        sd['prediction_layers.conf_layer.bias'][1::81] += 6.0     # detections to draw
        del det
        weight = os.path.join(tmp, 'seeded_res50_coco.ckpt')
        save_checkpoint(weight, to_jax_variables(sd))
        on = ['--device', dev.type]
        out, cli_s = _run_cli('export', ['--weight', weight, '--img_size', str(IMG), *on], tmp)
        _check('Export parity check passed.' in out,
               f'the export CLI printed no parity line:\n{out}')
        res50_artifact = os.path.join(tmp, 'seeded_res50_coco.pt2')
        numbers['res50_export_s'] = float(re.search(r'Exported to \S+ in ([\d.]+) s', out).group(1))
        print(f'9a. export CLI, res50_coco {IMG} float32 batch 1: parity line printed; export '
              f'{numbers["res50_export_s"]:.2f} s (trace, save, reload, parity), CLI '
              f'{cli_s:.2f} s in all; artifact {os.path.getsize(res50_artifact) / 2 ** 20:.1f} MiB')
        shapes = _seeded_pngs(os.path.join(tmp, 'images'), 9)
        out, cli_s = _run_cli('detect_with_export', ['--artifact', res50_artifact, '--image',
                                                     os.path.join(tmp, 'images'), *on], tmp)
        for name, shape in shapes.items():
            path = os.path.join(tmp, 'results', 'export_images', name)
            _check(os.path.exists(path), f'the driver wrote no {name}')
            drawn = image_io.imread(path)
            _check(drawn.shape == shape + (3,), f'{name}: drawn {drawn.shape}, input {shape}')
            _check(not np.array_equal(drawn, image_io.imread(os.path.join(tmp, 'images', name))),
                   f'{name}: nothing was drawn')
        numbers['driver_image_fps'] = float(re.findall(r'fps: ([\d.]+)', out)[-1])
        print(f'    driver --image: both drawn PNGs {list(shapes.values())} at their shapes, '
              f'{cli_s:.2f} s in all, {numbers["driver_image_fps"]:.2f} img/s after the first')

        # (b) swin_tiny_coco, all four swin kernels in one artifact
        cfg = get_config('swin_tiny_coco', img_size=IMG, compute_dtype='bfloat16',
                         nms_score_thre=SCORE_THRE)
        det = Detector(cfg, device=dev, seed=0)
        det.model.backbone.set_block_forms(SWIN_PATHS[EXPORT_FORMS])
        swin_artifact = os.path.join(tmp, f'swin_tiny_coco_{EXPORT_FORMS}.pt2')
        t0 = time.perf_counter()
        deploy.export_model(cfg, det.model, swin_artifact, batch=EXPORT_SWIN_BATCH, device=dev)
        numbers['swin_export_s'] = time.perf_counter() - t0
        g = torch.Generator(device=dev).manual_seed(3)
        images = torch.randn(EXPORT_SWIN_BATCH, IMG, IMG, 3, device=dev, generator=g)
        with torch.inference_mode():
            live = det.model(images)
        torch.save(images.cpu(), os.path.join(tmp, 'images.pt'))
        out, child_s = _run_cli(None, [EXPORT_CHILD, swin_artifact, os.path.join(tmp, 'images.pt'),
                                       os.path.join(tmp, 'outs.pt'), dev.type], tmp)
        child = json.loads(out.strip().splitlines()[-1])
        launches = child['launches']
        want = dict(_swin_launches(EXPORT_FORMS), suppression_iou_max=0, mask_finalize=0)
        print(f'9b. swin_tiny_coco {IMG} bf16 batch {EXPORT_SWIN_BATCH}, forms '
              f'{child["meta"]["block_forms"]}: export {numbers["swin_export_s"]:.2f} s (parity '
              f'line above); fresh process ({child_s:.2f} s) held {child["held"] or "no module"} '
              f'of models/ or JAX; launches of one call {launches}, want {want}')
        _check(not child['held'], f'the artifact\'s process imported {child["held"]}')
        _check(child['meta']['block_forms'] == list(SWIN_PATHS[EXPORT_FORMS]),
               f'meta.json block forms {child["meta"]["block_forms"]}')
        _check(launches == want, f'the swin artifact launched {launches}, want {want}')
        outs = torch.load(os.path.join(tmp, 'outs.pt'))
        diffs = [float((o - l.cpu()).abs().max()) for o, l in zip(outs, live)]
        equal = [torch.equal(o, l.cpu()) for o, l in zip(outs, live)]
        print(f'    artifact against the live model, class / box / coef / proto: max |diff| '
              f'{" / ".join(f"{d:.3g}" for d in diffs)}, bit-equal {equal}')
        _check(all(equal), 'the swin artifact\'s outputs are not the live model\'s')
        anchors = det.anchors.cpu().numpy()
        dets = detect_postprocess_batch(*(o.to(dev) for o in outs[:3]), det.anchors,
                                        cfg.nms_score_thre, cfg.nms_iou_thre, cfg.top_k,
                                        cfg.max_detections, pre_topk=0)
        worst, counts = 0.0, []
        for j in range(EXPORT_SWIN_BATCH):
            _, _, _, scores = detect_postprocess_numpy(
                *(o[j].numpy() for o in outs[:3]), anchors, cfg.nms_score_thre,
                cfg.nms_iou_thre, cfg.top_k, cfg.max_detections)
            n = int(dets.valid[j].sum())
            counts.append(n)
            _check(n == (0 if scores is None else len(scores)),
                   f'image {j}: {n} device detections, numpy {scores is not None and len(scores)}')
            if n:
                worst = max(worst, float(np.abs(np.sort(dets.scores[j, :n].cpu().numpy()) -
                                                np.sort(scores)).max()))
        print(f'    numpy tail against detect_postprocess_batch on the card (pre_topk off, '
              f'score threshold {SCORE_THRE}): valid slots {counts} equal, sorted scores within '
              f'{worst:.3g}')
        _check(sum(counts) > 0 and worst <= 1e-5, f'sorted scores differ by {worst}')

        # (c) video: the detect CLI and the driver on a seeded clip
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
        out, video_s = _run_cli('detect', ['--weight', weight, '--video', clip, '--video_bs',
                                           str(VIDEO_BS), '--img_size', str(IMG), *on], tmp)
        frames, numbers['video_cli_fps'] = _fps_of(out, 'the detect CLI')
        got = _frames_of(os.path.join(tmp, 'results', 'videos', 'clip.mp4'))
        _check(frames == VIDEO_FRAMES and got == (VIDEO_FRAMES, VIDEO_SIZE),
               f'the detect CLI wrote {got} from {frames} frames')
        out, driver_s = _run_cli('detect_with_export', ['--artifact', res50_artifact, '--video',
                                                        clip, *on], tmp)
        frames, numbers['driver_video_fps'] = _fps_of(out, 'the driver')
        got2 = _frames_of(os.path.join(tmp, 'results', 'export_videos', 'clip.mp4'))
        _check(frames == VIDEO_FRAMES and got2 == (VIDEO_FRAMES, VIDEO_SIZE),
               f'the driver wrote {got2} from {frames} frames')
        print(f'9c. video, {VIDEO_FRAMES} frames {w}x{h}, res50_coco {IMG}: detect CLI '
              f'--video_bs {VIDEO_BS} {numbers["video_cli_fps"]:.2f} fps after its first batch '
              f'({video_s:.2f} s in all), driver (artifact batch 1) '
              f'{numbers["driver_video_fps"]:.2f} fps ({driver_s:.2f} s); both wrote {got}')

        # (d) each artifact call against the live forward, in turns
        call_s, _, _ = deploy.load_exported(swin_artifact, dev)
        call_r, _, _ = deploy.load_exported(res50_artifact, dev)
        live_r = load_detector(weight, get_config('res50_coco', img_size=IMG), device=dev).model

        def forward(model, x):
            with torch.inference_mode():
                return model(x)
        pairs = {'res50_coco float32 b1': (lambda: call_r(images[:1]),
                                           lambda: forward(live_r, images[:1])),
                 f'swin_tiny_coco bf16 b{EXPORT_SWIN_BATCH} {EXPORT_FORMS}':
                     (lambda: call_s(images), lambda: forward(det.model, images))}
        for what, (artifact_fn, live_fn) in pairs.items():
            runs = [_time_ms(f, iters=EXPORT_TIMED_ITERS)
                    for f in (artifact_fn, live_fn, live_fn, artifact_fn)]
            a, l = statistics.median(runs[::3]), statistics.median(runs[1:3])
            dev_a, dev_l = _device_ms(artifact_fn), _device_ms(live_fn)
            numbers[what] = dict(artifact_ms=a, live_ms=l, runs=runs, artifact_device_ms=dev_a,
                                 live_device_ms=dev_l)
            print(f'9d. {what}: artifact call {a:.3f} ms, live forward {l:.3f} ms (CUDA events, '
                  f'median of {EXPORT_TIMED_ITERS}, in turns artifact / live / live / artifact: '
                  f'{" / ".join(f"{r:.3f}" for r in runs)}); device time {dev_a:.3f} / '
                  f'{dev_l:.3f} ms (torch.profiler); on {smi}')
        del call_s, call_r, live_r, det, live, images
    numbers['phase_s'] = time.perf_counter() - t_phase
    print(f'export phase: {numbers["phase_s"]:.2f} s')
    torch.cuda.empty_cache()
    return {k: launches[k] for k in SWIN_KERNELS}, numbers

# --- phase 10: the flags (--traditional_nms, --save_lincomb, --remat, --backbone_weight)

# The train CLI's run with --backbone_weight and --remat: image size and
# steps (the log prints its losses at step 10, so 11 steps show one line);
# the steps of each train_step pair of 10d after its one compared step (2 of
# them warm-up); the remat step's losses against the plain step's.
FLAGS_CLI_IMG, FLAGS_CLI_STEPS = 256, 11
# 10a: the eval CLI's images (two batches: the rate leaves the first out).
# With random weights every anchor passes the score threshold for each of
# res50_custom's 4 classes, so greedy NMS takes ~1.7 s an image on the host.
FLAGS_EVAL_IMAGES = 2 * EVAL_BS
REMAT_STEPS = 5
REMAT_LOSS_RTOL = 1e-3
# 10c: the swin Detector's batch, and the share of the first image's
# foreground scores above its nms_score_thre (random-init scores are near
# 1/81: the default 0.05 would pass none, 0.002 all 18525 x 80).
TRAD_BATCH = 8
TRAD_PASS = 1e-3


def _host_library_line():
    """Build (or find) csrc/nms.cc's library with g++; the command and its
    seconds."""
    from yolact_minimal_torch.ops import _build
    target = _build.host_target('nms')
    built = not target.exists()
    t0 = time.perf_counter()
    _build.build_host('nms')
    seconds = time.perf_counter() - t0
    cmd = ' '.join(_build.host_command('nms', target))
    return (f'host library: {"built" if built else "found"} {target.name} '
            f'({seconds:.2f} s): {cmd}')


def _traditional_tail_numbers(det, x):
    """`det`'s raw outputs on x, fetched; per image the (anchor, class) pairs
    that reach the greedy loop, and the host ms of the whole tail. Returns
    (raw numpy outputs, candidates, tail ms, the tail's result)."""
    import torch
    from yolact_minimal_torch.pipeline import _to_host
    with torch.inference_mode():
        raw = _to_host(det._infer_raw(x))
    cand = [int((raw[0][b][:, 1:] > det.cfg.nms_score_thre).sum()) for b in range(len(x))]
    t0 = time.perf_counter()
    tail = det.traditional_tail(*raw)
    return raw, cand, (time.perf_counter() - t0) * 1e3, tail


def phase_flags_eval(dev, smi):
    """10a: `python -m yolact_minimal_torch.eval --traditional_nms` on phase
    3c's seeded res50_custom .ckpt at IMG over the first FLAGS_EVAL_IMAGES
    images of custom_dataset/: exit 0, finite rows; then in this process the
    counted launches of one eval batch (kernel 1 bypassed), the candidates
    that reach greedy NMS per image, the host ms of the tail and the batch's
    img/s up to the tail. Returns the launches."""
    import os
    import tempfile
    import numpy as np
    import torch
    from yolact_minimal_torch.config import get_config
    from yolact_minimal_torch.data.coco import COCODetection
    from yolact_minimal_torch.pipeline import Detector, load_detector
    from yolact_minimal_torch.utils.checkpoint import save_checkpoint
    from yolact_minimal_torch.utils.weights import to_jax_variables

    root = os.path.dirname(os.path.abspath(__file__))
    print(_host_library_line())
    with tempfile.TemporaryDirectory() as tmp:
        det = Detector(get_config('res50_custom', img_size=IMG), device=dev, seed=0)
        ckpt = os.path.join(tmp, 'seeded_res50_custom_0.ckpt')
        save_checkpoint(ckpt, to_jax_variables(det.model.state_dict()))
        del det
        out, seconds = _run_cli('eval', ['--weight', ckpt, '--img_size', str(IMG),
                                         '--traditional_nms', '--val_num',
                                         str(FLAGS_EVAL_IMAGES)], root)
        _check('traditional_nms: True' in out, 'the eval CLI did not take --traditional_nms')
        rows = _table_rows(out)
        print(f'10a. eval CLI --traditional_nms, res50_custom {IMG}, the first '
              f'{FLAGS_EVAL_IMAGES} images of custom_dataset/, float32: exit 0 in '
              f'{seconds:.2f} s; box row {rows["box"]}, mask row {rows["mask"]}')

        cfg = get_config('res50_custom', mode='val', img_size=IMG, traditional_nms=True,
                         val_imgs=os.path.join(root, 'custom_dataset', 'images'),
                         val_ann=os.path.join(root, 'custom_dataset', 'annotations.json'))
        det = load_detector(ckpt, cfg, device=dev)
        ds = COCODetection(cfg, mode='val')
        x = torch.from_numpy(np.stack([ds.get_val(i)['image'] for i in range(EVAL_BS)])).to(dev)
        counters = _counters('res50_custom')
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        _, cand, tail_ms, (dets, masks_proto, _) = _traditional_tail_numbers(det, x)
        call_ms = (time.perf_counter() - t0) * 1e3
        launches = {k: fn.launches for k, fn in counters.items()}
        _check(not any(launches.values()), f'the traditional eval path launched {launches}')
        _check(all(t.device.type == 'cpu' for t in (*dets, masks_proto)),
               'the traditional Detector returned device tensors')
        print(f'  one batch of {EVAL_BS} in this process: launches {launches} (kernel 1 bypassed); '
              f'(anchor, class) pairs reaching greedy NMS per image {cand} of '
              f'{det.anchors.shape[0]} x {cfg.num_classes - 1}; host tail (greedy NMS, numpy '
              f'masks, slate) {tail_ms:.3f} ms a batch, {tail_ms / EVAL_BS:.3f} ms an image; '
              f'forward, fetch and tail {call_ms:.3f} ms, {EVAL_BS / call_ms * 1e3:.2f} img/s '
              f'before the eval\'s upsample and metric (the CLI\'s own rate leaves out its '
              f'first batch, and of {FLAGS_EVAL_IMAGES // EVAL_BS} batches the last one queues '
              f'no tail behind it); valid slots {int(dets.valid.sum())}; on {smi}')
        del det
    torch.cuda.empty_cache()
    return launches


def phase_flags_detect(dev):
    """10b: the detect CLI with --traditional_nms --save_lincomb on two
    seeded PNGs with a seeded res50_coco .pth (class 1 raised by 6, so that
    slots are valid), from a temporary working directory: the drawn images at
    their input shapes, a lincomb_<name> grid for each, kernel 1 bypassed.
    Returns the launches."""
    import os
    import tempfile
    import torch
    from yolact_minimal_torch.config import get_config
    from yolact_minimal_torch.detect import main as detect_main
    from yolact_minimal_torch.pipeline import Detector
    from yolact_minimal_torch.utils import image_io

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        shapes = _seeded_pngs(os.path.join(tmp, 'images'), 10)
        det = Detector(get_config('res50_coco', img_size=IMG), device=dev, seed=0)
        sd = {k: v.cpu() for k, v in det.model.state_dict().items()}
        sd['prediction_layers.conf_layer.bias'][1::81] += 6.0
        weight = os.path.join(tmp, 'seeded_res50_coco.pth')
        torch.save(sd, weight)
        del det, sd
        counters = _counters('res50_coco')
        for fn in counters.values():
            fn.launches = 0
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            detect_main(['--weight', weight, '--image', os.path.join(tmp, 'images'),
                         '--img_size', str(IMG), '--traditional_nms', '--save_lincomb'])
            seconds = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        launches = {k: fn.launches for k, fn in counters.items()}
        grids = {}
        for name, shape in shapes.items():
            out = image_io.imread(os.path.join(tmp, 'results', 'images', name))
            _check(out.shape == shape + (3,), f'{name}: drawn image {out.shape}, input {shape}')
            path = os.path.join(tmp, 'results', 'images', f'lincomb_{name}')
            _check(os.path.exists(path), f'--save_lincomb wrote no lincomb_{name}')
            grids[name] = image_io.imread(path).shape
            # 4 x 8 prototypes of IMG / 4 a side
            _check(grids[name] == (IMG, 2 * IMG, 3), f'lincomb_{name}: grid {grids[name]}')
    _check(not any(launches.values()), f'the traditional detect CLI launched {launches}')
    print(f'10b. detect CLI --traditional_nms --save_lincomb on {len(shapes)} PNGs '
          f'{list(shapes.values())}: {seconds:.2f} s (model build and warm-up included); drawn '
          f'images at their input shapes; lincomb grids {grids}; launches {launches}')
    return launches


def phase_flags_swin(dev, smi):
    """10c: a swin_tiny_coco bf16 Detector with traditional_nms, its score
    threshold at the (1 - TRAD_PASS) quantile of the first image's
    foreground scores: with the counters at 0, one call must launch kernels
    3 and 4 once a block (12 each) and kernel 1 not at all, and its slate
    must equal the numpy tail on the card's raw outputs. Returns the
    launches."""
    import numpy as np
    import torch
    from yolact_minimal_torch.config import get_config
    from yolact_minimal_torch.pipeline import Detector

    cfg = get_config('swin_tiny_coco', img_size=IMG, compute_dtype='bfloat16',
                     traditional_nms=True)
    det = Detector(cfg, device=dev, seed=0)
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(TRAD_BATCH, IMG, IMG, 3, device=dev, generator=g)
    with torch.inference_mode():
        scores = det._infer_raw(x[:1])[0][0, :, 1:].float().cpu().numpy()
    det.cfg = cfg.replace(nms_score_thre=float(np.quantile(scores, 1 - TRAD_PASS)))
    counters = _counters('swin_tiny_coco')
    for fn in counters.values():
        fn.launches = 0
    recorded = []
    infer_raw = det._infer_raw
    det._infer_raw = lambda images: recorded.append(infer_raw(images)) or recorded[-1]
    t0 = time.perf_counter()
    dets, masks_proto, proto = det(x)
    call_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: fn.launches for k, fn in counters.items()}
    det._infer_raw = infer_raw
    expected = dict(_swin_launches('composed'), suppression_iou_max=0, mask_finalize=0)
    _check(launches == expected, f'swin traditional path: expected {expected}, got {launches}')
    from yolact_minimal_torch.pipeline import _to_host
    tail = det.traditional_tail(*_to_host(recorded[0]))
    for name, got, want in zip(('ids', 'scores', 'boxes', 'coefs', 'valid', 'masks_proto',
                                'proto'), (*dets, masks_proto, proto), (*tail[0], *tail[1:])):
        _check(torch.equal(got, want), f'swin traditional {name}: the slate differs from the '
                                       f'numpy tail on the card\'s raw outputs')
    _, cand, tail_ms, _ = _traditional_tail_numbers(det, x)
    _check(int(dets.valid.sum()) > 0, 'the swin traditional slate is empty')
    print(f'10c. swin_tiny_coco bf16 {IMG}, batch {TRAD_BATCH}, traditional_nms, nms_score_thre '
          f'{det.cfg.nms_score_thre:.6f}: launches {launches}; one call {call_ms:.3f} ms '
          f'(host clock, first call of the Detector); candidates per image {cand}; host tail '
          f'{tail_ms:.3f} ms; valid slots {int(dets.valid.sum())}; slate equals the numpy '
          f'tail on the card\'s raw outputs; on {smi}')
    del det
    torch.cuda.empty_cache()
    return launches


def phase_flags_remat(dev, smi, batches):
    """10d: one train_step with and without cfg.remat for res50_coco and
    swin_tiny_coco, bf16, IMG/b TRAIN_BS, from the seed-0 init on the same
    batch (the step generator is seeded from (seed, step), so the draws are
    the same): the remat step's four losses within REMAT_LOSS_RTOL of the
    plain step's; then REMAT_STEPS more steps each (2 warm-up), ms a step on
    the host clock to a synchronize, peak device memory, and the launches of
    kernels 3 and 4 a step. Returns {path: launches}."""
    import torch
    from yolact_minimal_torch.config import get_config
    from yolact_minimal_torch.train_state import create_train_state, train_step
    by_path, rows = {}, []
    for name in ('res50_coco', 'swin_tiny_coco'):
        first = {}
        for use_remat in (False, True):
            cfg = get_config(name, mode='train', img_size=IMG, train_bs=TRAIN_BS,
                             compute_dtype='bfloat16', remat=use_remat)
            state = create_train_state(cfg, dev, seed=0)
            counters = _counters(name)
            _zero_counters(counters)
            first[use_remat] = [float(t) for t in train_step(state, batches[0])]
            for batch in batches[1:3]:                          # warm-up
                train_step(state, batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            for i in range(REMAT_STEPS - 2):
                train_step(state, batches[3 + i % (len(batches) - 3)])
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) / (REMAT_STEPS - 2) * 1e3
            peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            launches = _read_counters(counters)
            steps = 1 + REMAT_STEPS
            path = f'{name}/train_{"remat" if use_remat else "plain"}_bfloat16'
            by_path[path] = launches
            # the remat step runs each forward twice and each backward once
            k = 2 if use_remat else 1
            want = {'window_attention': 12 * k * steps, 'swin_mlp': k * steps,
                    'window_attention_backward': 12 * steps} if name.startswith('swin') else \
                {'window_attention_backward': 0}
            _check(all(launches[n] == c for n, c in want.items()),
                   f'{path}: expected {want} launches over {steps} steps, got {launches}')
            rows.append((path, step_ms, peak, launches, steps))
            print(f'10d. {path} {IMG}/b{TRAIN_BS}: {step_ms:.3f} ms a step ({REMAT_STEPS - 2} '
                  f'steps after 3, host clock to a synchronize), {TRAIN_BS / step_ms * 1e3:.2f} '
                  f'img/s, peak device memory {peak:.2f} GiB; launches {launches} over {steps} '
                  f'steps; first step losses {first[use_remat]}; on {smi}')
            del state
            torch.cuda.empty_cache()
        for a, b in zip(first[True], first[False]):
            _check(math.isfinite(a) and abs(a - b) <= REMAT_LOSS_RTOL * abs(b),
                   f'{name}: remat losses {first[True]} against plain {first[False]}')
        print(f'  {name}: the remat step\'s four losses within {REMAT_LOSS_RTOL} relative of the '
              f'plain step\'s')
    return by_path


def phase_flags_train_cli(dev, smi):
    """10e: `python -m yolact_minimal_torch.train --backbone_weight
    seeded_backbone.pth --remat` on res50_custom at FLAGS_CLI_IMG for
    FLAGS_CLI_STEPS steps from a temporary directory: the 'Backbone is
    initiated' line and finite logged losses."""
    import os
    import tempfile
    import torch
    from yolact_minimal_torch.config import get_config
    from yolact_minimal_torch.pipeline import Detector
    root = os.path.dirname(os.path.abspath(__file__))
    data = [os.path.join(root, p) for p in ('custom_dataset/images',
                                            'custom_dataset/annotations.json')]
    with tempfile.TemporaryDirectory() as cwd:
        det = Detector(get_config('res50_custom', img_size=FLAGS_CLI_IMG), device='cpu', seed=7)
        backbone = {k[len('backbone.'):]: v for k, v in det.model.state_dict().items()
                    if k.startswith('backbone.')}
        weight = os.path.join(cwd, 'seeded_backbone.pth')
        torch.save(backbone, weight)
        del det
        out, seconds = _run_cli('train', [
            '--cfg', 'res50_custom', '--img_size', str(FLAGS_CLI_IMG), '--train_bs', '8',
            '--max_steps', str(FLAGS_CLI_STEPS), '--num_workers', str(TRAIN_WORKERS),
            '--backbone_weight', weight, '--remat', '--train_imgs', data[0],
            '--train_ann', data[1], '--val_imgs', data[0], '--val_ann', data[1]], cwd)
    _check(f'Backbone is initiated with {weight}.' in out,
           f'the train CLI did not read the backbone:\n{out[-2000:]}')
    _check('remat: True' in out, 'the train CLI did not take --remat')
    logged = [tuple(float(x) for x in m) for m in re.findall(
        r'l_class: (\S+) \| l_box: (\S+) \| l_mask: (\S+) \| l_semantic: (\S+) \|', out)]
    _check(logged and all(math.isfinite(v) for l in logged for v in l),
           f'the train CLI logged no finite losses:\n{out[-2000:]}')
    print(f'10e. train CLI res50_custom {FLAGS_CLI_IMG}/b8 --backbone_weight (seeded, '
          f'{len(backbone)} tensors) --remat, {FLAGS_CLI_STEPS} steps: {seconds:.2f} s; printed '
          f'"Backbone is initiated"; logged losses {logged}; on {smi}')


def phase_flags(dev, smi, batches):
    """Phase 10: the flags, the remat steps on phase 8's `batches`. Returns
    {path: launches}."""
    t_phase = time.perf_counter()
    by_path = {'res50_custom/eval_traditional': phase_flags_eval(dev, smi),
               'res50_coco/cli_traditional': phase_flags_detect(dev),
               'swin_tiny_coco/traditional': phase_flags_swin(dev, smi)}
    by_path.update(phase_flags_remat(dev, smi, batches[:1 + REMAT_STEPS]))
    phase_flags_train_cli(dev, smi)
    print(f'flags phase: {time.perf_counter() - t_phase:.2f} s')
    return by_path


# --- phase 11: data parallelism ---------------------------------------------------

# 11a: a world of DP_PROCESSES gloo processes, all on cuda:0 (NCCL refuses
# two ranks on one card; gloo all-reduces CUDA tensors through the host),
# each with TRAIN_BS / DP_PROCESSES rows of phase 8's batches, DP_STEPS
# steps of res50_coco (float32, TF32 off, base_lr DP_LR so that an update is
# visible beside float32 noise, as tests/test_torch_cuda.py's train steps)
# and of swin_tiny_coco (bf16, stochastic depth at its 0.2), and one res50
# step in float64; each process's timeout. Limits: res50 float32, the
# losses within DP_LOSS_RTOL and the running statistics within DP_BN_REL_TOL
# of their largest magnitude (tests/test_torch_cuda.py's card-vs-CPU
# float32 limits); res50 float64, each gradient and updated parameter within
# DP_F64_TOL of its norm (tests/test_torch_train_step.py's RES50_TOL with no
# noise floor: the CPU's two-process float64 gradients lie within 4e-13).
# float32 updates are only printed: at a random init BatchNorm amplifies
# float32 rounding until a world's step (other convolution batches, other
# sums) differs from one process's as much as either differs from float64
# (0.987 of test_torch_cuda.py's allowance, measured on an H100 80GB HBM3 at
# 700 W). swin's
# losses within one bf16 ulp (SWIN_BF16_REL_TOL, phase 8a's bf16 limit).
DP_WORKER_FLAG = '--dp-worker'
DP_PROCESSES, DP_STEPS, DP_LR, DP_TIMEOUT = 2, 2, 0.1, 300
DP_LOSS_RTOL = 1e-4
DP_BN_REL_TOL = 1e-3
DP_F64_TOL = 1e-5
# (config, dtype, steps) of the world
DP_RUNS = (('res50_coco', 'float32', DP_STEPS), ('res50_coco', 'float64', 1),
           ('swin_tiny_coco', 'bfloat16', DP_STEPS))


def _dp_state(name, dev, dtype):
    """The seed-0 train state of 11a's `name` in `dtype` (res50 at base_lr
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
    """One process of 11a's gloo world (run as `chip_smoke.py --dp-worker
    SPEC`, YOLACT_* set): joins through parallel/mesh.py, takes its rows of
    each batch in SPEC's npz, runs each of DP_RUNS from a fresh state with
    the launch counters at 0 before, and writes the first step's losses
    summed over the world, per-tensor checksums of the weights, the
    launches and the ms of the last step (a barrier before and after it)
    to out_{process}.npz; process 0 also res50's state_dict and gradients
    after its first step."""
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
            for batch in batches[1:steps - 1]:
                train_step(state, _dp_batch(batch, dtype))
            if steps > 1:
                mesh.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                train_step(state, _dp_batch(batches[steps - 1], dtype))
                torch.cuda.synchronize()
                mesh.barrier()
                out[f'{run}/ms'] = np.float64((time.perf_counter() - t0) * 1e3)
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
    DP_TIMEOUT (all are killed). Returns the seconds."""
    root = os.path.dirname(os.path.abspath(__file__))
    port = _free_port()
    procs = []
    t0 = time.perf_counter()
    for rank in range(n):
        env = dict(os.environ, YOLACT_COORDINATOR=f'127.0.0.1:{port}',
                   YOLACT_NUM_PROCESSES=str(n), YOLACT_PROCESS_ID=str(rank),
                   PYTHONPATH=os.pathsep.join(p for p in (root, os.environ.get('PYTHONPATH'))
                                              if p))
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                       DP_WORKER_FLAG, spec_path], cwd=root, env=env,
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
    return time.perf_counter() - t0


def _one_process_steps(dev, batch):
    """11a's references on the global batch, in this process: each of
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


def phase_dp_train(dev, smi, batches):
    """11a: the two-process gloo world against the one-process steps on the
    same global batch in this call (limits above DP_WORKER_FLAG). res50
    float32: the first step's four losses and the running statistics;
    res50 float64: every gradient and updated parameter; swin bf16, drop_path
    on: the losses, and kernels 3 and 4 and kernel 3's backward kernel
    launched 12, 1 and 12 times a step in each process. Every process ends with the same weights. Returns {path:
    launches}."""
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
        seconds = _spawn_world(spec, DP_PROCESSES)
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
    by_path = {}
    for rank, o in enumerate(outs):
        for name, dtype, steps in DP_RUNS:
            launches = dict(zip(o[f'{name}/{dtype}/kernels'].tolist(),
                                o[f'{name}/{dtype}/launches'].tolist()))
            by_path[f'{name}/dp_train_{dtype}_process{rank}'] = launches
            if name.startswith('swin'):
                want = {k: steps * c for k, c in TRAIN_LAUNCHES_PER_STEP.items()}
                _check(all(launches[k] == c for k, c in want.items())
                       and launches['attn_block'] == launches['swin_block'] == 0,
                       f'swin gloo process {rank}: expected {want} over {steps} steps, got '
                       f'{launches}')
    print(f'11a. gloo world of {DP_PROCESSES} processes on cuda:0, {TRAIN_BS // DP_PROCESSES} '
          f'rows each of phase 8\'s batches (global {TRAIN_BS}, {IMG}), {seconds:.2f} s with the '
          f'processes\' start-up; the same weights in every process; on {smi}')
    print(f'  res50_coco float32 (TF32 off, base_lr {DP_LR}): first step losses '
          f'{out["res50_coco/float32/losses"].tolist()} against one process {one}, largest '
          f'relative gap {max(rel):.3g} (<= {DP_LOSS_RTOL}); running statistics within '
          f'{worst_bn:.3g} of their largest magnitude (<= {DP_BN_REL_TOL}); updated parameters '
          f'(printed only) at most {update_ratio[0]:.3g} of twice the one-process float32 step\'s '
          f'distance from float64 plus 1e-5 of the norm ({update_ratio[1]}); a step '
          f'{out["res50_coco/float32/ms"]:.3f} ms in the world (gloo through the host)')
    print(f'  res50_coco float64: losses within {max(rel64):.3g}; gradients and updated '
          f'parameters within {worst64[0]:.3g} of their norm ({worst64[1]}; <= {DP_F64_TOL})')
    print(f'  swin_tiny_coco bf16, drop_path 0.2: first step losses '
          f'{out[f"{run}/losses"].tolist()} against one process {one_swin}, largest relative '
          f'gap {max(srel):.3g} (<= {SWIN_BF16_REL_TOL:.3g}); a step '
          f'{out[f"{run}/ms"]:.3f} ms in the world; launches per process ' + ', '.join(
              f'{p}: {c}' for p, c in by_path.items() if p.startswith('swin')))
    return by_path


def phase_dp_train_cli(smi, plain_t_step):
    """11b: `python -m yolact_minimal_torch.train` in a one-process nccl world
    (YOLACT_COORDINATOR set) on res50_custom at FLAGS_CLI_IMG for
    FLAGS_CLI_STEPS steps: the 'Joined distributed runtime' line and finite
    logged losses; its t_step beside the plain CLI's of phase 8d."""
    import tempfile
    root = os.path.dirname(os.path.abspath(__file__))
    data = [os.path.join(root, p) for p in ('custom_dataset/images',
                                            'custom_dataset/annotations.json')]
    env = dict(os.environ, YOLACT_COORDINATOR=f'127.0.0.1:{_free_port()}',
               PYTHONPATH=os.pathsep.join(p for p in (root, os.environ.get('PYTHONPATH')) if p))
    with tempfile.TemporaryDirectory() as cwd:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, '-m', 'yolact_minimal_torch.train', '--cfg',
                               'res50_custom', '--img_size', str(FLAGS_CLI_IMG), '--train_bs',
                               '8', '--max_steps', str(FLAGS_CLI_STEPS), '--num_workers',
                               str(TRAIN_WORKERS), '--train_imgs', data[0], '--train_ann',
                               data[1], '--val_imgs', data[0], '--val_ann', data[1]],
                              cwd=cwd, env=env, capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
    out = proc.stdout
    _check(proc.returncode == 0, f'the nccl train CLI exited {proc.returncode}:\n{out[-3000:]}\n'
                                 f'{proc.stderr[-3000:]}')
    joined = re.findall(r'Joined distributed runtime: .*', out)
    _check(joined and 'backend nccl' in joined[0], f'no nccl join line:\n{out[-2000:]}')
    logged = [tuple(float(x) for x in m) for m in re.findall(
        r'l_class: (\S+) \| l_box: (\S+) \| l_mask: (\S+) \| l_semantic: (\S+) \| t_t: \S+ \| '
        r't_d: \S+ \| t_step: (\S+)', out)]
    _check(logged and all(math.isfinite(v) for l in logged for v in l[:4]),
           f'the nccl train CLI logged no finite losses:\n{out[-2000:]}')
    print(f'11b. train CLI in a one-process nccl world, res50_custom {FLAGS_CLI_IMG}/b8, '
          f'{FLAGS_CLI_STEPS} steps: {seconds:.2f} s; "{joined[0]}"; logged losses '
          f'{[l[:4] for l in logged]}; t_step {logged[-1][4]:.3f} s (steps 1-9) against the '
          f'plain CLI\'s {plain_t_step:.3f} s (phase 8d at {TRAIN_CLI_IMG}, its last log '
          f'line); on {smi}')


def phase_dp_eval(dev, smi, plain_rows):
    """11c: `eval.main([... '--data_parallel', '1'])` in this process on a
    seeded res50_custom .ckpt at IMG over custom_dataset/ (phase 3c's
    weights and images), the counters at 0 before: its table equals phase
    3c's plain CLI table row for row, kernel 1 launched once a batch; then
    `python -m yolact_minimal_torch.eval --data_parallel 2` must exit
    nonzero saying that there is one CUDA device. Returns the launches."""
    import contextlib
    import io
    import tempfile
    import torch
    from yolact_minimal_torch import eval as port_eval
    from yolact_minimal_torch.config import get_config
    from yolact_minimal_torch.pipeline import Detector
    from yolact_minimal_torch.utils.checkpoint import save_checkpoint
    from yolact_minimal_torch.utils.weights import to_jax_variables
    root = os.path.dirname(os.path.abspath(__file__))
    data = ['--val_imgs', os.path.join(root, 'custom_dataset', 'images'),
            '--val_ann', os.path.join(root, 'custom_dataset', 'annotations.json')]
    with tempfile.TemporaryDirectory() as tmp:
        det = Detector(get_config('res50_custom', img_size=IMG), device=dev, seed=0)
        ckpt = os.path.join(tmp, 'seeded_res50_custom_0.ckpt')
        save_checkpoint(ckpt, to_jax_variables(det.model.state_dict()))
        del det
        counters = _counters('res50_custom')
        for fn in counters.values():
            fn.launches = 0
        tf32 = torch.backends.cudnn.allow_tf32
        buf = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                port_eval.main(['--weight', ckpt, '--img_size', str(IMG), '--data_parallel',
                                '1', *data])
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        seconds = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        rows = _table_rows(buf.getvalue())
        _check(rows == plain_rows, f'--data_parallel 1 table {rows} differs from the plain '
                                   f'eval CLI\'s {plain_rows}')
        batches = -(-48 // EVAL_BS)
        _check(launches['suppression_iou_max'] == batches and launches['mask_finalize'] == 0,
               f'--data_parallel 1 launched {launches}, expected kernel 1 once a batch')
        proc = subprocess.run([sys.executable, '-m', 'yolact_minimal_torch.eval', '--weight',
                               ckpt, '--img_size', str(IMG), '--data_parallel', '2', *data],
                              cwd=root, capture_output=True, text=True, timeout=300,
                              env=dict(os.environ, PYTHONPATH=root))
    said = (proc.stdout + proc.stderr).strip().splitlines()[-1:]
    _check(proc.returncode != 0 and said and 'this machine has 1 CUDA device' in said[0],
           f'--data_parallel 2 exited {proc.returncode}: {proc.stderr[-2000:]}')
    print(f'11c. eval CLI --data_parallel 1 (in this process), res50_custom {IMG}, 48 images: '
          f'{seconds:.2f} s, table equal to phase 3c\'s plain CLI row for row (box '
          f'{rows["box"]}, mask {rows["mask"]}); launches {launches}; --data_parallel 2 '
          f'exited {proc.returncode}: "{said[0]}"; on {smi}')
    return launches


def phase_parallel(dev, smi, batches, plain_t_step, plain_rows):
    """Phase 11: data parallelism (11a-c); 11d its seconds. Returns {path:
    launches}."""
    t_phase = time.perf_counter()
    by_path = phase_dp_train(dev, smi, batches)
    phase_dp_train_cli(smi, plain_t_step)
    by_path['res50_custom/eval_dp1'] = phase_dp_eval(dev, smi, plain_rows)
    print(f'11d. parallel phase: {time.perf_counter() - t_phase:.2f} s')
    return by_path


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
    smi = phase_env()
    phase_build()
    kernels = [check_suppression(dev), check_mask_finalize(dev),
               check_window_attention(dev), check_swin_mlp(dev)]
    kernels += [check_attn_block(dev, kernels[2]), check_swin_block(dev, *kernels[2:])]
    torch.cuda.empty_cache()
    by_path = {'res50_coco/cli': phase_cli(dev)}
    by_path['res50_custom/eval'], eval_rows = phase_eval(dev, smi, kernels[0])
    for name, forms in (('res50_coco', ('composed',)), ('swin_tiny_coco', tuple(SWIN_PATHS))):
        det = images = composed_out = None
        for form in forms:
            path = name if len(forms) == 1 else f'{name}/{form}'
            by_path[path], det, images, host_ms = phase_main_path(dev, name, form, det, images)
            if name == 'res50_coco':
                check_mask_finalize_path(det, images, kernels[1])
            phase_profile(det, images, host_ms)
            out = phase_numerics(dev, name, det, images[:1].clone(), form, composed_out)
            composed_out = out if form == 'composed' else composed_out
            torch.cuda.empty_cache()
        if name.startswith('swin'):
            phase_stage_forms(det, dev)
        del det, images, composed_out
        torch.cuda.empty_cache()
    large, by_path['swin_large_coco'] = phase_swin_large(dev)
    kernels += large
    batches = _train_batches(max(TRAIN_STEPS + 2, 1 + REMAT_STEPS))
    train_paths, train_numbers = phase_train(dev, smi, kernels, batches)
    by_path.update(train_paths)
    by_path[EXPORT_PATH], _ = phase_export(dev, smi)
    by_path.update(phase_flags(dev, smi, batches))
    by_path.update(phase_parallel(dev, smi, batches[:DP_STEPS], train_numbers['cli']['t_step'],
                                  eval_rows['res50_custom']))
    del batches
    # `launches` is the count on the path that runs the kernel
    own_path = {'suppression_iou_max': 'res50_coco', 'mask_finalize': 'res50_coco',
                'window_attention': 'swin_tiny_coco/composed', 'swin_mlp': 'swin_tiny_coco/composed',
                'attn_block': 'swin_tiny_coco/attn_block', 'swin_block': 'swin_tiny_coco/whole'}
    for k in kernels:
        if k['name'] in own_path:        # the swin_large rows count their own (phase 7b)
            k['launches'] = by_path[own_path[k['name']]][k['name']]
        _check(k['launches'] > 0, f'kernel {k["name"]} was not launched on its path')
        k['launches_by_path'] = {p: c[k['name']] for p, c in by_path.items() if k['name'] in c}
        if k['name'] == 'window_attention':
            k['backward_launches_by_path'] = {p: c['window_attention_backward']
                                              for p, c in by_path.items()
                                              if 'window_attention_backward' in c}
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
