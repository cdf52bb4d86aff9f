#!/usr/bin/env python
"""Drive the PyTorch/CUDA port (yolact_minimal_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero:
  1. the card's name and power limit, torch's CUDA version, nvcc's version,
     whether triton imports;
  2. build the CUDA kernels from yolact_minimal_torch/csrc/ (nvcc, sm_90a,
     one process per source, started together);
  3. each kernel against its plain PyTorch version on the card, at the main
     paths' shapes, timed with CUDA events (median of 20 after warm-up); the
     two swin kernels at each of the four stage shapes, in bf16 and float32,
     shifted and unshifted;
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
  7. phases 4-6 again for swin_tiny_coco (544, batch 16, bf16), whose path
     launches all four kernels: window attention and the MLP half-block 12
     times each per forward.
The line before the last is a JSON object {"kernels": [...]}; the last is
{"ok": true, "device": {...}}. Needs no JAX, flax or cv2.

In the kernels line `max_abs_err` is the largest |kernel - plain| over the
output; for the bool masks of mask_finalize that is 0 or 1, and the stated
tolerance holds `mismatch_frac`, the share of mask pixels that differ.
`launches` counts the res50_coco path for kernels 1-2 and the swin_tiny_coco
path for kernels 3-4; `launches_by_path` has both. `bound_ms` is held to the
peak named in `peak`. The swin kernels' top-level numbers are those of the
stage-0 shape in bf16; `per_stage` lists all four.
"""
import json
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
# Kernel groups of the profile; first match wins, on the CUDA kernel names
# that torch.profiler reports.
GROUPS = (
    ('suppression kernel', r'suppression_kernel'),
    ('mask_finalize kernel', r'mask_finalize_kernel'),
    ('window_attention kernel', r'window_attention_kernel'),
    ('swin_mlp kernel', r'mlp_bf16_kernel|mlp_f32_kernel'),
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


def phase_build():
    from yolact_minimal_torch.ops import _build
    t0 = time.perf_counter()
    libs = _build.build(['suppression', 'mask_finalize', 'window_attention', 'swin_mlp'])
    print(f'built {sorted(libs)} in {time.perf_counter() - t0:.2f} s')


def check_suppression(dev):
    """Kernel 1 at [B*C, K] = [1280, 200] with zero-area and invalid
    candidates; must equal the plain version exactly, NaN positions too."""
    import torch
    from yolact_minimal_torch.ops.suppression import (suppression_iou_max,
                                                      suppression_iou_max_plain)
    g = torch.Generator(device=dev).manual_seed(0)
    rows, k = BATCH * 80, 200
    xy = torch.rand(2, rows, k, device=dev, generator=g) * 0.8
    wh = torch.rand(2, rows, k, device=dev, generator=g) * 0.4
    x1, y1 = xy[0].contiguous(), xy[1].contiguous()
    x2, y2 = (x1 + wh[0]).clamp(max=1.0), (y1 + wh[1]).clamp(max=1.0)
    flat = torch.rand(rows, k, device=dev, generator=g) < 0.05
    for t in (x1, y1, x2, y2):
        t[flat] = 1.0                    # clipped fully off-image: 0/0 pairs
    valid = torch.rand(rows, k, device=dev, generator=g) > 0.2
    valid[::7] = False                   # whole rows without candidates
    args = (x1, y1, x2, y2, valid)

    got = suppression_iou_max(*args)
    torch.cuda.synchronize()
    ref = suppression_iou_max_plain(*args)
    nan_equal = torch.equal(torch.isnan(got), torch.isnan(ref))
    finite = ~torch.isnan(ref)
    err = (got[finite] - ref[finite]).abs().max().item()
    _check(torch.isnan(ref).any().item(), 'kernel 1 fixture has no NaN pair')
    _check(nan_equal and err == 0.0,
           f'suppression kernel disagrees: nan_equal={nan_equal} max_abs_err={err}')

    ms = _time_ms(lambda: suppression_iou_max(*args))
    plain_ms = _time_ms(lambda: suppression_iou_max_plain(*args))
    vi = valid.to(torch.int64)
    # valid pairs j < i per row: C(n_valid, 2); ~12 fp32 ops per pair IoU
    pairs = (vi.sum(1) * (vi.sum(1) - 1) // 2).sum().item()
    bound, by = _bound_ms(rows * k * (4 * 4 + 1 + 4), pairs * 12, FP32_PEAK)
    print(f'kernel suppression_iou_max [{rows}, {k}]: exact (NaN positions '
          f'equal), {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.5f} ms ({by})')
    return dict(name='suppression_iou_max', route='cuda',
                source='yolact_minimal_torch/csrc/suppression.cu',
                replaces='yolact_minimal_tpu/ops/pallas_nms.py:67',
                max_abs_err=err, agreement='exact, NaN positions equal',
                ms=ms, kernel_ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                peak=FP32_PEAK, library_ms=None)


def check_mask_finalize(dev):
    """Kernel 2 at B=16, D=100, proto 136x136x32 -> 544x544, crop on and
    off, some invalid slots; mismatch fraction vs the plain version < 1e-4."""
    import torch
    from yolact_minimal_torch.ops.boxes import sanitize_coordinates
    from yolact_minimal_torch.ops.mask_finalize import mask_finalize, mask_finalize_plain
    g = torch.Generator(device=dev).manual_seed(1)
    ph = IMG // 4
    proto = torch.randn(BATCH, ph, ph, 32, device=dev, generator=g)
    coefs = torch.tanh(torch.randn(BATCH, SLOTS, 32, device=dev, generator=g))
    xy = torch.rand(BATCH, SLOTS, 2, device=dev, generator=g) * 0.6
    wh = 0.1 + torch.rand(BATCH, SLOTS, 2, device=dev, generator=g) * 0.3
    boxes = torch.cat([xy, (xy + wh).clamp(max=1.0)], dim=-1).contiguous()
    valid = torch.rand(BATCH, SLOTS, device=dev, generator=g) > 0.3

    worst, err = 0.0, 0.0
    for do_crop in (True, False):
        got = mask_finalize(proto, coefs, boxes, valid, IMG, do_crop)
        torch.cuda.synchronize()
        ref = mask_finalize_plain(proto, coefs, boxes, valid, IMG, do_crop)
        _check(ref.any().item(), 'kernel 2 fixture is empty')
        diff = got != ref
        mismatch = diff.float().mean().item()
        # |kernel - plain| of 0/1 outputs: 1 as soon as one pixel flips
        worst, err = max(worst, mismatch), max(err, float(diff.any().item()))
        _check(mismatch < MASK_MISMATCH,
               f'mask kernel mismatch {mismatch} (do_crop={do_crop})')
        _check(not got[~valid].any().item(), 'mask kernel wrote an invalid slot')
        del got, ref, diff
        torch.cuda.empty_cache()

    args = (proto, coefs, boxes, valid, IMG, True)
    ms = _time_ms(lambda: mask_finalize(*args))
    plain_ms = _time_ms(lambda: mask_finalize_plain(*args), warmup=1)
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
          f'{worst:.3g}, {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.5f} ms ({by})')
    return dict(name='mask_finalize', route='cuda',
                source='yolact_minimal_torch/csrc/mask_finalize.cu',
                replaces='yolact_minimal_tpu/ops/pallas_masks.py:160',
                max_abs_err=err, mismatch_frac=worst,
                agreement=f'mismatch fraction {worst:.3g} < {MASK_MISMATCH}',
                ms=ms, kernel_ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                peak=FP32_PEAK, library_ms=None)


def _rel_err(got, ref):
    """max |got - ref| and the same as a share of max |ref|, in float32."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs().max().item()
    return err, err / ref.abs().max().item()


def check_window_attention(dev):
    """Kernel 3 at the four stage shapes of swin_tiny 544/b16: bf16 and
    float32, shifted (region ids) and unshifted, against the plain version;
    timed in bf16 on the shifted form, beside one
    F.scaled_dot_product_attention call on the same q, k, v with the bias and
    mask folded into attn_mask."""
    import torch
    import torch.nn.functional as F
    from yolact_minimal_torch.models.swin import shifted_window_regions
    from yolact_minimal_torch.ops.window_attention import (NEG, window_attention,
                                                           window_attention_plain)
    g = torch.Generator(device=dev).manual_seed(3)
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
        # bytes: qkv, bias and region read once, out written once; operations:
        # the two products of every window and head
        n_bytes = (qkv.numel() + bias.numel() + bnw * n * c) * 2 + region.numel() * 4
        bound, by = _bound_ms(n_bytes, bnw * heads * 4 * n * n * hd, BF16_PEAK)
        print(f'kernel window_attention stage {stage} qkv [{bnw}, {n}, {3 * c}] heads {heads} '
              f'bf16: {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound '
              f'{bound:.5f} ms ({by}); |kernel - plain| / max |plain|: bf16 '
              f'{worst[torch.bfloat16][1]:.3g} (<= {SWIN_BF16_REL_TOL:.3g}), float32 '
              f'{worst[torch.float32][1]:.3g} (<= {SWIN_F32_REL_TOL:.3g})')
        per_stage.append(dict(shape=[bnw, n, 3 * c], heads=heads, ms=ms, plain_ms=plain_ms,
                              bound_ms=bound, bound_by=by, library_ms=library_ms,
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
                          f'and unshifted',
                ms=top['ms'], kernel_ms=top['ms'], plain_ms=top['plain_ms'],
                bound_ms=top['bound_ms'], bound_by=top['bound_by'], peak=BF16_PEAK,
                library_ms=top['library_ms'],
                library='F.scaled_dot_product_attention, attn_mask = bias + mask',
                per_stage=per_stage)


def check_swin_mlp(dev):
    """Kernel 4 at the four stage shapes of swin_tiny 544/b16 (row counts that
    no tile divides), bf16 and float32, against the plain version; timed in
    bf16, and once in float32 for the record."""
    import torch
    from yolact_minimal_torch.ops.swin_mlp import mlp_block, mlp_block_plain
    g = torch.Generator(device=dev).manual_seed(4)
    rand = lambda *shape: torch.randn(*shape, device=dev, generator=g)
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
            del got, ref
        f32_ms = _time_ms(lambda: mlp_block(x32, *params), warmup=1, iters=3)
        x = x32.to(torch.bfloat16)
        del x32
        # the weights in bf16 once, as models/swin.py hands them over
        args = (x, params[0], params[1], params[2].bfloat16(), params[3],
                params[4].bfloat16(), params[5])
        ms = _time_ms(lambda: mlp_block(*args))
        plain_ms = _time_ms(lambda: mlp_block_plain(*args), warmup=1, iters=5)
        # bytes: x and all parameters read once, y written once; operations:
        # the two products (LayerNorm, gelu and the adds are a few per element)
        n_bytes = 2 * x.numel() * 2 + 2 * 4 * c * c * 2 + (2 * c + 4 * c + c) * 4
        bound, by = _bound_ms(n_bytes, 2 * rows * c * 4 * c * 2, BF16_PEAK)
        print(f'kernel swin_mlp stage {stage} x [{rows}, {c}] bf16: {ms:.4f} ms '
              f'({2 * rows * c * 4 * c * 2 / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, '
              f'float32 kernel {f32_ms:.4f} ms, bound {bound:.5f} ms ({by}); |kernel - plain| '
              f'/ max |plain|: bf16 {worst[torch.bfloat16][1]:.3g} (<= '
              f'{SWIN_BF16_REL_TOL:.3g}), float32 {worst[torch.float32][1]:.3g} (<= '
              f'{SWIN_F32_REL_TOL:.3g})')
        per_stage.append(dict(shape=[rows, c], ms=ms, plain_ms=plain_ms, f32_ms=f32_ms,
                              bound_ms=bound, bound_by=by, library_ms=None,
                              max_abs_err=worst[torch.bfloat16][0],
                              max_abs_err_f32=worst[torch.float32][0]))
        del x, args, params
        torch.cuda.empty_cache()
    top = per_stage[0]
    return dict(name='swin_mlp', route='cuda', source='yolact_minimal_torch/csrc/swin_mlp.cu',
                replaces='yolact_minimal_tpu/ops/swin_mlp.py:128',
                max_abs_err=top['max_abs_err'],
                agreement=f'bf16 within {SWIN_BF16_REL_TOL:.3g} and float32 within '
                          f'{SWIN_F32_REL_TOL:.3g} of max |plain|, 4 stage shapes',
                ms=top['ms'], kernel_ms=top['ms'], plain_ms=top['plain_ms'],
                bound_ms=top['bound_ms'], bound_by=top['bound_by'], peak=BF16_PEAK,
                library_ms=None, per_stage=per_stage)


def _counters(name):
    """The launch-counting wrappers of the kernels on a config's path."""
    from yolact_minimal_torch.ops.mask_finalize import mask_finalize
    from yolact_minimal_torch.ops.suppression import suppression_iou_max
    from yolact_minimal_torch.ops.swin_mlp import mlp_block
    from yolact_minimal_torch.ops.window_attention import window_attention
    counters = {'suppression_iou_max': suppression_iou_max, 'mask_finalize': mask_finalize}
    if name.startswith('swin'):
        counters.update(window_attention=window_attention, swin_mlp=mlp_block)
    return counters


def phase_main_path(dev, name, n_iters=10):
    """`name` (res50_coco or swin_tiny_coco) at 544, batch 16, bf16, seeded
    random init. Returns the launch counts, the Detector, its images and the
    untraced host ms per detect_fixed call."""
    import torch
    from yolact_minimal_torch.config import get_config
    from yolact_minimal_torch.pipeline import Detector

    cfg = get_config(name, img_size=IMG, nms_score_thre=SCORE_THRE,
                     compute_dtype='bfloat16')
    det = Detector(cfg, device=dev, seed=0)
    state = list(det.model.parameters()) + list(det.model.buffers())
    _check(all(t.dtype in (torch.float32, torch.int64) for t in state),
           'a parameter or buffer is not float32 under bf16')
    g = torch.Generator(device=dev).manual_seed(2)
    images = torch.randn(BATCH, IMG, IMG, 3, device=dev, generator=g)
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
    _check(all(n > 0 for n in launches.values()), f'a kernel was not launched: {launches}')
    if 'swin_mlp' in launches:
        forwards = launches['suppression_iou_max']      # one per forward pass
        per_forward = sum(SWIN_DEPTHS)
        _check(launches['window_attention'] == launches['swin_mlp'] == per_forward * forwards,
               f'expected {per_forward} launches of each swin kernel per forward: {launches}')
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
        print(f'  {name:24s} {ms:9.3f} ms  {ms / device_ms:6.1%}')
    print('  top kernels (ms per call, launches per call):')
    for e in sorted(kernels, key=per_call, reverse=True)[:16]:
        print(f'    {per_call(e):9.3f}  {e.count / PROFILE_ITERS:6.1f}  {e.key[:100]}')


def phase_numerics(dev, name, det_bf16, image):
    """One image through config `name`. Float32 with TF32 off: network
    outputs card vs CPU (on the CPU the swin kernels' plain versions run),
    then the card's postprocess + mask kernel vs the CPU's plain versions on
    the same head outputs (random-init scores sit near 1/81, so two slates from
    two forward passes may reorder under float noise). Then the bf16
    Detector of phase 4 against the card's float32 run."""
    import torch
    from yolact_minimal_torch.config import get_config
    from yolact_minimal_torch.ops.mask_finalize import mask_finalize
    from yolact_minimal_torch.ops.nms import detect_postprocess_batch
    from yolact_minimal_torch.pipeline import Detector

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f'{name} f32 parity: torch.backends.cudnn.allow_tf32=False, '
          'torch.backends.cuda.matmul.allow_tf32=False')
    cfg = get_config(name, img_size=IMG, nms_score_thre=SCORE_THRE)
    gpu = Detector(cfg, device=dev, seed=0)
    cpu = Detector(cfg, device='cpu', seed=0)
    with torch.inference_mode():
        out_gpu = gpu.model(image)
        out_cpu = cpu.model(image.cpu())
        out_bf16 = det_bf16.model(image)
    names = ('class', 'box', 'coef', 'proto')
    for out, a, b in zip(names, out_gpu, out_cpu):
        rel = ((a.cpu() - b).abs().max() / b.abs().max()).item()
        print(f'  network {out}: max |card - cpu| / max |cpu| = {rel:.3g}')
        _check(rel < NET_REL_TOL, f'network output {out} off by {rel}')

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


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is false; this script '
              'needs an NVIDIA card', file=sys.stderr)
        return 2
    import yolact_minimal_torch  # noqa: F401  (fails outside a checkout)
    dev = torch.device('cuda', 0)
    phase_env()
    phase_build()
    kernels = [check_suppression(dev), check_mask_finalize(dev),
               check_window_attention(dev), check_swin_mlp(dev)]
    torch.cuda.empty_cache()
    by_path = {}
    for name in ('res50_coco', 'swin_tiny_coco'):
        by_path[name], det, images, host_ms = phase_main_path(dev, name)
        phase_profile(det, images, host_ms)
        image = images[:1].clone()
        del images
        torch.cuda.empty_cache()
        phase_numerics(dev, name, det, image)
        del det
        torch.cuda.empty_cache()
    for k in kernels:
        path = 'res50_coco' if k['name'] in by_path['res50_coco'] else 'swin_tiny_coco'
        k['launches'] = by_path[path][k['name']]
        k['launches_by_path'] = {p: c[k['name']] for p, c in by_path.items() if k['name'] in c}
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
