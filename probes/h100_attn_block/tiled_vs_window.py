"""The tiled bf16 attn_block body (one window a warpgroup at every width, a TMA
weight ring at C = 192 and 384) against the plain version and the
one-block-a-window body: ptxas registers and spills, errors at the four
swin_tiny 544/b16 stage shapes and on partial tiles, two-launch bit
equality, and the two bodies' CUDA-event and device times in turns; also
swin_block against its plain version after the shared-header move.

Written for csrc/attn_block.cu while it exported attn_block_window_bf16 (the
one-block-a-window body); run from the repository root on an H100:
python3 probes/h100_attn_block/tiled_vs_window.py"""
import ctypes, tempfile, subprocess, sys, time, statistics
import torch
sys.path.insert(0, '.')             # the repository root
from yolact_minimal_torch.ops import _build
from yolact_minimal_torch.ops.attn_block import (attn_block, attn_block_plain, kernel_attributes,
                                                 kernel_geometry, shared_bytes, KERNEL_SHAPES)
from yolact_minimal_torch.models.swin import shifted_window_regions
print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                     capture_output=True, text=True).stdout.strip())
# ptxas report
for src in ('attn_block', 'swin_block'):
    r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, '-Xptxas', '-v', '-o', f'{tempfile.mkdtemp()}/{src}.so',
                        str(_build.CSRC / f'{src}.cu')], capture_output=True, text=True)
    print(src, 'rc', r.returncode)
    for line in (r.stdout + r.stderr).splitlines():
        if 'error' in line.lower() or 'Used' in line or 'spill' in line or 'wgmma' in line.lower() or 'arning' in line:
            print('  ', line[:200])
    if r.returncode:
        print(r.stdout[-3000:], r.stderr[-3000:]); sys.exit(1)
t0 = time.time(); _build.build(['attn_block', 'swin_block']); print('built', time.time() - t0)
for c in KERNEL_SHAPES:
    a = kernel_attributes(c); print(c, a, 'plan', shared_bytes(c))
dev = torch.device('cuda')
g = torch.Generator(device=dev).manual_seed(0)
rand = lambda *s: torch.randn(*s, device=dev, generator=g)
lib = _build.load('attn_block')
old = lib.attn_block_window_bf16
old.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
old.restype = ctypes.c_int

def run_old(x, wqkv, bqkv, bias, region, wproj, bproj, heads):
    out = torch.empty_like(x)
    _build.launch(old, x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), bias.data_ptr(),
                  None if region is None else region.data_ptr(), wproj.data_ptr(), bproj.data_ptr(),
                  out.data_ptr(), x.shape[0], x.shape[2], 0 if region is None else region.shape[0],
                  torch.cuda.current_stream().cuda_stream)
    return out

def device_ms(f, iters=20):
    f(); torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters): f()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / iters / 1e3

def tm(fn, iters=20):
    for _ in range(3): fn()
    torch.cuda.synchronize(); ts = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True); e = torch.cuda.Event(enable_timing=True)
        s.record(); fn(); e.record(); e.synchronize(); ts.append(s.elapsed_time(e))
    return statistics.median(ts)

bad = 0
for bnw, nw, c in ((6400, 400, 96), (1600, 100, 192), (400, 25, 384), (144, 9, 768),
                   (1, 1, 96), (4, 1, 96), (401, 1, 96), (3, 1, 192), (265, 1, 192), (133, 1, 384), (7, 1, 384)):
    heads = c // 32
    side = int(round(nw ** 0.5)) * 7
    region = torch.from_numpy(shifted_window_regions(side, side)).to(dev)
    bf = torch.bfloat16
    x = rand(bnw, 49, c).to(bf)
    wqkv = (rand(3 * c, c) * c ** -0.5).to(bf); bqkv = 0.05 * rand(3 * c)
    wproj = (rand(c, c) * c ** -0.5).to(bf); bproj = 0.05 * rand(c)
    bias = (0.1 * rand(heads, 49, 49)).to(bf)
    for reg in (None, region):
        args = (x, wqkv, bqkv, bias, reg, wproj, bproj, heads)
        try:
            got = attn_block(*args); torch.cuda.synchronize()
        except Exception as e:
            print('FAIL launch', bnw, c, e); bad += 1; continue
        ref = attn_block_plain(*args)
        err = (got.float() - ref.float()).abs().max().item() / ref.float().abs().max().item()
        again = attn_block(*args)
        o = run_old(*args)
        eo = (o.float() - ref.float()).abs().max().item() / ref.float().abs().max().item()
        ok = err <= 2 ** -7 and torch.isfinite(got.float()).all().item()
        bad += not ok
        print(f'bnw {bnw} c {c} {"shifted" if reg is not None else "unshifted"}: new rel {err:.3g} '
              f'old rel {eo:.3g} bit-equal {torch.equal(got, again)} {"OK" if ok else "BAD"}')
    if bnw >= 144:
        args = (x, wqkv, bqkv, bias, region, wproj, bproj, heads)
        tn1 = tm(lambda: attn_block(*args)); to1 = tm(lambda: run_old(*args))
        to2 = tm(lambda: run_old(*args)); tn2 = tm(lambda: attn_block(*args))
        print(f'  times c {c}: new {tn1:.4f} old {to1:.4f} old {to2:.4f} new {tn2:.4f}; device new '
              f'{device_ms(lambda: attn_block(*args)):.4f} old {device_ms(lambda: run_old(*args)):.4f}')
from yolact_minimal_torch.ops.swin_block import swin_block, swin_block_plain
from yolact_minimal_torch.models.swin import pad_rowmask
for bnw, nw, c, side, padded in ((6400, 400, 96, 136, 140), (1600, 100, 192, 68, 70), (400, 25, 384, 34, 35), (7, 1, 96, 5, 7)):
    heads = c // 32; bf = torch.bfloat16
    region = torch.from_numpy(shifted_window_regions(padded, padded)).to(dev)
    rowmask = torch.from_numpy(pad_rowmask(side, side, padded, padded, 3)).to(dev)
    p = (rand(bnw, 49, c).to(bf), rowmask, 1 + 0.1 * rand(c), 0.1 * rand(c), (rand(3 * c, c) * c ** -0.5).to(bf),
         0.05 * rand(3 * c), (0.1 * rand(heads, 49, 49)).to(bf), region, (rand(c, c) * c ** -0.5).to(bf),
         0.05 * rand(c), 1 + 0.1 * rand(c), 0.1 * rand(c), (rand(4 * c, c) * c ** -0.5).to(bf), 0.05 * rand(4 * c),
         (rand(c, 4 * c) * (4 * c) ** -0.5).to(bf), 0.05 * rand(c), heads)
    got = swin_block(*p); ref = swin_block_plain(*p)
    err = (got.float() - ref.float()).abs().max().item() / ref.float().abs().max().item()
    ok = err <= 2 ** -7 and torch.equal(got, swin_block(*p)); bad += not ok
    print(f'swin_block bnw {bnw} c {c}: rel {err:.3g} {"OK" if ok else "BAD"}; device ms {device_ms(lambda: swin_block(*p)):.4f}')
print('BAD', bad)
sys.exit(1 if bad else 0)
