"""The tiled bf16 attn_block body with whole heads a warpgroup, against the
plain version and the one-block-a-window body (events and device time in
turns), and a copy that loads the next head's bias before the attention
(device time in the same call).

Written for csrc/attn_block.cu while it exported attn_block_window_bf16;
run from the repository root on an H100:
python3 probes/h100_attn_block/head_split_and_bias_prefetch.py"""
import ctypes, tempfile, subprocess, sys, statistics, os
import torch
sys.path.insert(0, '.')             # the repository root
from yolact_minimal_torch.ops import _build
from yolact_minimal_torch.ops.attn_block import (attn_block, attn_block_plain, kernel_attributes,
                                                 shared_bytes, KERNEL_SHAPES)
from yolact_minimal_torch.models.swin import shifted_window_regions
print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                     capture_output=True, text=True).stdout.strip())
src = open('yolact_minimal_torch/csrc/attn_block.cu').read()
old_s = '''      qkv_issue(h + P::CS, acc);
      attend_rows(qkv, P::QT, 0, wq, bz, differ, ao, P::TB, h * HD);
      head_bias(bias + static_cast<size_t>(h + P::CS) * N * N, wq, bz);
'''
new_s = '''      qkv_issue(h + P::CS, acc);
      uint32_t bz2[7][2];
      head_bias(bias + static_cast<size_t>(h + P::CS) * N * N, wq, bz2);
      attend_rows(qkv, P::QT, 0, wq, bz, differ, ao, P::TB, h * HD);
#pragma unroll
      for (int i = 0; i < 14; ++i) (&bz[0][0])[i] = (&bz2[0][0])[i];
'''
assert src.count(old_s) == 1
TMP = tempfile.mkdtemp()
open(TMP + '/pre.cu', 'w').write(src.replace(old_s, new_s))
procs = {}
for name, path in (('repo', str(_build.CSRC / 'attn_block.cu')), ('pre', TMP + '/pre.cu')):
    procs[name] = subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS, '-Xptxas', '-v', '-I', str(_build.CSRC),
                                    '-o', f'{TMP}/{name}.so', path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
for name, pr in procs.items():
    out, _ = pr.communicate()
    print(name, 'rc', pr.returncode)
    lines = out.splitlines()
    for i, line in enumerate(lines):
        if 'wgmma' in line.lower() or 'arning' in line or 'error' in line:
            print('  ', line[:240])
        if 'sm90_kernel' in line and 'Compiling' in line:
            print('  ', line.split("'")[1][-60:], '|', lines[i + 2].strip()[:90], '|', lines[i + 3].strip()[:60])
    if pr.returncode:
        sys.exit(1)
_build.build(['attn_block'])
for c in KERNEL_SHAPES:
    a = kernel_attributes(c); print(c, a, 'plan', shared_bytes(c))
dev = torch.device('cuda')
g = torch.Generator(device=dev).manual_seed(0)
rand = lambda *s: torch.randn(*s, device=dev, generator=g)
lib = _build.load('attn_block')
old = lib.attn_block_window_bf16
old.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
pre = ctypes.CDLL(TMP + '/pre.so').attn_block
pre.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]

def run_lib(fn, x, wqkv, bqkv, bias, region, wproj, bproj, heads, extra=()):
    out = torch.empty_like(x)
    _build.launch(fn, x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), bias.data_ptr(),
                  None if region is None else region.data_ptr(), wproj.data_ptr(), bproj.data_ptr(),
                  out.data_ptr(), x.shape[0], x.shape[2], 0 if region is None else region.shape[0],
                  *extra, torch.cuda.current_stream().cuda_stream)
    return out
run_old = lambda *a: run_lib(old, *a)
run_pre = lambda *a: run_lib(pre, *a, extra=(1,))

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
for bnw, nw, c in ((6400, 400, 96), (1600, 100, 192), (400, 25, 384),
                   (1, 1, 96), (4, 1, 96), (401, 1, 96), (3, 1, 192), (265, 1, 192), (1, 1, 384), (133, 1, 384), (7, 1, 384)):
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
        got = attn_block(*args); torch.cuda.synchronize()
        ref = attn_block_plain(*args)
        err = (got.float() - ref.float()).abs().max().item() / ref.float().abs().max().item()
        o = run_old(*args)
        p = run_pre(*args)
        ok = err <= 2 ** -7 and torch.isfinite(got.float()).all().item() and torch.equal(got, attn_block(*args))
        bad += not ok
        print(f'bnw {bnw} c {c} {"shifted" if reg is not None else "unshifted"}: new rel {err:.3g} '
              f'new==old {torch.equal(got, o)} new==pre {torch.equal(got, p)} {"OK" if ok else "BAD"}')
    if bnw >= 400:
        args = (x, wqkv, bqkv, bias, region, wproj, bproj, heads)
        tn1 = tm(lambda: attn_block(*args)); to1 = tm(lambda: run_old(*args))
        to2 = tm(lambda: run_old(*args)); tn2 = tm(lambda: attn_block(*args))
        dn1 = device_ms(lambda: attn_block(*args)); dp1 = device_ms(lambda: run_pre(*args))
        do = device_ms(lambda: run_old(*args))
        dp2 = device_ms(lambda: run_pre(*args)); dn2 = device_ms(lambda: attn_block(*args))
        print(f'  c {c} events: new {tn1:.4f} old {to1:.4f} old {to2:.4f} new {tn2:.4f}; device: new {dn1:.4f} '
              f'pre {dp1:.4f} old {do:.4f} pre {dp2:.4f} new {dn2:.4f}')
print('BAD', bad)
sys.exit(1 if bad else 0)
