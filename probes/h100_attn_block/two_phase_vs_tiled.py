"""The two-phase bf16 attn_block body (phase 1 a block per head and chunk of
windows, phase 2 the proj over 64-row tiles) against the plain version at
the four stage shapes and on partial inputs, and its device time in turns
against the tiled body (C = 96, 192, 384) and the one-block-a-window body
(C = 768), with each kernel's device time.

Written for csrc/attn_block.cu while it exported attn_block_other_bf16 (the
body a width does not run); run from the repository root on an H100:
python3 probes/h100_attn_block/two_phase_vs_tiled.py"""
import ctypes, tempfile, subprocess, sys, statistics
import torch
sys.path.insert(0, '.')             # the repository root
from yolact_minimal_torch.ops import _build
from yolact_minimal_torch.ops.attn_block import attn_block, attn_block_plain
from yolact_minimal_torch.models.swin import shifted_window_regions
print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                     capture_output=True, text=True).stdout.strip())
r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, '-Xptxas', '-v', '-o', tempfile.mkdtemp() + '/a.so',
                    str(_build.CSRC / 'attn_block.cu')], capture_output=True, text=True)
lines = (r.stdout + r.stderr).splitlines()
for i, line in enumerate(lines):
    if 'wgmma' in line.lower() or 'arning' in line or 'error' in line:
        print('  ', line[:240])
    if 'Compiling' in line and ('heads' in line or 'proj_rows' in line or 'sm90_kernel' in line):
        print('  ', line.split("'")[1][40:100], '|', lines[i + 2].strip()[:80], '|', lines[i + 3].strip()[:60])
if r.returncode:
    print('\n'.join(lines[-40:])); sys.exit(1)
_build.build(['attn_block', 'swin_block'])
dev = torch.device('cuda')
g = torch.Generator(device=dev).manual_seed(0)
rand = lambda *s: torch.randn(*s, device=dev, generator=g)
lib = _build.load('attn_block')
other = lib.attn_block_other_bf16
other.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]

def run_other(which, x, wqkv, bqkv, bias, region, wproj, bproj, heads):
    out = torch.empty_like(x)
    _build.launch(other, x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), bias.data_ptr(),
                  None if region is None else region.data_ptr(), wproj.data_ptr(), bproj.data_ptr(),
                  out.data_ptr(), x.shape[0], x.shape[2], 0 if region is None else region.shape[0],
                  which, torch.cuda.current_stream().cuda_stream)
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
for bnw, nw, c in ((6400, 400, 96), (1600, 100, 192), (400, 25, 384), (144, 9, 768), (1, 1, 96), (5, 1, 96), (301, 1, 96), (2, 1, 192), (301, 1, 192), (1, 1, 768), (301, 1, 384)):
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
        ref = attn_block_plain(*args)
        if c == 768:
            fn = lambda: attn_block(*args)
        else:
            fn = lambda: run_other(1, *args)
        try:
            got = fn(); torch.cuda.synchronize()
        except Exception as e:
            print('FAIL', bnw, c, e); bad += 1; continue
        err = (got.float() - ref.float()).abs().max().item() / ref.float().abs().max().item()
        ok = err <= 2 ** -7 and torch.isfinite(got.float()).all().item() and torch.equal(got, fn())
        bad += not ok
        print(f'two-phase bnw {bnw} c {c} {"shifted" if reg is not None else "unshifted"}: rel {err:.3g} {"OK" if ok else "BAD"}')
    if bnw in (144, 400, 1600, 6400):
        args = (x, wqkv, bqkv, bias, region, wproj, bproj, heads)
        if c == 768:
            new = lambda: attn_block(*args); old = lambda: run_other(0, *args); names = ('two-phase', 'window')
        else:
            new = lambda: run_other(1, *args); old = lambda: attn_block(*args); names = ('two-phase', 'tiled')
        t = [tm(new), tm(old), tm(old), tm(new)]
        d = [device_ms(new), device_ms(old), device_ms(old), device_ms(new)]
        print(f'  c {c} ({names[0]}, {names[1]}, {names[1]}, {names[0]}): events {" / ".join(f"{v:.4f}" for v in t)}; '
              f'device {" / ".join(f"{v:.4f}" for v in d)}')
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10): new()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                print(f'    {e.self_device_time_total / 10 / 1e3:.4f} ms  {e.key[:90]}')
print('BAD', bad)
sys.exit(1 if bad else 0)
