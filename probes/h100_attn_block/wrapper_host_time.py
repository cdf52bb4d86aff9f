"""Host time of ops/attn_block.py::attn_block and of its pieces (input checks,
output allocation, weight casts, device and stream lookups, the C call),
each the best of five batches of 200 calls.

Run from the repository root on an H100:
python3 probes/h100_attn_block/wrapper_host_time.py"""
import ctypes, subprocess, sys, time
import torch
sys.path.insert(0, '.')             # the repository root
from yolact_minimal_torch.ops import _build, attn_block as ab
from yolact_minimal_torch.models.swin import shifted_window_regions
print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                     capture_output=True, text=True).stdout.strip())
dev = torch.device('cuda')
g = torch.Generator(device=dev).manual_seed(0)
rand = lambda *s: torch.randn(*s, device=dev, generator=g)
lib = _build.load('attn_block')

def host_us(f, n=200):
    for _ in range(5): f()
    torch.cuda.synchronize()
    best = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n): f()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        best.append((t1 - t0) / n * 1e6)
    return min(best)

for bnw, nw, c in ((6400, 400, 96), (400, 25, 384)):
    heads = c // 32
    side = int(round(nw ** 0.5)) * 7
    region = torch.from_numpy(shifted_window_regions(side, side)).to(dev)
    bf = torch.bfloat16
    x = rand(bnw, 49, c).to(bf)
    wqkv = (rand(3 * c, c) * c ** -0.5).to(bf); bqkv = 0.05 * rand(3 * c)
    wproj = (rand(c, c) * c ** -0.5).to(bf); bproj = 0.05 * rand(c)
    bias = (0.1 * rand(heads, 49, 49)).to(bf)
    args = (x, wqkv, bqkv, bias, region, wproj, bproj, heads)
    out = torch.empty_like(x)
    fn = lib.attn_block
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    st = torch.cuda.current_stream().cuda_stream
    cargs = (x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), bias.data_ptr(), region.data_ptr(),
             wproj.data_ptr(), bproj.data_ptr(), out.data_ptr(), bnw, c, nw, 1, st)
    # a small shape: the host time without the device queue filling up
    xs = x[:4].contiguous(); outs = torch.empty_like(xs); rs = region[:1].contiguous() if nw == 1 else None
    sargs = (xs.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), bias.data_ptr(), None,
             wproj.data_ptr(), bproj.data_ptr(), outs.data_ptr(), 4, c, 0, 1, st)
    print(f'c {c}: wrapper {host_us(lambda: ab.attn_block(xs, wqkv, bqkv, bias, None, wproj, bproj, heads)):.1f} us, '
          f'_check {host_us(lambda: ab._check(*args)):.1f}, check_kernel_shape {host_us(lambda: ab.check_kernel_shape("a", x, heads)):.1f}, '
          f'empty_like {host_us(lambda: torch.empty_like(x)):.1f}, .to {host_us(lambda: (wqkv.to(x.dtype), wproj.to(x.dtype))):.1f}, '
          f'device ctx {host_us(lambda: torch.cuda.device(x.device).__enter__()):.1f}, stream {host_us(lambda: torch.cuda.current_stream(x.device).cuda_stream):.1f}, '
          f'C call {host_us(lambda: fn(*sargs)):.1f} us')
