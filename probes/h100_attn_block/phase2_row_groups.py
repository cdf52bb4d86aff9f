"""Phase 2 of the two-phase bf16 attn_block body with row tiles in groups that
share every weight use, against attn_block_before_row_groups.cu (one row
tile a block, two column groups): errors on the stage shapes and on
partial inputs, and each kernel's device time in turns.

Run from the repository root on an H100:
python3 probes/h100_attn_block/phase2_row_groups.py"""
import ctypes, subprocess, sys, statistics
import torch
sys.path.insert(0, '.')             # the repository root
from yolact_minimal_torch.ops import _build
from yolact_minimal_torch.ops.attn_block import attn_block, attn_block_plain, kernel_attributes, shared_bytes
from yolact_minimal_torch.models.swin import shifted_window_regions
TMP = tempfile.mkdtemp()
print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                     capture_output=True, text=True).stdout.strip())
procs = {n: subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS, '-Xptxas', '-v', '-I', str(_build.CSRC), '-o', f'{TMP}/{n}.so', p],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
         for n, p in (('new', str(_build.CSRC / 'attn_block.cu')), ('v4', 'probes/h100_attn_block/attn_block_before_row_groups.cu'))}
for n, pr in procs.items():
    out, _ = pr.communicate()
    lines = out.splitlines()
    print(n, 'rc', pr.returncode, [lines[i + 3].strip()[14:70] for i, l in enumerate(lines) if 'Compiling' in l and 'proj_rows' in l])
    if pr.returncode:
        print(out[-3000:]); sys.exit(1)
_build.build(['attn_block'])
for c in (96, 192, 384, 768):
    print(c, kernel_attributes(c), shared_bytes(c))
v4 = ctypes.CDLL(TMP + '/v4.so').attn_block
v4.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
dev = torch.device('cuda')
g = torch.Generator(device=dev).manual_seed(0)
rand = lambda *s: torch.randn(*s, device=dev, generator=g)

def device_ms(f, iters=20):
    f(); torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters): f()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.key.split('::')[1].split('(')[0] if '::' in e.key else e.key[:30]] = e.self_device_time_total / iters / 1e3
    return out

bad = 0
for bnw, nw, c in ((1600, 100, 192), (400, 25, 384), (144, 9, 768), (1, 1, 192), (67, 1, 192), (301, 1, 192), (1, 1, 384), (34, 1, 384), (301, 1, 384), (11, 1, 768), (301, 1, 768)):
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
        got = attn_block(*args); torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item() / ref.float().abs().max().item()
        ok = err <= 2 ** -7 and torch.isfinite(got.float()).all().item() and torch.equal(got, attn_block(*args))
        bad += not ok
        print(f'bnw {bnw} c {c} {"shifted" if reg is not None else "unshifted"}: rel {err:.3g} {"OK" if ok else "BAD"}')
    if bnw >= 144:
        args = (x, wqkv, bqkv, bias, region, wproj, bproj, heads)
        out = torch.empty_like(x)
        old = lambda: _build.launch(v4, x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), bias.data_ptr(), region.data_ptr(),
                                    wproj.data_ptr(), bproj.data_ptr(), out.data_ptr(), bnw, c, nw, 1, torch.cuda.current_stream().cuda_stream)
        new = lambda: attn_block(*args)
        for name, f in (('new', new), ('v4', old), ('v4', old), ('new', new)):
            d = device_ms(f)
            print(f'  c {c} {name}: ' + ', '.join(f'{k[:34]} {v:.4f}' for k, v in d.items()) + f'; sum {sum(d.values()):.4f}')
print('BAD', bad)
sys.exit(1 if bad else 0)
