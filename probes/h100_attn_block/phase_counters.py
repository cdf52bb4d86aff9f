"""clock64 phase counters of the tiled bf16 attn_block body: a copy of
csrc/attn_block.cu with counters inserted at fixed lines (x wait, qkv
product, qkv epilogue and its barriers, attention, proj, output store) is
built beside the package's library; prints the cycles a window spends in
each phase at the stage shapes of C = 96, 192 and 384, and the device time.

The insertion anchors match the tiled body with the overlapped head loop;
run from the repository root on an H100:
python3 probes/h100_attn_block/phase_counters.py"""
import ctypes, tempfile, subprocess, sys, statistics, os, re
import torch
sys.path.insert(0, '.')             # the repository root
from yolact_minimal_torch.ops import _build
from yolact_minimal_torch.ops.attn_block import attn_block, attn_block_plain
from yolact_minimal_torch.models.swin import shifted_window_regions
print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                     capture_output=True, text=True).stdout.strip())
src = open('yolact_minimal_torch/csrc/attn_block.cu').read()
def sub(old, new, count=1):
    global src
    assert src.count(old) >= 1, old
    src = src.replace(old, new, count)
sub('namespace {\n\nusing namespace swin;\n', 'namespace {\n\nusing namespace swin;\n__device__ unsigned long long g_ph[16];\n#define PH(i) do { long long _n = clock64(); if (threadIdx.x % 128 == 0) atomicAdd(&g_ph[i], (unsigned long long)(_n - _pt)); _pt = _n; } while (0)\n')
sub('  uint32_t xphase = 0;\n', '  uint32_t xphase = 0;\n  long long _pt = clock64();\n')
sub('      sm90::mbar_wait(xbar + g, xphase);\n', '      _pt = clock64();\n      sm90::mbar_wait(xbar + g, xphase);\n      PH(0);\n')
# CS == 1 path
sub('      head_bias(bias, wq, bz);\n      qkv_issue(0, acc);\n      qkv_wait(acc);\n', '      _pt = clock64();\n      head_bias(bias, wq, bz);\n      qkv_issue(0, acc);\n      qkv_wait(acc);\n      PH(1);\n')
sub('        qkv_issue(h + 1, acc);\n        attend_rows(qkv0, P::QT, 0, wq, bz, differ, ao, P::TB, h * HD);\n',
    '        PH(2);\n        qkv_issue(h + 1, acc);\n        PH(1);\n        attend_rows(qkv0, P::QT, 0, wq, bz, differ, ao, P::TB, h * HD);\n        PH(3);\n')
sub('        qkv_wait(acc);\n        sync_wg();                      // every warp is done with head h',
    '        qkv_wait(acc);\n        PH(8);\n        sync_wg();                      // every warp is done with head h')
sub('      load_x(t + gridDim.x);            // every product is done with the x tile\n      attend_rows(qkv0, P::QT, 0, wq, bz, differ, ao, P::TB, (P::HEADS - 1) * HD);\n',
    '      PH(2);\n      load_x(t + gridDim.x);            // every product is done with the x tile\n      attend_rows(qkv0, P::QT, 0, wq, bz, differ, ao, P::TB, (P::HEADS - 1) * HD);\n      PH(3);\n')
# CS == 2 path
sub('        qkv_issue(h, acc);\n        qkv_wait(acc);\n        store_qkv', '        _pt = clock64();\n        qkv_issue(h, acc);\n        qkv_wait(acc);\n        PH(1);\n        store_qkv')
sub('        if (has && attends) attend_rows(qkv, P::QT, 0, wq, bz, differ, ao, P::TB, h * HD);\n',
    '        PH(2);\n        if (has && attends) attend_rows(qkv, P::QT, 0, wq, bz, differ, ao, P::TB, h * HD);\n        PH(3);\n')
sub('    sync_wg();                          // the attention-output tile is whole\n',
    '    sync_wg();                          // the attention-output tile is whole\n    PH(4);\n')
sub('    for (int p = 0; p < P::NP; ++p) sm90::fence_regs(pacc[p]);\n', '    for (int p = 0; p < P::NP; ++p) sm90::fence_regs(pacc[p]);\n    PH(5);\n')
sub('      sm90::bulk_commit();\n    }\n  }\n', '      sm90::bulk_commit();\n    }\n    PH(6);\n    if (threadIdx.x % 128 == 0) atomicAdd(&g_ph[7], 1ull);\n  }\n')
src += '''
extern "C" int read_phases(unsigned long long* h) {
  cudaError_t e = cudaMemcpyFromSymbol(h, g_ph, sizeof(g_ph));
  unsigned long long z[16] = {0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_ph, z, sizeof(g_ph));
  return (int)e;
}
'''
TMP = tempfile.mkdtemp()
open(TMP + '/attn_block_ph.cu', 'w').write(src)
r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, '-Xptxas', '-v', '-I', str(_build.CSRC),
                    '-o', TMP + '/libph.so', TMP + '/attn_block_ph.cu'], capture_output=True, text=True)
print('ph build rc', r.returncode)
for line in (r.stdout + r.stderr).splitlines():
    if 'egisters' in line or 'wgmma' in line.lower() or 'arning' in line or 'error' in line:
        print('  ', line[:240])
if r.returncode:
    sys.exit(1)
# also the plain build's ptxas advisories
r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, '-Xptxas', '-v', '-o', TMP + '/x.so',
                    str(_build.CSRC / 'attn_block.cu')], capture_output=True, text=True)
for line in (r.stdout + r.stderr).splitlines():
    if 'wgmma' in line.lower() or 'arning' in line:
        print(' repo build:', line[:240])
lib = ctypes.CDLL(TMP + '/libph.so')
fn = lib.attn_block
fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
rd = lib.read_phases; rd.argtypes = [ctypes.c_void_p]
dev = torch.device('cuda')
g = torch.Generator(device=dev).manual_seed(0)
rand = lambda *s: torch.randn(*s, device=dev, generator=g)

def device_ms(f, iters=20):
    f(); torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters): f()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / iters / 1e3

names = ['xwait', 'qkv issue/wait', 'epi+sync', 'attend', 'ao-sync', 'proj', 'store', 'n', 'qkv tail wait']
for bnw, nw, c in ((6400, 400, 96), (1600, 100, 192), (400, 25, 384)):
    heads = c // 32
    side = int(round(nw ** 0.5)) * 7
    region = torch.from_numpy(shifted_window_regions(side, side)).to(dev)
    bf = torch.bfloat16
    x = rand(bnw, 49, c).to(bf)
    wqkv = (rand(3 * c, c) * c ** -0.5).to(bf); bqkv = 0.05 * rand(3 * c)
    wproj = (rand(c, c) * c ** -0.5).to(bf); bproj = 0.05 * rand(c)
    bias = (0.1 * rand(heads, 49, 49)).to(bf)
    args = (x, wqkv, bqkv, bias, region, wproj, bproj, heads)
    dm = device_ms(lambda: attn_block(*args))
    out = torch.empty_like(x)
    ph = (ctypes.c_ulonglong * 16)()
    rd(ph)
    fn(x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), bias.data_ptr(), region.data_ptr(),
       wproj.data_ptr(), bproj.data_ptr(), out.data_ptr(), bnw, c, nw, 1, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    rd(ph)
    ref = attn_block_plain(*args)
    ok = (out.float() - ref.float()).abs().max().item() / ref.float().abs().max().item()
    tiles = ph[7]
    tot = sum(ph[i] for i in range(7))
    print(f'c {c}: device ms {dm:.4f}; instrumented rel err {ok:.3g}; window-tiles {tiles}; cycles a window: '
          + ', '.join(f'{n} {ph[i] / tiles:.0f}' for i, n in enumerate(names) if i != 7) + f'; sum {(tot + ph[8]) / tiles:.0f}')
