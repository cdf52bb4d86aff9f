"""Phase-1 variants of the two-phase bf16 attn_block body, device time in one
call at the stage shapes of C = 192, 384 and 768: the x ring topped up
before the attention, and other warpgroup and ring-slot counts (copies of
csrc/attn_block.cu built beside the package's library).

The substitution anchors match the two-phase body's first version; run
from the repository root on an H100:
python3 probes/h100_attn_block/phase1_ring_variants.py"""
import ctypes, tempfile, subprocess, sys, os
import torch
sys.path.insert(0, '.')             # the repository root
from yolact_minimal_torch.ops import _build
from yolact_minimal_torch.ops.attn_block import attn_block_plain
from yolact_minimal_torch.models.swin import shifted_window_regions
print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                     capture_output=True, text=True).stdout.strip())
src = open('yolact_minimal_torch/csrc/attn_block.cu').read()
shapes = '''template <> struct HeadShape<192> : HeadShapeOf<3, 5> {};
template <> struct HeadShape<384> : HeadShapeOf<3, 5> {};
template <> struct HeadShape<768> : HeadShapeOf<2, 4> {};'''
assert shapes in src
topup_old = '''    ring.drain();
    sm90::fence_regs(acc);
    // + bqkv, rounded; q * scale rounded, as the A fragments of q k^T; k and'''
topup_new = '''    ring.drain();
    if (issuer) issue_upto(ring.use + P::XS - 1);
    sm90::fence_regs(acc);
    // + bqkv, rounded; q * scale rounded, as the A fragments of q k^T; k and'''
assert topup_old in src
variants = {
    'repo': src,
    'topup': src.replace(topup_old, topup_new),
    'wide': src.replace(shapes, shapes.replace('HeadShape<192> : HeadShapeOf<3, 5>', 'HeadShape<192> : HeadShapeOf<3, 6>')
                        .replace('HeadShape<384> : HeadShapeOf<3, 5>', 'HeadShape<384> : HeadShapeOf<2, 8>')),
    'wide+topup': src.replace(topup_old, topup_new).replace(shapes, shapes.replace('HeadShape<192> : HeadShapeOf<3, 5>', 'HeadShape<192> : HeadShapeOf<3, 6>')
                        .replace('HeadShape<384> : HeadShapeOf<2, 8>'.replace('2, 8', '3, 5'), 'HeadShape<384> : HeadShapeOf<2, 8>')),
}
TMP = tempfile.mkdtemp()
procs = {}
for name, text in variants.items():
    path = f'{TMP}/{name}.cu'
    open(path, 'w').write(text)
    procs[name] = subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS, '-Xptxas', '-v', '-I', str(_build.CSRC),
                                    '-o', f'{TMP}/{name}.so', path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
libs = {}
for name, pr in procs.items():
    out, _ = pr.communicate()
    lines = out.splitlines()
    regs = [lines[i + 3].strip()[14:60] for i, l in enumerate(lines) if 'Compiling' in l and 'attn_heads' in l]
    print(name, 'rc', pr.returncode, regs)
    if pr.returncode:
        print(out[-2000:]); sys.exit(1)
    fn = ctypes.CDLL(f'{TMP}/{name}.so').attn_block
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    libs[name] = fn
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

for bnw, nw, c in ((1600, 100, 192), (400, 25, 384), (144, 9, 768)):
    heads = c // 32
    side = int(round(nw ** 0.5)) * 7
    region = torch.from_numpy(shifted_window_regions(side, side)).to(dev)
    bf = torch.bfloat16
    x = rand(bnw, 49, c).to(bf)
    wqkv = (rand(3 * c, c) * c ** -0.5).to(bf); bqkv = 0.05 * rand(3 * c)
    wproj = (rand(c, c) * c ** -0.5).to(bf); bproj = 0.05 * rand(c)
    bias = (0.1 * rand(heads, 49, 49)).to(bf)
    args = (x, wqkv, bqkv, bias, region, wproj, bproj, heads)
    ref = attn_block_plain(*args)
    res = []
    for rnd in range(2):
        for name, fn in libs.items():
            out = torch.empty_like(x)
            call = lambda fn=fn, out=out: _build.launch(fn, x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), bias.data_ptr(),
                                             region.data_ptr(), wproj.data_ptr(), bproj.data_ptr(), out.data_ptr(),
                                             bnw, c, nw, 1, torch.cuda.current_stream().cuda_stream)
            call(); torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item() / ref.float().abs().max().item()
            res.append(f'{name} {device_ms(call):.4f}{"" if err <= 2 ** -7 else " BAD"}')
    print(f'c {c}: ' + ', '.join(res))
