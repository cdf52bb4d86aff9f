"""Kernel 4's wide form (`csrc/swin_mlp.cu`: LayerNorm, then fc1 and fc2 on
the persistent warp-specialised GEMM kernel) against copies of itself with
other tile shapes, and against another checkout's kernel 4 (the fused
kernel, and its own C = 1536 form), at the bf16 MLP rows of Swin-L and
Swin-T at 544, batch 16.

Each copy's source is the repository's with the table of `wide::Shape`
replaced (every width and product at BM x BN output rows and columns a
consumer warpgroup and STAGES ring slots, where the width admits it, else
the repository's line); each is built with nvcc beside the repository's
flags with -Xptxas -v (each GEMM instantiation's registers and spills are
printed), held to mlp_block_plain (max |kernel - plain| / max |plain| within
2^-7), to itself (two launches bit-equal) and to the base copy (the same
bits: the tile shape does not change the order of any sum; diagnostic
copies, which do not compute the block, are only timed), and timed:
events around one call (median of 20) and each launch's device time under
torch.profiler (20 calls). The w192_* copies give the wide form C = 192
as well (fc1's and fc2's tiles in their names), timed against the fused
kernel that C = 192 runs, at Swin-L's stage-0 and Swin-T's stage-1 rows.

Run from the repository root on an H100:
python3 probes/h100_swin_mlp/variants.py [--parent DIR] [--variants NAME,...]
where DIR is another checkout's root (its csrc/swin_mlp.cu and headers)."""
import argparse
import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs                                          # noqa: E402
from yolact_minimal_torch.ops import _build                      # noqa: E402
from yolact_minimal_torch.ops.swin_mlp import mlp_block_plain    # noqa: E402

# (C, rows): Swin-L's stages 1-3 and Swin-T's stages 2-3 at 544, batch 16
SHAPES = ((384, 73984), (384, 18496), (768, 18496), (768, 4624), (1536, 4624))
RAGGED = (1, 127, 129, 1000)
TABLE = re.compile(r'template <> struct Shape<(\d+), (true|false)> : ShapeOf<(\d+), (\d+), (\d+)> \{\};')
# name: (BM, BN, STAGES) for every width and product that admits it
VARIANTS = {'m128n128s5': (128, 128, 5), 'm128n128s4': (128, 128, 4),
            'm128n128s3': (128, 128, 3), 'm64n192s5': (64, 192, 5), 'm64n128s6': (64, 128, 6)}
# copies with the wide form at C = 192 too: (fc1's, fc2's) (BM, BN, STAGES);
# fc2's 192 columns take BN 64 or 192
WIDE192 = {'w192_m128n128_m128n64': ((128, 128, 4), (128, 64, 6)),
           'w192_m128n128_m64n192': ((128, 128, 4), (64, 192, 5)),
           'w192_m64n192_m128n64': ((64, 192, 5), (128, 64, 6)),
           'w192_m64n192_m64n192': ((64, 192, 5), (64, 192, 5))}
# (C, rows) where such copies run: Swin-L's stage 0 and Swin-T's stage 1
SHAPES192 = ((192, 295936), (192, 73984))
WIDE_CASE = '    case 384: return launch_bf16_wide<384>('
# copies that edit something else: (text, replacement)
GELU = '''pack_bf16(gelu_erf(round_to<bf16>(v0 + b.x)),
                              gelu_erf(round_to<bf16>(v1 + b.y)));'''
EDITS = {'nogelu': ((GELU, 'pack_bf16(v0 + b.x, v1 + b.y);'),)}
# copies that do not compute the block: timed, not held to the plain version
DIAGNOSTICS = ('nogelu',)


def _smem(bm, bn, stages):
    return stages * (bm + bn) * 128 + 2 * bm * bn * 2 + 2 * bn * 4 + (2 * stages + 2) * 8 + 1024


def variant(src, shape):
    def line(m):
        c, fc2 = int(m.group(1)), m.group(2) == 'true'
        bm, bn, stages = shape
        n = c if fc2 else 4 * c
        if n % bn or _smem(bm, bn, stages) > 232448:
            return m.group(0)
        return f'template <> struct Shape<{c}, {m.group(2)}> : ShapeOf<{bm}, {bn}, {stages}> {{}};'
    if not TABLE.search(src):
        raise SystemExit('variants.py: the source no longer holds the wide::Shape table')
    return TABLE.sub(line, src)


def widen192(src, fc1, fc2):
    """The source with the wide form taking C = 192 on tiles fc1 and fc2."""
    last = list(TABLE.finditer(src))[-1]
    lines = ''.join(f'\ntemplate <> struct Shape<192, {fc2_}> : ShapeOf<{bm}, {bn}, {st}> {{}};'
                    for fc2_, (bm, bn, st) in (('false', fc1), ('true', fc2)))
    if WIDE_CASE not in src:
        raise SystemExit('variants.py: the source no longer holds swin_mlp_wide\'s C = 384 case')
    src = src[:last.end()] + lines + src[last.end():]
    return src.replace(WIDE_CASE, WIDE_CASE.replace('384', '192') +
                       'x, lns, lnb, k1, b1, k2, b2, out, xn, h, rows, s);\n' + WIDE_CASE)


def build(out, sources, verbose=()):
    procs = {}
    for name, (csrc, text) in sources.items():
        d = out / name
        d.mkdir()
        for h in csrc.glob('*.cuh'):
            (d / h.name).write_text(h.read_text())
        (d / 'swin_mlp.cu').write_text(text)
        flags = list(_build.NVCC_FLAGS) + (['-Xptxas', '-v'] if name in verbose else [])
        procs[name] = subprocess.Popen([_build.nvcc_path(), *flags, '-o', str(d / 'lib.so'),
                                        str(d / 'swin_mlp.cu')], stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f'nvcc failed for {name}:\n{log}')
        if name in verbose:
            # each GEMM instantiation's registers and spills
            lines = log.splitlines()
            for i, ln in enumerate(lines):
                m = re.search(r"Compiling entry function '\S*mlp_wide_gemm_kernelILi(\d+)ELb(\d)", ln)
                if m:
                    print(f'{name} C = {m.group(1)} fc{int(m.group(2)) + 1}: ' +
                          ' | '.join(x.strip() for x in lines[i + 2:i + 4]))
        libs[name] = ctypes.CDLL(str(d.parent / name / 'lib.so'))
    return libs


def caller(lib, form, x, params):
    """A function that runs kernel 4 from `lib` on x in `form`: 'wide'
    (swin_mlp_wide with its width), 'wide1536' (a C = 1536-only
    swin_mlp_wide), or 'fused' (swin_mlp)."""
    rows, c = x.shape
    out = torch.empty_like(x)
    xn, h = torch.empty_like(x), x.new_empty((rows, 4 * c))
    ptrs = [t.data_ptr() for t in (x, *params, out)]
    stream = torch.cuda.current_stream().cuda_stream
    if form == 'wide':
        fn = lib.swin_mlp_wide
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        args = (*ptrs, xn.data_ptr(), h.data_ptr(), rows, c, stream)
    elif form == 'wide1536':
        fn = lib.swin_mlp_wide
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_void_p]
        args = (*ptrs, xn.data_ptr(), h.data_ptr(), rows, stream)
    else:
        fn = lib.swin_mlp
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        args = (*ptrs, rows, c, 1, stream)
    fn.restype = ctypes.c_int

    def run():
        _build.launch(fn, *args)
        return out
    run.room = (xn, h)                # alive while the launches may use them
    return run


def launch_ms(fn, iters=20):
    """Device ms a call of each launch (LayerNorm, fc1, fc2, fused)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ms = dict(ln=0.0, fc1=0.0, fc2=0.0, fused=0.0)
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n = e.key
        key = ('ln' if 'mlp_wide_ln' in n else 'fc2' if re.search(r'mlp_wide_gemm.*true', n)
               else 'fc1' if 'mlp_wide_gemm' in n else 'fused' if 'mlp_bf16_sm90' in n else None)
        if key:
            ms[key] += e.device_time_total / 1e3 / iters
    return ms


def inputs(c, rows, seed):
    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(seed)
    rand = lambda *shape: torch.randn(*shape, device=dev, generator=g)
    x = rand(rows, c).bfloat16()
    params = (1.0 + 0.1 * rand(c), 0.1 * rand(c), (0.05 * rand(4 * c, c)).bfloat16(),
              0.05 * rand(4 * c), (0.05 * rand(c, 4 * c)).bfloat16(), 0.05 * rand(c))
    return x, params


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--parent', type=Path)
    ap.add_argument('--variants', default=','.join(VARIANTS))
    opts = ap.parse_args()
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    csrc = ROOT / 'yolact_minimal_torch' / 'csrc'
    src = (csrc / 'swin_mlp.cu').read_text()
    sources = {'base': (csrc, src)}
    for name in filter(None, opts.variants.split(',')):
        if name in EDITS:
            text = src
            for a, b in EDITS[name]:
                if a not in text:
                    raise SystemExit(f'variants.py: the source no longer holds {a!r}')
                text = text.replace(a, b)
            sources[name] = (csrc, text)
        elif name in WIDE192:
            sources[name] = (csrc, widen192(src, *WIDE192[name]))
        else:
            sources[name] = (csrc, variant(src, VARIANTS[name]))
    if opts.parent:
        pc = opts.parent / 'yolact_minimal_torch' / 'csrc'
        sources['parent'] = (pc, (pc / 'swin_mlp.cu').read_text())
    with tempfile.TemporaryDirectory(prefix='swin_mlp_variants_') as tmp:
        libs = build(Path(tmp), sources, verbose=tuple(sources))
    bad = []
    for c in sorted({c for c, _ in SHAPES}):
        for rows in RAGGED:
            x, params = inputs(c, rows, rows)
            ref = mlp_block_plain(x, *params)
            got = caller(libs['base'], 'wide', x, params)().clone()
            again = caller(libs['base'], 'wide', x, params)()
            torch.cuda.synchronize()
            _, rel = cs._rel_err(got, ref)
            ok = rel <= cs.SWIN_BF16_REL_TOL and torch.equal(got, again)
            print(f'ragged C = {c} rows {rows}: rel {rel:.4g}, two launches equal '
                  f'{torch.equal(got, again)}', flush=True)
            if not ok:
                bad.append(f'ragged {c} {rows}')
    wide192 = [name for name in libs if name in WIDE192]
    for name in wide192:
        for rows in RAGGED + (65,):
            x, params = inputs(192, rows, rows)
            ref = mlp_block_plain(x, *params)
            got = caller(libs[name], 'wide', x, params)().clone()
            again = caller(libs[name], 'wide', x, params)()
            torch.cuda.synchronize()
            _, rel = cs._rel_err(got, ref)
            print(f'ragged {name} C = 192 rows {rows}: rel {rel:.4g}, two launches equal '
                  f'{torch.equal(got, again)}', flush=True)
            if rel > cs.SWIN_BF16_REL_TOL or not torch.equal(got, again):
                bad.append(f'ragged {name} 192 {rows}')
    for c, rows in SHAPES + (SHAPES192 if wide192 else ()):
        x, params = inputs(c, rows, 7)
        ref = mlp_block_plain(x, *params)
        bound, _ = cs._mlp_bound(rows, c)
        if c == 192:
            # the base runs the fused kernel there; its output is the one compared
            forms = [('base', 'fused')] + [(name, 'wide') for name in wide192]
        else:
            forms = [(name, 'wide') for name in libs if name != 'parent']
        if 'parent' in libs:
            forms.append(('parent', 'wide1536' if c == 1536 else 'fused'))
        base_out = None
        for name, form in forms + forms[::-1]:
            run = caller(libs[name], form, x, params)
            got = run().clone()
            torch.cuda.synchronize()
            _, rel = cs._rel_err(got, ref)
            same = torch.equal(got, run())
            if name == 'base':
                base_out = got if base_out is None else base_out
            equal_base = torch.equal(got, base_out) if form == 'wide' else None
            # at C = 192 the fused kernel's bits are reported, not required
            if name not in DIAGNOSTICS and (rel > cs.SWIN_BF16_REL_TOL or not same or
                                            (equal_base is False and c != 192)):
                bad.append(f'{name} {form} {c} {rows}')
            ms = cs._time_ms(run)
            dev = launch_ms(run)
            total = sum(dev.values())
            print(f'C = {c} rows {rows} {name:11s} {form:8s}: {ms:.4f} ms, device {total:.4f} '
                  f'({bound / total:.1%} of {bound:.4f}) = ' +
                  ' '.join(f'{k} {v:.4f}' for k, v in dev.items() if v) +
                  f'; rel {rel:.4g}, repeat equal {same}, equal to base {equal_base}', flush=True)
            del got
        del x, params, ref
        torch.cuda.empty_cache()
    if bad:
        raise SystemExit(f'copies that fail a check: {bad}')
    print('all copies agree')


if __name__ == '__main__':
    main()
