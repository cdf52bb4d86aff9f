"""The suppression kernel (`csrc/suppression.cu`) against the first port's
body (`suppression_first_port.cu` here, built as 'first') and against
patched copies of itself, on the two inputs of chip_smoke.py phase 3 at
[1280, 200]: (a) the fixture with scattered invalid slots and zero-area
boxes, (b) all valid. Each build is held to the plain version (exact, NaN
positions equal; the two copies with __fdividef, rcp and fastdiv, are not
exact and report their differing entries), ptxas registers and spill are
printed, and each kernel's device time (torch.profiler, 20 calls) is taken
in turns, the list forward and then backward. Exits 1 if an exact build
differs.

Copies (edits of the source's constants or text): w4r8 (4 warps a row, 8
candidate blocks a lane: the first shape), w4 / w3 (4 / 3 warps), w3b10 (3
warps, at least 10 blocks a multiprocessor by launch bounds: one wave), r8
(8 blocks a lane), unroll2 (the j loop unrolled by 2), rcp (the fast rows'
exact division replaced by __fdividef: what its refinement costs), ffilter
(the fast rows' division only where fma(-max, union, inter) >= 0), generic
(every row on the generic path: __fdiv_rn and a NaN-propagating max, the
clamps on the min/max unit; the first form of this redesign),
filter (the generic path with the division only where an fma test says the
pair may raise the running max: t = fma(-max, union, inter) >= 0, with the 0/0
pairs), fastdiv (the generic path with __fdividef instead of __fdiv_rn:
the division's share of its time), counters (clock64 and globaltimer
records a block, read after one launch: pass 1, pass 2, each warp's triangle,
blocks a multiprocessor and the launch's span).

Run from the repository root on an H100:
python3 probes/h100_suppression/variants.py"""
import ctypes
import os
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, '.')             # the repository root
from yolact_minimal_torch.ops import _build
from yolact_minimal_torch.ops.suppression import suppression_iou_max_plain

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = open(_build.CSRC / 'suppression.cu').read()

FORCE_GENERIC = ('const bool fast = !__syncthreads_or(slow);',
                 'const bool fast = !__syncthreads_or(true);')
UPDATE = """      const float m = take_max<FAST>(c.best[r], pair_iou<FAST>(bj, aj, c, r));
      if (!DIAG || r < A - 1 || j < c.last - 32 * r) c.best[r] = m;
"""
FILTER = """      if constexpr (FAST) {
        const float m = take_max<FAST>(c.best[r], pair_iou<FAST>(bj, aj, c, r));
        if (!DIAG || r < A - 1 || j < c.last - 32 * r) c.best[r] = m;
      } else {
        const float dx = __fsub_rn(fminf(bj.z, c.x2[r]), fmaxf(bj.x, c.x1[r]));
        const float dy = __fsub_rn(fminf(bj.w, c.y2[r]), fmaxf(bj.y, c.y1[r]));
        const float inter = __fmul_rn(fmaxf(dx, 0.0f), fmaxf(dy, 0.0f));
        const float uni = __fsub_rn(__fadd_rn(aj, c.area[r]), inter);
        const float t = __fmaf_rn(-c.thr[r], uni, inter);
        bool take = !(t < 0.0f) && (inter != 0.0f || !(uni > 0.0f));
        if (DIAG && r == A - 1) take = take && j < c.last - 32 * r;
        if (take) {
          c.best[r] = max_nan(c.best[r], __fdiv_rn(inter, uni));
          c.thr[r] = c.best[r] == c.best[r] ? c.best[r] : __int_as_float(0x7f800000);
        }
      }
"""
FFILTER = """      if constexpr (FAST) {
        const float dx = __fsub_rn(fminf(bj.z, c.x2[r]), fmaxf(bj.x, c.x1[r]));
        const float dy = __fsub_rn(fminf(bj.w, c.y2[r]), fmaxf(bj.y, c.y1[r]));
        const float inter4 = __fmul_rn(__fadd_rn(dx, fabsf(dx)), __fadd_rn(dy, fabsf(dy)));
        const float uni4 = __fsub_rn(__fadd_rn(aj, c.area[r]), inter4);
        bool take = __fmaf_rn(-c.thr[r], uni4, inter4) >= 0.0f && inter4 > 0.0f;
        if (DIAG && r == A - 1) take = take && j < c.last - 32 * r;
        if (take) {
          c.best[r] = fmaxf(c.best[r], div_moderate(inter4, uni4));
          c.thr[r] = c.best[r];
        }
      } else {
        const float m = take_max<FAST>(c.best[r], pair_iou<FAST>(bj, aj, c, r));
        if (!DIAG || r < A - 1 || j < c.last - 32 * r) c.best[r] = m;
      }
"""


def patched(name):
    """The kernel's source for variant `name`: 'generic' sends every row to
    the generic path (__fdiv_rn, NaN-propagating max); 'filter' and 'fastdiv'
    are that path with the division only where an fma test lets a pair raise
    the running max, or with __fdividef."""
    src = SRC
    edits = list(VARIANTS[name])
    if name in ('generic', 'filter', 'fastdiv'):
        edits.append(FORCE_GENERIC)
    if name == 'counters':
        edits += COUNTERS
    if name == 'unroll2':
        edits.append(('  for (int j = j0; j < j1; ++j) {\n    const float4 bj',
                      '#pragma unroll 2\n  for (int j = j0; j < j1; ++j) {\n    const float4 bj'))
    if name == 'rcp':
        edits.append(('return div_moderate(inter4, ', 'return __fdividef(inter4, '))
    if name == 'fastdiv':
        edits.append(('return __fdiv_rn(inter, __fsub_rn(__fadd_rn(aj, c.area[r]), inter));',
                      'return __fdividef(inter, __fsub_rn(__fadd_rn(aj, c.area[r]), inter));'))
    if name == 'ffilter':
        edits += [('float x1[kR], y1[kR], x2[kR], y2[kR], area[kR], best[kR];',
                   'float x1[kR], y1[kR], x2[kR], y2[kR], area[kR], best[kR], thr[kR];'),
                  ('      c.best[r] = 0.0f;\n', '      c.best[r] = 0.0f;\n      c.thr[r] = 0.0f;\n'),
                  (UPDATE, FFILTER)]
    if name == 'filter':
        edits += [('float x1[kR], y1[kR], x2[kR], y2[kR], area[kR], best[kR];',
                   'float x1[kR], y1[kR], x2[kR], y2[kR], area[kR], best[kR], thr[kR];'),
                  ('      c.best[r] = 0.0f;\n', '      c.best[r] = 0.0f;\n      c.thr[r] = 0.0f;\n'),
                  (UPDATE, FILTER)]
    for old, new in edits:
        assert old in src, old
        src = src.replace(old, new)
    return src


# 'counters': per block, clock64 cycles of pass 1 and pass 2, each warp's
# triangle and the whole block, its multiprocessor and globaltimer at start
# and end, into g_prof (read back through suppression_prof).
COUNTERS = [
    ('namespace {\n', 'namespace {\n__device__ long long g_prof[4096 * 16];\n'),
    ('  const size_t row = static_cast<size_t>(blockIdx.x) * k;\n',
     '  const size_t row = static_cast<size_t>(blockIdx.x) * k;\n'
     '  const long long t0 = clock64();\n'
     '  unsigned long long g0;\n'
     '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));\n'),
    ('  const bool fast = !__syncthreads_or(slow);\n',
     '  const bool fast = !__syncthreads_or(slow);\n  const long long t1 = clock64();\n'),
    ('  if (fast) {\n    triangle<true>',
     '  const long long t2 = clock64();\n  if (fast) {\n    triangle<true>'),
    ('    triangle<false>(sbox, sarea, sbest, n, lane, warp);\n  }\n  __syncthreads();\n',
     '    triangle<false>(sbox, sarea, sbest, n, lane, warp);\n  }\n'
     '  if (lane == 0) g_prof[blockIdx.x * 16 + 8 + warp] = clock64() - t2;\n'
     '  __syncthreads();\n'),
    ('out[row + sidx[a]] = __int_as_float(sbest[a]);\n}\n',
     'out[row + sidx[a]] = __int_as_float(sbest[a]);\n'
     '  __syncthreads();\n'
     '  if (threadIdx.x == 0) {\n'
     '    unsigned long long g1;\n'
     '    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));\n'
     '    unsigned smid;\n'
     '    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));\n'
     '    long long* p = g_prof + blockIdx.x * 16;\n'
     '    p[0] = smid; p[1] = g0; p[2] = g1; p[3] = t1 - t0; p[4] = t2 - t1; p[6] = fast;\n'
     '    p[5] = clock64() - t0;\n'
     '  }\n}\n'),
    ('extern "C" int suppression_geometry(',
     'extern "C" int suppression_prof(void* dst) {\n'
     '  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_prof, sizeof(g_prof)));\n}\n\n'
     'extern "C" int suppression_geometry('),
]


# Shape knobs, applied as edits of the source's constants: warps a row,
# candidate blocks a lane, minimum resident blocks by launch bounds.
WARPS = ('constexpr int kWarps = 2;', 'constexpr int kWarps = {};')
BLOCKS = ('constexpr int kR = 4;', 'constexpr int kR = {};')
BOUNDS = ('__launch_bounds__(kThreads)', '__launch_bounds__(kThreads, {})')


def knob(edit, value):
    return edit[0], edit[1].format(value)


VARIANTS = {'new': [], 'w4r8': [knob(WARPS, 4), knob(BLOCKS, 8)], 'w4': [knob(WARPS, 4)],
            'w3': [knob(WARPS, 3)], 'w3b10': [knob(WARPS, 3), knob(BOUNDS, 10)],
            'r8': [knob(BLOCKS, 8)], 'unroll2': [], 'rcp': [], 'ffilter': [], 'generic': [],
            'filter': [], 'fastdiv': [], 'counters': []}


def build(tmp):
    procs = {}
    for name in VARIANTS:
        path = os.path.join(tmp, f'{name}.cu')
        with open(path, 'w') as f:
            f.write(patched(name))
        procs[name] = path
    procs['first'] = os.path.join(HERE, 'suppression_first_port.cu')
    running = {n: subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS, '-Xptxas', '-v',
                                    '-o', os.path.join(tmp, f'{n}.so'), path],
                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
               for n, path in procs.items()}
    libs, handles = {}, {}
    for n, p in running.items():
        out, _ = p.communicate()
        if p.returncode:
            print(out[-4000:])
            raise SystemExit(f'{n}: nvcc failed')
        usage = [line.split(':')[-1].strip() for line in out.splitlines()
                 if 'Used' in line or 'spill' in line]
        print(f'{n}: {"; ".join(usage)}')
        handles[n] = ctypes.CDLL(os.path.join(tmp, f'{n}.so'))
        fn = handles[n].suppression_iou_max
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[n] = fn
    return libs, handles


def counters_report(what, handle, call):
    """One launch of the counters build: phase cycles a block, blocks a
    multiprocessor, the kernel's span and how many blocks were resident."""
    import numpy as np
    call()
    torch.cuda.synchronize()
    buf = np.zeros(4096 * 16, dtype=np.int64)
    fn = handle.suppression_prof
    fn.argtypes = [ctypes.c_void_p]
    _build.launch(fn, buf.ctypes.data)
    p = buf.reshape(4096, 16)[:1280]
    p[:, 8:16] = np.where(np.arange(8) < 2, p[:, 8:16], 0)     # the source's two warps
    sm, g0, g1 = p[:, 0], p[:, 1], p[:, 2]
    tri = p[:, 8:16]
    tri_max = tri.max(1)
    tri_min = np.where(tri > 0, tri, tri_max[:, None]).min(1)
    span_us = (g1.max() - g0.min()) / 1e3
    blk_ns = g1 - g0
    ghz = np.median(p[:, 5]) / np.median(blk_ns)
    per_sm = np.bincount(sm, minlength=132)
    busy = np.bincount(sm, weights=blk_ns, minlength=132)
    sm_span = np.array([(g1[sm == i].max() - g0[sm == i].min()) if (sm == i).any() else 0
                        for i in range(132)])
    print(f'{what} counters: span {span_us:.2f} us (globaltimer), clock ~{ghz:.3f} GHz; '
          f'a block: pass 1 {np.median(p[:, 3]):.0f}, pass 2 {np.median(p[:, 4]):.0f}, '
          f'triangle slowest warp {np.median(tri_max):.0f} / fastest {np.median(tri_min):.0f}, '
          f'whole {np.median(p[:, 5]):.0f} cycles (medians); blocks a multiprocessor '
          f'{per_sm.min()}-{per_sm.max()}; resident blocks (block time / multiprocessor span) '
          f'{np.median(busy / np.maximum(sm_span, 1)):.2f}; multiprocessor spans '
          f'{sm_span.min() / 1e3:.2f}-{sm_span.max() / 1e3:.2f} us; first start to last start '
          f'{(g0.max() - g0.min()) / 1e3:.2f} us; generic rows {int((p[:, 6] == 0).sum())}, '
          f'slowest block {p[:, 5].max()} cycles')


def inputs(dev, all_valid):
    """chip_smoke.py phase 3's inputs at [1280, 200]."""
    g = torch.Generator(device=dev).manual_seed(0)
    rows, k = 1280, 200
    xy = torch.rand(2, rows, k, device=dev, generator=g) * 0.8
    wh = torch.rand(2, rows, k, device=dev, generator=g) * 0.4
    x1, y1 = xy[0].contiguous(), xy[1].contiguous()
    x2, y2 = (x1 + wh[0]).clamp(max=1.0), (y1 + wh[1]).clamp(max=1.0)
    flat = torch.rand(rows, k, device=dev, generator=g) < 0.05
    valid = torch.rand(rows, k, device=dev, generator=g) > 0.2
    if all_valid:
        return (x1, y1, x2, y2, torch.ones_like(valid))
    for t in (x1, y1, x2, y2):
        t[flat] = 1.0
    valid[::7] = False
    return (x1, y1, x2, y2, valid)


def device_ms(f, iters=20):
    f()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            f()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / iters / 1e3


def main():
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device('cuda')
    bad = 0
    with tempfile.TemporaryDirectory() as tmp:
        libs, handles = build(tmp)
        for what, all_valid in (('(a) fixture', False), ('(b) all valid', True)):
            args = inputs(dev, all_valid)
            ref = suppression_iou_max_plain(*args)
            rows, k = args[0].shape
            out = torch.empty_like(args[0])

            def call(fn):
                return lambda: _build.launch(fn, *(t.data_ptr() for t in args), out.data_ptr(),
                                             rows, k, torch.cuda.current_stream().cuda_stream)
            for n, fn in libs.items():
                out.fill_(-1.0)
                call(fn)()
                torch.cuda.synchronize()
                nan_eq = torch.equal(torch.isnan(out), torch.isnan(ref))
                fin = ~torch.isnan(ref)
                diff = int((out[fin] != ref[fin]).sum())
                ok = nan_eq and diff == 0
                bad += not ok and n not in ('rcp', 'fastdiv')     # these two are inexact
                print(f'{what} {n}: NaN positions equal {nan_eq}, differing entries {diff} '
                      f'{"OK" if ok else "DIFFERS"}')
            order = list(libs) + list(libs)[::-1]
            times = {n: [] for n in libs}
            for n in order:
                times[n].append(device_ms(call(libs[n])))
            print(f'{what} device ms (forward, backward): ' + ', '.join(
                f'{n} {a:.4f} / {b:.4f}' for n, (a, b) in times.items()))
            counters_report(what, handles['counters'], call(libs['counters']))
    print('BAD', bad)
    return 1 if bad else 0


if __name__ == '__main__':
    sys.exit(main())
