"""The whole-block kernel's flat form at C = 768 (`csrc/swin_block.cu`, six
launches) against patched copies of itself, at stage 3 of swin_tiny 544/b16
([144, 49, 768] bf16, the shifted block with the padded map's rowmask, the
inputs of chip_smoke.py phase 3). Each copy is built with nvcc beside the
repository's flags, held to swin_block_plain (max |kernel - plain| / max
|plain|, and the share of equal entries), and each of its six launches'
device time is taken under torch.profiler (20 calls), the list forward and
then backward. Exits 1 if a copy that computes the block differs by more
than 2^-7.

Copies (edits of the source's text, with the wrapper's copy of the
product shapes set to match, so that it passes the copy's grids): fc1_one (fc1 as proj and fc2: 192
columns, 4 ring slots, one block a multiprocessor), fc1_192x3 (fc1 at 192
columns and 3 slots, one block), slots5 (proj and fc2 with 5 ring slots),
erf_as (gelu's erf as the JAX kernel's Abramowitz & Stegun 7.1.26 form,
with __frcp_rn and __expf, instead of erff); two diagnostics that do not
compute the block: nogelu (fc1's epilogue without the gelu) and nostore (no
product stores its tile).

Run from the repository root on an H100:
python3 probes/h100_swin_block/variants.py"""
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs                                          # noqa: E402
from yolact_minimal_torch.ops import _build                      # noqa: E402
from yolact_minimal_torch.ops import swin_block as swin_ops      # noqa: E402
from yolact_minimal_torch.ops.swin_block import swin_block, swin_block_plain   # noqa: E402

FC1 = 'template <> struct GemmShape<FLAT_C, 4 * FLAT_C> : GemmShapeOf<128, 3, 2> {};'
PRIMARY = 'template <int K, int N> struct GemmShape : GemmShapeOf<192, 4, 1> {};'
GELU = 'pack_bf16(gelu_erf(a0 + b.x), gelu_erf(a1 + b.y))'
ERF_AS = '''__device__ __forceinline__ float gelu_as(float v) {
  const float ax = fabsf(v * 0.70710678118654752f);
  const float t = __frcp_rn(fmaf(0.3275911f, ax, 1.0f));
  const float poly = ((((1.061405429f * t - 1.453152027f) * t + 1.421413741f) * t -
                       0.284496736f) * t + 0.254829592f) * t;
  const float e = 1.0f - poly * __expf(-ax * ax);
  return v * 0.5f * (1.0f + copysignf(e, v));
}
'''
DIAGNOSTICS = ('nogelu', 'nostore')
# The wrapper's copy of each copy's product shapes (ops/swin_block.py::
# GEMM_SHAPES), from which it computes the grids it passes.
BASE_SHAPES = dict(swin_ops.GEMM_SHAPES)
SHAPES = {'fc1_one': {'fc1': (192, 4, 1)}, 'fc1_192x3': {'fc1': (192, 3, 1)},
          'slots5': {'proj': (192, 5, 1), 'fc2': (192, 5, 1)}}


def variants(src):
    def sub(a, b):
        if a not in src:
            raise SystemExit(f'variants.py: the source no longer holds {a!r}')
        return src.replace(a, b)
    return {
        'base': src,
        'fc1_one': sub(FC1, ''),
        'fc1_192x3': sub(FC1, FC1.replace('<128, 3, 2>', '<192, 3, 1>')),
        'slots5': sub(PRIMARY, PRIMARY.replace('<192, 4, 1>', '<192, 5, 1>')),
        'erf_as': sub(GELU, GELU.replace('gelu_erf', 'gelu_as')).replace(
            '// LN1(x) * rowmask, rounded,', ERF_AS + '\n// LN1(x) * rowmask, rounded,'),
        'nogelu': sub(GELU, 'pack_bf16(a0 + b.x, a1 + b.y)'),
        'nostore': sub('if (row < rows) epi(row', 'if (row < rows - (1 << 30)) epi(row'),
    }


def build(out):
    """Each copy's source, the headers beside it, and its library, in `out`;
    the libraries, loaded."""
    csrc = ROOT / 'yolact_minimal_torch' / 'csrc'
    for h in csrc.glob('*.cuh'):
        (out / h.name).write_text(h.read_text())
    procs = {}
    for name, text in variants((csrc / 'swin_block.cu').read_text()).items():
        (out / f'{name}.cu').write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, '-o', str(out / f'{name}.so'),
             str(out / f'{name}.cu')], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f'nvcc failed for {name}:\n{log}')
        libs[name] = ctypes.CDLL(str(out / f'{name}.so'))
    return libs


def main():
    with tempfile.TemporaryDirectory(prefix='swin_block_variants_') as tmp:
        libs = build(Path(tmp))
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device('cuda')
    stage = 3
    bnw, nw, c, heads, _ = cs.SWIN_STAGES[stage]
    p = cs._block_inputs(dev, torch.Generator(device=dev).manual_seed(6), stage)
    bf = torch.bfloat16
    args = (p['x'].to(bf), p['rowmask'][3], *p['ln1'], p['qkv'][0].to(bf), p['qkv'][1],
            p['bias'].to(bf), p['region'], p['proj'][0].to(bf), p['proj'][1], *p['ln2'],
            p['fc1'][0].to(bf), p['fc1'][1], p['fc2'][0].to(bf), p['fc2'][1], heads)
    ref = swin_block_plain(*args)
    bad = []
    for name in list(libs) + list(libs)[::-1]:
        _build._loaded['swin_block'] = libs[name]
        swin_ops.GEMM_SHAPES = {**BASE_SHAPES, **SHAPES.get(name, {})}
        swin_ops.kernel_geometry.cache_clear()
        compiled = {k: a['shape'] for k, a in swin_ops.kernel_attributes(c).items()}
        if compiled != swin_ops.launch_shapes(c):
            raise SystemExit(f'{name}: compiled shapes {compiled}, the wrapper\'s '
                             f'{swin_ops.launch_shapes(c)}')
        got = swin_block(*args)
        torch.cuda.synchronize()
        _, rel = cs._rel_err(got, ref)
        equal = (got == ref).float().mean().item()
        if name not in DIAGNOSTICS and rel > cs.SWIN_BF16_REL_TOL:
            bad.append(name)
        ms = cs._flat_launch_device_ms(lambda: swin_block(*args))
        print(f'{name:10s} rel {rel:.4g} equal {equal:.4f} device {sum(ms.values()):.4f} ms: '
              + ' '.join(f'{k} {v:.4f}' for k, v in ms.items()), flush=True)
    if bad:
        raise SystemExit(f'copies that differ from the plain version: {bad}')


if __name__ == '__main__':
    main()
