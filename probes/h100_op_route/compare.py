"""The swin kernels' route through registered operators (torch.library
custom ops, so that torch.export records them) against the route before it
(the wrappers calling the ctypes launch directly), in one call on one card:
run this once per checkout, in turns parent / change / change / parent, each
in its own process.

    python3 probes/h100_op_route/compare.py ROOT LABEL

ROOT is a checkout of the repository (this one, or a parent commit unpacked
with `git archive` into a directory that .gitignore lists); its package and
its chip_smoke.py are the ones measured. Prints the card's name and power
limit, then one line `RESULT {json}` with:
  - host_us: each swin wrapper's host time a call (window_attention,
    mlp_block, attn_block, swin_block) in bf16 at stage 3's widths on one
    image's windows (9 windows, 289 MLP rows, so that the device queue does
    not fill), the best of five batches of 200 calls;
  - img_s: swin_tiny_coco 544/b16 bf16 detect_fixed on the 'composed' and
    'mixed' paths (chip_smoke.py phase 4's measure: host clock, median of
    three windows of 10 calls);
  - stage_ms: each swin stage's blocks alone in the 'composed' form (phase
    7's measure: CUDA events, median of 10);
  - train_ms: swin_tiny_coco's bf16 train step at 544/b8 (phase 8c's
    measure: 6 steps after 2 warm-up, host clock to a synchronize)."""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(sys.argv[1]).resolve()
LABEL = sys.argv[2]
sys.path.insert(0, str(ROOT))
import torch                                                     # noqa: E402

import chip_smoke as cs                                          # noqa: E402
from yolact_minimal_torch.ops.attn_block import attn_block       # noqa: E402
from yolact_minimal_torch.ops.swin_block import swin_block       # noqa: E402
from yolact_minimal_torch.ops.swin_mlp import mlp_block          # noqa: E402
from yolact_minimal_torch.ops.window_attention import window_attention   # noqa: E402

assert Path(cs.__file__).resolve().parent == ROOT, cs.__file__


def host_us(f, n=200):
    for _ in range(5):
        f()
    torch.cuda.synchronize()
    best = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            f()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        best.append((t1 - t0) / n * 1e6)
    return min(best)


def main():
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    dev = torch.device('cuda', 0)
    cs.phase_build()
    result = dict(label=LABEL, root=str(ROOT), card=smi)

    bf = torch.bfloat16
    p = cs._block_inputs(dev, torch.Generator(device=dev).manual_seed(0), 3)
    _, nw, c, heads, _ = cs.SWIN_STAGES[3]
    x = p['x'][:nw].to(bf).contiguous()
    region = p['region']
    bias = p['bias'].to(bf)
    wqkv, bqkv = p['qkv'][0].to(bf), p['qkv'][1]
    wproj, bproj = p['proj'][0].to(bf), p['proj'][1]
    k1, b1, k2, b2 = p['fc1'][0].to(bf), p['fc1'][1], p['fc2'][0].to(bf), p['fc2'][1]
    rows = x.reshape(-1, c)[:289].contiguous()
    qkv = torch.randn(nw, 49, 3 * c, device=dev).to(bf)
    with torch.inference_mode():
        result['host_us'] = {
            'window_attention': host_us(lambda: window_attention(qkv, bias, region, heads)),
            'mlp_block': host_us(lambda: mlp_block(rows, *p['ln2'], k1, b1, k2, b2)),
            'attn_block': host_us(lambda: attn_block(x, wqkv, bqkv, bias, region, wproj, bproj,
                                                     heads)),
            'swin_block': host_us(lambda: swin_block(x, p['rowmask'][3], *p['ln1'], wqkv, bqkv,
                                                     bias, region, wproj, bproj, *p['ln2'], k1,
                                                     b1, k2, b2, heads))}
    del p, x, qkv, rows

    img_s, det, images = {}, None, None
    for form in ('composed', 'mixed'):
        _, det, images, host_ms = cs.phase_main_path(dev, 'swin_tiny_coco', form, det, images)
        img_s[form] = cs.BATCH / host_ms * 1e3
    result['img_s'] = img_s
    backbone = det.model.backbone
    backbone.set_block_forms('composed')
    g = torch.Generator(device=dev).manual_seed(7)
    stage_ms = []
    with torch.inference_mode():
        for stage, (side, _), (_, _, c, _, _) in zip(backbone.layers, cs.SWIN_MAPS,
                                                      cs.SWIN_STAGES):
            xs = torch.randn(cs.BATCH, side, side, c, device=dev, generator=g).to(backbone.dtype)

            def blocks(xs=xs, stage=stage):
                for block in stage.blocks:
                    xs = block(xs)
                return xs
            stage_ms.append(cs._time_ms(blocks, warmup=2, iters=10))
    result['stage_ms'] = stage_ms
    del det, images, backbone
    torch.cuda.empty_cache()

    batches = cs._train_batches(cs.TRAIN_STEPS + 2)
    _, numbers = cs.phase_train_path(dev, 'swin_tiny_coco', 'bfloat16', batches, smi)
    result['train_ms'] = numbers['ms_per_step']
    print('RESULT ' + json.dumps(result))


if __name__ == '__main__':
    main()
