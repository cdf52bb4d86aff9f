"""`calibrate.py` for cells of the `detect_window` entry, whose weights and
reference are `core/weights_window.py` and `reference/yolact_window.py`:
the program's readings on many seeds, the control's (that reference in fp8
in the program's place, the postprocess and masks in bf16) and each planted
fault's, one JSON line each.

    python3 benchmark/calibrate_window.py --workload swin_large_coco.detect_b16 \
        --seeds 1,2,3 --control-seeds 4,5,6 --faults half_batch,altered_answer \
        --fault-seeds 7,8 --seconds 2

The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import faults  # noqa: E402
from benchmark.core import cell as cells, judge, traffic, weights_window  # noqa: E402
from benchmark.core.run import run_cell  # noqa: E402
from benchmark.entries.detect import post_gap  # noqa: E402
from benchmark.reference import ops, postprocess  # noqa: E402
from benchmark.reference.yolact_window import Yolact  # noqa: E402

CHECKS = ('net_gap', 'post_gap')


def control_detect(cell, seed, device) -> dict:
    """As `calibrate.control_detect`, on this entry's weights and reference."""
    t, post = cell.traffic, cell.config['postprocess']
    size, batch = cell.size('img_size'), cell.size('batch')
    sd = weights_window.make_state_dict(cell.config['model'], False, seed, device)
    pool = traffic.detect_pool(t, batch, size, seed + 1, device)
    sample = np.random.default_rng(seed).choice(t['sample_within'], t['sample_calls'],
                                                 replace=False)
    ref = Yolact(cell.config['model']).to(device).eval()
    ref.load_state_dict(sd)
    anchors = postprocess.anchors(size, cell.config['model']['aspect_ratios'],
                                  cell.config['model']['base_scales']).to(device)
    rows = t['reference_rows']
    forward = lambda images: [torch.cat(p) for p in zip(*(ref(images[r:r + rows])
                                                          for r in range(0, batch, rows)))]
    out = {'net_gap': 0.0, 'post_gap': 0.0}
    with torch.no_grad(), ops.exact_float32():
        for i in sample:
            images = torch.from_numpy(pool[int(i) % len(pool)]).to(device)
            want = forward(images)
            with ops.lower_precision():
                net = forward(images)
            out['net_gap'] = max(out['net_gap'], max(judge.rel_l2(g, w) for g, w in zip(net, want)))
            low = [x.bfloat16() for x in net]
            slate = postprocess.fast_nms(*low[:3], anchors.bfloat16(), t['nms_score_thre'],
                                         post['nms_iou_thre'], post['top_k'],
                                         post['max_detections'], post['nms_pre_topk'])
            masks = torch.cat([postprocess.mask_finalize(
                low[3][r:r + rows], postprocess.Slate(*(x[r:r + rows] for x in slate)), size,
                not post['no_crop']) for r in range(0, batch, rows)])
            slate = postprocess.Slate(*(x.float() if x.is_floating_point() else x
                                        for x in slate))
            out['post_gap'] = max(out['post_gap'], post_gap(slate, masks, net, anchors, cell,
                                                            rows))
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', default='')
    p.add_argument('--control-seeds', default='')
    p.add_argument('--faults', default='')
    p.add_argument('--fault-seeds', default='')
    p.add_argument('--seconds', type=float, default=2.0)
    args = p.parse_args()
    seeds = lambda s: [int(x) for x in s.split(',') if x]
    device = torch.device('cuda', 0)
    cell = cells.load_cell(args.workload)
    cell.limits = {'checks': {k: cell.limits['checks'].get(k, {'limit': float('inf')})
                              for k in CHECKS}}

    def emit(kind, seed, values, **extra):
        print(json.dumps(dict(kind=kind, workload=cell.name, seed=seed, values=values, **extra)),
              flush=True)

    def run(seed):
        res, _ = run_cell(cell, seed, args.seconds, False, device, (time.perf_counter(), 0.0))
        return res

    for seed in seeds(args.seeds):
        res = run(seed)
        emit('program', seed, {k: v['value'] for k, v in res['checks'].items()},
             metrics={k: v['value'] for k, v in res['metrics'].items()})
    for seed in seeds(args.control_seeds):
        emit('control', seed, control_detect(cell, seed, device))
    for name in [f for f in args.faults.split(',') if f]:
        for seed in seeds(args.fault_seeds):
            with faults.FAULTS[name]('detect'):      # the faults of the detect path
                res = run(seed)
            emit(f'fault:{name}', seed, {k: v['value'] for k, v in res['checks'].items()},
                 correct=res['correct'])


if __name__ == '__main__':
    main()
