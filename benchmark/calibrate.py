"""Readings that the limits of a cell's comparison are set from, on the card
in one process: the program's numbers on many seeds (short windows), the
control's (the reference in fp8 in the program's place) and each planted
fault's, one JSON line each.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 --faults half_batch,altered_answer --seconds 2

The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from benchmark import faults  # noqa: E402
from benchmark.core import cell as cells, judge  # noqa: E402
from benchmark.core.run import run_cell  # noqa: E402
from benchmark.reference import ops, postprocess  # noqa: E402
from benchmark.reference.yolact import Yolact  # noqa: E402


def control_detect(cell, seed, device) -> dict:
    """The control in the program's place, on the batches a run with this
    seed would sample: the network in fp8 (the program states bf16) and the
    postprocess and masks in bf16 (the program's are float32), judged as a
    run judges the program."""
    import numpy as np
    from benchmark.core import traffic, weights
    from benchmark.entries.detect import post_gap
    t, post = cell.traffic, cell.config['postprocess']
    size, batch = cell.size('img_size'), cell.size('batch')
    sd = weights.make_state_dict(cell.config['model'], False, seed, device)
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


def control_train(cell, seed, device, kind='fp8') -> dict:
    """The reference in `kind` against the float32 one over the followed
    steps: the control (fp8), or a witness of bf16 rounding alone."""
    from benchmark.entries import train
    session = cell.entry.setup(cell, seed, device)
    session.release()
    ref = session.reference_steps()
    with ops.lower_precision(kind):
        low = session.reference_steps()
    return train.compare(low[0], low[1], low[2], *ref)


def diagnose_train(cell, seed, device) -> dict:
    """The worst leaves of the program's first gradient and change, with
    how much of each leaf's reference gradient is nought to rounding."""
    session = cell.entry.setup(cell, seed, device)
    grad, change = dict(session.grad1), dict(session.change)
    session.release()
    _, rgrad, rchange = session.reference_steps()
    gn, cn = judge.leaf_norms(rgrad), judge.leaf_norms(rchange)
    med_g, med_c = judge.median(gn.values()), judge.median(cn.values())
    rows = []
    for k in rgrad:
        pg, pc = float(grad[k].double().norm()), float(change[k].double().norm())
        g = rgrad[k].abs().flatten().double()
        tiny = g < 1e-3 * float(g.median()) if g.numel() > 1 else g < 0
        rows.append(dict(leaf=k, numel=g.numel(),
                         update=abs(pc - cn[k]) / max(cn[k], med_c),
                         grad=abs(pg - gn[k]) / max(gn[k], med_g),
                         grad_ref=gn[k], change_ref=cn[k], change_prog=pc,
                         tiny_share=float(tiny.float().mean()),
                         change_prog_tiny=float(change[k].flatten()[tiny].double().norm()),
                         change_ref_tiny=float(rchange[k].flatten()[tiny].double().norm())))
    rows.sort(key=lambda r: -r['update'])
    return {'median_grad': med_g, 'median_change': med_c, 'worst_update': rows[:6],
            'worst_grad': sorted(rows, key=lambda r: -r['grad'])[:4]}


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', default='')
    p.add_argument('--control-seeds', default='')
    p.add_argument('--faults', default='')
    p.add_argument('--fault-seeds', default='')
    p.add_argument('--diagnose-seeds', default='')
    p.add_argument('--witness-seeds', default='')
    p.add_argument('--seconds', type=float, default=2.0)
    args = p.parse_args()
    seeds = lambda s: [int(x) for x in s.split(',') if x]
    device = torch.device('cuda', 0)
    cell = cells.load_cell(args.workload)
    entry = cell.traffic['entry']

    def emit(kind, seed, values, **extra):
        print(json.dumps(dict(kind=kind, workload=cell.name, seed=seed, values=values, **extra)),
              flush=True)

    every = {'detect': ('net_gap', 'post_gap'),
             'train': ('loss_gap', 'grad_gap', 'update_gap', 'grad_median_gap')}[entry]
    cell.limits = {'checks': {k: cell.limits['checks'].get(k, {'limit': float('inf')})
                              for k in every}}
    for seed in seeds(args.seeds):
        res, _ = run_cell(cell, seed, args.seconds, False, device, (time.perf_counter(), 0.0))
        emit('program', seed, {k: v['value'] for k, v in res['checks'].items()},
             metrics={k: v['value'] for k, v in res['metrics'].items()})
    for seed in seeds(args.control_seeds):
        values = (control_detect if entry == 'detect' else control_train)(cell, seed, device)
        emit('control', seed, values)
    for name in [f for f in args.faults.split(',') if f]:
        for seed in seeds(args.fault_seeds):
            with faults.FAULTS[name](entry):
                res, _ = run_cell(cell, seed, args.seconds, False, device,
                                  (time.perf_counter(), 0.0))
            emit(f'fault:{name}', seed, {k: v['value'] for k, v in res['checks'].items()},
                 correct=res['correct'])
    for seed in seeds(args.witness_seeds):
        emit('witness:bf16-reference', seed, control_train(cell, seed, device, 'bf16'))
    for seed in seeds(args.diagnose_seeds):
        emit('diagnose', seed, diagnose_train(cell, seed, device))


if __name__ == '__main__':
    main()
