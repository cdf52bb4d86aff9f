"""Entry: `Detector.detect_fixed`, one caller in a closed loop, on a swin
whose window, widths and depths come from the configuration file's `model`
group (Swin-L at window 12).

It is the detect entry (`entries/detect.py`) on `reference/yolact_window.py`
in place of `reference/yolact.py`: the weights are that reference's plan
drawn by the same rule (`core/weights_window.py`), the operations a call
are counted on it, and it judges the network's outputs; the slate and masks
are judged by the detect entry's `post_gap`. The loop, the sampled calls,
the spans and the per-layer readers' context are the detect entry's.
"""
from __future__ import annotations

from functools import lru_cache
import json

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.core import judge, program, traffic, weights_window
from benchmark.core.window import Marks, sync
from benchmark.entries import detect
from benchmark.entries.detect import post_gap
from benchmark.reference import ops, postprocess
from benchmark.reference.yolact_window import Yolact as Reference
from benchmark.roofline import kernels


@lru_cache(maxsize=None)
def _forward_flops(spec_json: str, batch: int, size: int) -> int:
    with torch.device('meta'):
        model = Reference(json.loads(spec_json)).eval()
        img = torch.empty(batch, size, size, 3)
    counter = FlopCounterMode(display=False)
    with counter:
        model(img)
    return int(counter.get_total_flops())


def forward_flops(model_spec: dict, batch: int, size: int) -> int:
    """The eval forward's operations (a multiply-add counts two), counted by
    FlopCounterMode on the reference on the meta device."""
    return _forward_flops(json.dumps(model_spec, sort_keys=True), batch, size)


class Session(detect.Session):
    def __init__(self, cell, seed: int, device: torch.device):
        self.marks = Marks()
        from yolact_minimal_torch.pipeline import Detector
        self.marks('import the program')
        self.cell, self.device = cell, device
        t = cell.traffic
        self.batch, self.size = cell.size('batch'), cell.size('img_size')
        cfg = program.config(cell, 'detect', nms_score_thre=t['nms_score_thre'])
        self.sd = weights_window.make_state_dict(cell.config['model'], False, seed, device)
        self.marks('weights')
        self.det = Detector(cfg, state_dict=self.sd, device=device)
        self.marks('Detector')
        self.pool = traffic.detect_pool(t, self.batch, self.size, seed + 1, device)
        self.marks('inputs')
        rng = np.random.default_rng(seed)
        self.sample = set(rng.choice(t['sample_within'], t['sample_calls'], replace=False).tolist())
        self.kept, self._keep, self._net = {}, False, None
        self._hook = self.det.model.register_forward_hook(self._capture)
        for i in range(t['warmup_calls']):
            self.det.detect_fixed(self.pool[i % len(self.pool)], self.size)
            sync(device)
            self.marks(f'warm-up call {i + 1}')

    def reader_context(self, calls: int, window_calls: int, window_s: float) -> dict:
        conf = self.cell.config
        return dict(calls=calls, window_calls=window_calls, window_s=window_s,
                    batch=self.batch, img_size=self.size,
                    slots=conf['postprocess']['max_detections'],
                    flops_per_call=forward_flops(conf['model'], self.batch, self.size),
                    stages=kernels.swin_stages(conf['model'], self.batch, self.size))

    def judge(self) -> dict:
        conf = self.cell.config
        ref = Reference(conf['model']).to(self.device).eval()
        ref.load_state_dict(self.sd)
        anchors = postprocess.anchors(self.size, conf['model']['aspect_ratios'],
                                      conf['model']['base_scales']).to(self.device)
        rows = self.cell.traffic['reference_rows']
        if self.sample - set(self.kept):
            return {'net_gap': float('inf'), 'post_gap': float('inf')}   # an answer never came
        out = {'net_gap': 0.0, 'post_gap': 0.0}
        with torch.no_grad(), ops.exact_float32():
            for b, net, dets, masks in self.kept.values():
                images = torch.from_numpy(self.pool[b]).to(self.device)
                want = [torch.cat(p) for p in zip(*(ref(images[r:r + rows])
                                                    for r in range(0, len(images), rows)))]
                out['net_gap'] = max(out['net_gap'], max(
                    judge.rel_l2(g, w) for g, w in zip(net, want)))
                out['post_gap'] = max(out['post_gap'], post_gap(
                    dets, masks, [t.float() for t in net], anchors, self.cell, rows))
        return out


def setup(cell, seed: int, device: torch.device) -> Session:
    return Session(cell, seed, device)
