"""Entry: `Detector.detect_fixed`, one caller in a closed loop.

Each call hands the program one host batch of the traffic's pool (cycled)
and waits until its slate and masks are ready on the device. The call's
latency runs from its issue to that point. A forward hook keeps the
network's four outputs of the calls the seed samples; after the window the
reference judges them (its own network on the same images and weights),
and its own postprocess and mask finalize on those outputs judge the
program's slate and masks (`post_gap`).
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.core import judge, program, traffic, weights
from benchmark.core.window import Marks, sync
from benchmark.reference import ops, postprocess
from benchmark.reference.yolact import Yolact as Reference
from benchmark.roofline import flops, kernels


class Session:
    def __init__(self, cell, seed: int, device: torch.device):
        self.marks = Marks()
        from yolact_minimal_torch.pipeline import Detector
        self.marks('import the program')
        self.cell, self.device = cell, device
        t = cell.traffic
        self.batch, self.size = cell.size('batch'), cell.size('img_size')
        cfg = program.config(cell, 'detect', nms_score_thre=t['nms_score_thre'])
        self.sd = weights.make_state_dict(cell.config['model'], False, seed, device)
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

    def _capture(self, _module, _args, out):
        if self._keep:
            self._net = out

    def call(self, i: int) -> None:
        b = i % len(self.pool)
        self._keep = i in self.sample
        dets, masks = self.det.detect_fixed(self.pool[b], self.size)
        sync(self.device)
        if self._keep:
            self.kept[i] = (b, self._net, dets, masks)
            self._keep, self._net = False, None

    # --- what the window reports --------------------------------------------------

    def end_to_end(self, lat, window_s: float) -> dict:
        return {'detect_img_per_s': len(lat) * self.batch / window_s}

    def span_modules(self):
        model = self.det.model
        return ([(model, 'bench.forward'), (model.backbone, 'bench.backbone')] +
                [(stage, f'bench.stage{i}') for i, stage in enumerate(model.backbone.layers)])

    def reader_context(self, calls: int, window_calls: int, window_s: float) -> dict:
        conf = self.cell.config
        return dict(calls=calls, window_calls=window_calls, window_s=window_s,
                    batch=self.batch, img_size=self.size,
                    slots=conf['postprocess']['max_detections'],
                    flops_per_call=flops.forward(conf['model'], self.batch, self.size),
                    stages=kernels.swin_stages(conf['model'], self.batch, self.size))

    def release(self) -> None:
        self._hook.remove()
        del self.det
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    # --- the comparison -------------------------------------------------------------

    def judge(self) -> dict:
        conf = self.cell.config
        post = conf['postprocess']
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


def post_gap(slate, masks, net, anchors, cell, rows: int) -> float:
    """The judged slate and masks against the reference's postprocess and
    mask finalize on the same network outputs: the largest of the gaps of
    scores, boxes and coefficients over slots valid on both sides, 1 where a
    slot's validity or class differs, and for each mask pixel that differs
    its reference value's distance from the 0.5 threshold."""
    post, size = cell.config['postprocess'], cell.size('img_size')
    want = postprocess.fast_nms(*net[:3], anchors, cell.traffic['nms_score_thre'],
                                post['nms_iou_thre'], post['top_k'], post['max_detections'],
                                post['nms_pre_topk'])
    gap = 0.0
    if bool(((slate.valid != want.valid) | (want.valid & (slate.ids != want.ids))).any()):
        gap = 1.0
    both = slate.valid & want.valid
    for got, w in ((slate.scores, want.scores), (slate.boxes, want.boxes),
                   (slate.coefs, want.coefs)):
        diff = (got.float() - w).abs().reshape(*both.shape, -1).amax(-1)
        gap = max(gap, float(torch.where(both, diff, 0.0).max()))
    for r in range(0, len(masks), rows):
        part = postprocess.Slate(*(x[r:r + rows] for x in want))
        soft = postprocess.mask_values(net[3][r:r + rows], part, size, not post['no_crop'])
        wrong = (soft > 0.5) != masks[r:r + rows]
        if bool(wrong.any()):
            gap = max(gap, float((soft[wrong] - 0.5).abs().max()))
    return gap


def setup(cell, seed: int, device: torch.device) -> Session:
    return Session(cell, seed, device)
