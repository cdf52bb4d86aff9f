"""Entry: `train_state.train_step`, one training job in a closed loop.

Set-up makes the training state once (the benchmark's weights, the
program's optimizer), drives it through its first steps with the window's
own call on distinct batches of the traffic's pool, and hands that same
state to the window, which cycles the pool. Every call passes the batch's
lincomb priorities, so that the subsample is drawn by the benchmark.

The reference follows the first three steps from the same weights and
batches: the four losses of each, the first gradient (worked out from the
program's optimizer state after step 1) and the parameters' change after
step 3, each leaf's norm against the reference's. Leaves whose reference
gradient is under a thousandth of the median leaf's, and inside a leaf the
elements whose reference gradient is under a thousandth of the leaf's
median element (the key third of a fused qkv bias, which softmax leaves
without a gradient), are nought to rounding: Adam moves them by round-off
alone, so they are left out of both norms. Stochastic depth draws
from the program's documented generator of a step, seeded (seed << 32) +
step on the device, in forward order; the reference seeds its own alike.
"""
from __future__ import annotations

import torch

from benchmark.core import judge, program, traffic, weights
from benchmark.core.window import Marks, sync
from benchmark.reference import ops, optim, postprocess
from benchmark.reference.losses import losses as reference_losses
from benchmark.reference.yolact import Yolact as Reference
from benchmark.roofline import flops

FOLLOWED = 3
_GT_KEYS = ('boxes', 'labels', 'valid', 'masks_proto', 'masks_seg')


class Session:
    def __init__(self, cell, seed: int, device: torch.device):
        self.marks = Marks()
        from yolact_minimal_torch.train_state import create_train_state, train_step
        self.marks('import the program')
        self.cell, self.device = cell, device
        self._step = train_step
        t, conf = cell.traffic, cell.config
        self.batch, self.size = cell.size('batch'), cell.size('img_size')
        cfg = program.config(cell, 'train')
        self.train_seed = seed % 2 ** 31
        self.sd = weights.make_state_dict(conf['model'], True, seed, device, t.get('weights'))
        self.marks('weights')
        self.state = create_train_state(cfg, device, seed=self.train_seed, state_dict=self.sd)
        self.marks('create_train_state')
        n_anchors = len(postprocess.anchors(self.size, conf['model']['aspect_ratios'],
                                            conf['model']['base_scales']))
        self.pool = traffic.train_pool(t, self.batch, self.size, conf['train']['max_gt'],
                                       conf['model']['num_classes'], n_anchors, seed + 1, device)
        self.marks('inputs')
        if len(self.pool) < FOLLOWED + t['warmup_calls']:
            raise ValueError('the pool must hold a distinct batch for every set-up step')
        named = dict(self.state.model.named_parameters())
        p0 = {k: p.detach().clone() for k, p in named.items()}
        self.losses = [self._run(0)]
        sync(device)
        self.marks('step 1')
        self.grad1 = self._first_gradient(named, p0)
        self.losses += [self._run(k) for k in range(1, FOLLOWED)]
        self.change = {k: p.detach() - p0[k] for k, p in named.items()}
        del p0
        for k in range(FOLLOWED, FOLLOWED + t['warmup_calls']):
            self._run(k)
        self.offset = FOLLOWED + t['warmup_calls']
        sync(device)
        self.marks('followed steps and warm-up')

    def _run(self, k: int):
        b = self.pool[k % len(self.pool)]
        batch = {key: v for key, v in b.items() if key != 'priorities'}
        return self._step(self.state, batch, priorities=b['priorities'])

    def _first_gradient(self, named, p0):
        """The gradient of step 1 as the optimizer got it, from its state:
        SGD's buffer is g + wd * w; AdamW's first moment is (1 - b1) g."""
        opt, train = self.state.optimizer, self.cell.config['train']
        out = {}
        for k, p in named.items():
            st = opt.state.get(p, {})
            if train['optimizer'] == 'sgd' and 'momentum_buffer' in st:
                out[k] = st['momentum_buffer'] - train['weight_decay'] * p0[k]
            elif train['optimizer'] == 'adamw' and 'exp_avg' in st:
                out[k] = st['exp_avg'] / 0.1
            else:
                out[k] = torch.zeros_like(p)
        return {k: v.detach().clone() for k, v in out.items()}

    def call(self, i: int) -> None:
        self._run(self.offset + i)

    def end_to_end(self, lat, window_s: float) -> dict:
        return {'train_img_per_s': len(lat) * self.batch / window_s}

    def span_modules(self):
        model = self.state.model
        return [(model, 'bench.forward'), (model.backbone, 'bench.backbone')]

    def reader_context(self, calls: int, window_calls: int, window_s: float) -> dict:
        conf = self.cell.config
        return dict(calls=calls, window_calls=window_calls, window_s=window_s,
                    batch=self.batch, img_size=self.size,
                    flops_per_call=flops.train_step(conf['model'], self.batch, self.size))

    def release(self) -> None:
        self.losses = [[float(x) for x in l] for l in self.losses]
        del self.state
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    # --- the comparison -------------------------------------------------------------

    def reference_steps(self):
        """The reference's (losses of each step, first gradient, change) over
        the first FOLLOWED batches; gradient and change by leaf name."""
        conf = self.cell.config
        ref = Reference(conf['model'], train_mode=True).to(self.device).train()
        ref.load_state_dict(self.sd)
        anchors = postprocess.anchors(self.size, conf['model']['aspect_ratios'],
                                      conf['model']['base_scales']).to(self.device)
        named = dict(ref.named_parameters())
        p0 = {k: p.detach().clone() for k, p in named.items()}
        opt = optim.Optimizer(conf['train'], named.values())
        out_losses, grad1 = [], None
        with ops.exact_float32():
            for k in range(FOLLOWED):
                b = self.pool[k]
                gt = {key: torch.from_numpy(b[key]).to(self.device) for key in _GT_KEYS}
                image = torch.from_numpy(b['image']).to(self.device)
                gen = torch.Generator(device=self.device).manual_seed((self.train_seed << 32) + k)
                outputs = ref(image, gen)
                parts = reference_losses(conf['train'], outputs, gt, anchors, b['priorities'])
                for p in named.values():
                    p.grad = None
                sum(parts).backward()
                out_losses.append([float(x.detach()) for x in parts])
                if k == 0:
                    grad1 = {n: p.grad.detach().clone() for n, p in named.items()}
                opt.step(optim.lr_at(conf['train'], self.batch, k))
        change = {n: p.detach() - p0[n] for n, p in named.items()}
        return out_losses, grad1, change

    def judge(self) -> dict:
        ref_losses, ref_grad, ref_change = self.reference_steps()
        return compare(self.losses, self.grad1, self.change, ref_losses, ref_grad, ref_change)


def compare(losses, grad1, change, ref_losses, ref_grad, ref_change) -> dict:
    """Losses, first gradients and changes (by leaf name) of the judged
    side against the reference's -> the numbers a cell may compare: the
    worst loss of the followed steps; the worst leaf's gap of the first
    gradient and of the change; the median leaf's gap of the first
    gradient."""
    rel = lambda g, r: abs(g - r) / max(abs(r), 1e-30)
    keep = {k: judge.moving_elements(g) for k, g in ref_grad.items()}
    norms = lambda d: {k: float(v[keep[k]].double().norm()) for k, v in d.items()}
    ref_g, ref_c = norms(ref_grad), norms(ref_change)
    got_g, got_c = norms(grad1), norms(change)
    leaves = judge.moving_leaves(ref_g)
    return {'loss_gap': max(rel(g, r) for gs, rs in zip(losses, ref_losses)
                            for g, r in zip(gs, rs)),
            'grad_gap': judge.worst_leaf_gap(got_g, ref_g, leaves),
            'update_gap': judge.worst_leaf_gap(got_c, ref_c, leaves),
            'grad_median_gap': judge.median_leaf_gap(got_g, ref_g, leaves)}


def setup(cell, seed: int, device: torch.device) -> Session:
    return Session(cell, seed, device)
