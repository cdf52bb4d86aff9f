"""Training CLI of the port.

    python -m yolact_minimal_torch.train --cfg res50_custom --img_size 544 --train_bs 8 \\
        [--max_steps N] [--device cuda|cpu] [--compute_dtype float32|bfloat16] [--resume F.ckpt]
        [--backbone_weight B.pth] [--remat] [--traditional_nms]

The JAX package's `train.py` loop on one device: batches from `TrainLoader`
(worker processes), one `train_step` each, a log line every 10 steps
(l_class, l_box, l_mask, l_semantic, t_t, t_d, t_step, ETA), in-training
validation every --val_interval steps through `eval.evaluate` with the best
checkpoint kept by mask mAP, `latest_{cfg}_{step}.ckpt` with the optimizer
state and the step at the end and on Ctrl-C, and `--resume` from such a
file (the JAX package's or the port's). A non-finite loss saves
`latest_{cfg}_nan_{step}.ckpt` and raises. TensorBoard logs where
tensorboardX or torch.utils.tensorboard imports. Runs on the card unless
`--device cpu`. Without --resume, training starts from the reference init
drawn from seed 0, as the JAX CLI's PRNGKey(0), with the backbone taken from
--backbone_weight (which must exist) or else from the config's default path
where that file exists. --remat recomputes each backbone block's forward in
the backward (models/yolact.py); --traditional_nms validates with greedy NMS
on the host.
"""
from __future__ import annotations

import argparse
import datetime
import os.path as osp
import time

import numpy as np
import torch

from yolact_minimal_torch.config import cfg_name_from_weight, get_config
from yolact_minimal_torch.data.augment import import_cv2
from yolact_minimal_torch.data.coco import COCODetection, TrainLoader
from yolact_minimal_torch.pipeline import Detector
from yolact_minimal_torch.train_state import (create_train_state, fast_forward_schedule,
                                              lr_schedule, opt_state_to_payload,
                                              restore_opt_state, train_step)
from yolact_minimal_torch.utils import timer
from yolact_minimal_torch.utils.checkpoint import (load_checkpoint, load_weights_auto,
                                                   save_best, save_latest, step_from_name)
from yolact_minimal_torch.utils.device import resolve_device
from yolact_minimal_torch.utils.weights import load_backbone_pth, to_jax_variables


def _tb_writer(cfg_name):
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return None
    return SummaryWriter(f'tensorboard_log/{cfg_name}')


def _variables(state, with_opt: bool) -> dict:
    """The JAX package's checkpoint payload of the state: params and
    batch_stats (None for swin), and for a latest checkpoint the optimizer
    state and the step."""
    v = to_jax_variables(state.model.state_dict())
    out = {'params': v['params'], 'batch_stats': v.get('batch_stats')}
    if with_opt:
        out.update(opt_state=opt_state_to_payload(state), step=int(state.step))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description='YOLACT training (PyTorch/CUDA port)')
    parser.add_argument('--cfg', default='res101_coco')
    parser.add_argument('--train_bs', type=int, default=8)
    parser.add_argument('--img_size', type=int, default=544)
    parser.add_argument('--resume', default=None, type=str)
    parser.add_argument('--backbone_weight', default=None, type=str,
                        help='Pretrained backbone .pth for init when not resuming (default: '
                             'the config\'s path, read if the file exists).')
    parser.add_argument('--val_interval', type=int, default=4000)
    parser.add_argument('--val_num', type=int, default=-1)
    parser.add_argument('--val_bs', type=int, default=None)
    parser.add_argument('--coco_api', action='store_true')
    parser.add_argument('--traditional_nms', action='store_true',
                        help='Validate with greedy per-class NMS on the host.')
    parser.add_argument('--num_workers', type=int, default=8)
    parser.add_argument('--compute_dtype', default='float32', choices=['float32', 'bfloat16'])
    parser.add_argument('--remat', action='store_true',
                        help='Recompute each backbone block in the backward pass (less '
                             'activation memory, one more forward of the backbone).')
    parser.add_argument('--max_steps', type=int, default=-1,
                        help='Stop early after this many steps.')
    parser.add_argument('--lr', type=float, default=None, help='Override the base learning rate.')
    parser.add_argument('--train_imgs', type=str, default=None)
    parser.add_argument('--train_ann', type=str, default=None)
    parser.add_argument('--val_imgs', type=str, default=None)
    parser.add_argument('--val_ann', type=str, default=None)
    parser.add_argument('--device', type=str, default='cuda', choices=('cuda', 'cpu'))
    args = parser.parse_args(argv)

    overrides = {k: v for k, v in (
        ('base_lr', args.lr), ('train_imgs', args.train_imgs),
        ('train_ann', args.train_ann), ('val_imgs', args.val_imgs),
        ('val_ann', args.val_ann), ('val_bs', args.val_bs)) if v is not None}
    cfg = get_config(args.cfg, mode='train', img_size=args.img_size, train_bs=args.train_bs,
                     val_interval=args.val_interval, val_num=args.val_num,
                     coco_api=args.coco_api, compute_dtype=args.compute_dtype,
                     remat=args.remat, traditional_nms=args.traditional_nms, **overrides)
    device = resolve_device(args.device)
    import_cv2()                        # the augmentation needs it: say so up front
    cfg.print_cfg()
    # float32 convolutions in float32, as the JAX package computes them
    torch.backends.cudnn.allow_tf32 = False

    start_step = 0
    state_dict = opt_payload = backbone = None
    if args.resume:
        # exact cfg-name equality: 'res50_coco' must not take a 'res50_coco_v2' weight
        assert cfg_name_from_weight(args.resume) == args.cfg, \
            'Resume weight is not compatible with current cfg.'
        state_dict = load_weights_auto(args.resume, include_semantic=True)
        if args.resume.endswith('.ckpt'):
            opt_payload = load_checkpoint(args.resume).get('opt_state')
        start_step = step_from_name(args.resume)
        print(f'Resumed from {args.resume} at step {start_step}.')
    else:
        # the pretrained-backbone init: required when --backbone_weight is
        # given, read from the config's default path only if it exists
        bw = args.backbone_weight or cfg.backbone_weight
        if args.backbone_weight and not osp.exists(bw):
            raise FileNotFoundError(f'--backbone_weight {bw!r} not found.')
        if bw and osp.exists(bw):
            backbone = load_backbone_pth(bw)
            print(f'\nBackbone is initiated with {bw}.\n')
        else:
            print(f'\nNo pretrained backbone at {bw!r}; training from random init.\n')
    state = create_train_state(cfg, device, state_dict=state_dict, step=start_step,
                               backbone=backbone)
    if opt_payload is not None:
        restore_opt_state(state, opt_payload)
        print('Optimizer state (momentum/moments + schedule) restored.')
    elif start_step:
        fast_forward_schedule(state, start_step)
    n_params = sum(p.numel() for p in state.model.parameters())
    print(f'Number of all parameters: {n_params}\n')

    dataset = COCODetection(cfg, mode='train')
    loader = TrainLoader(dataset, cfg, batch_size=cfg.train_bs,
                         num_workers=args.num_workers, seed=0)
    sched = lr_schedule(cfg)
    writer = _tb_writer(cfg.name)
    fence = torch.cuda.synchronize if device.type == 'cuda' else None

    step = start_step
    end_step = cfg.lr_steps[-1] if args.max_steps < 0 \
        else min(cfg.lr_steps[-1], start_step + args.max_steps)
    map_tables = []
    timer.reset()
    training, val_step, time_last = True, start_step, None
    detector_cache = {}

    def run_validation(step):
        from yolact_minimal_torch.eval import evaluate
        val_cfg = cfg.replace(mode='val')
        weights = {k: v for k, v in state.model.state_dict().items()
                   if not k.startswith('semantic_seg_conv.')}
        if 'det' not in detector_cache:
            detector_cache['det'] = Detector(val_cfg, weights, device=device)
        else:
            detector_cache['det'].model.load_state_dict(weights)
        table, box_row, mask_row = evaluate(detector_cache['det'], val_cfg, step=step,
                                            max_images=cfg.val_num)
        if table is not None:
            map_tables.append(table)
            if writer:
                writer.add_scalar('mAP/box_map', box_row[1], global_step=step)
                writer.add_scalar('mAP/mask_map', mask_row[1], global_step=step)
            save_best(_variables(state, with_opt=False), mask_row[1], cfg.name, step)

    def finish(step):
        save_latest(_variables(state, with_opt=True), cfg.name, step)
        print('\nValidation results during training:\n')
        for t in map_tables:
            print(t, '\n')

    try:
        while training:
            for batch in loader:
                with timer.counter('step', fence=fence):
                    losses = train_step(state, batch)

                now = time.time()
                if step > start_step and time_last is not None:
                    timer.add_batch_time(now - time_last)
                time_last = now

                if step % 10 == 0 and step != start_step:
                    l_c, l_b, l_m, l_s = (float(t) for t in losses)
                    # a non-finite loss means poisoned weights: keep them for
                    # a post-mortem and stop
                    if not np.isfinite(l_c + l_b + l_m + l_s):
                        save_latest(_variables(state, with_opt=True), cfg.name + '_nan', step)
                        raise FloatingPointError(f'Non-finite loss at step {step}: '
                                                 f'c={l_c} b={l_b} m={l_m} s={l_s}')
                    cur_lr = sched(step)
                    t_t, t_d, t_s = timer.get_times(['batch', 'data', 'step'])
                    eta = str(datetime.timedelta(seconds=int((end_step - step) * max(t_t, 1e-9))))
                    if writer:
                        for tag, v in (('class', l_c), ('box', l_b), ('mask', l_m),
                                       ('semantic', l_s), ('total', l_c + l_b + l_m + l_s)):
                            writer.add_scalar(f'loss/{tag}', v, global_step=step)
                    print(f'step: {step} | lr: {cur_lr:.2e} | l_class: {l_c:.3f} | '
                          f'l_box: {l_b:.3f} | l_mask: {l_m:.3f} | '
                          f'l_semantic: {l_s:.3f} | t_t: {t_t:.3f} | '
                          f't_d: {t_d:.3f} | t_step: {t_s:.3f} | ETA: {eta}', flush=True)

                if cfg.val_interval > 0 and step % cfg.val_interval == 0 and step != start_step:
                    val_step = step
                    run_validation(step)
                    timer.reset()

                if step == val_step + 1:
                    timer.start()

                step += 1
                if step >= end_step:
                    training = False
                    finish(step)
                    print('Training completed.')
                    break
    except KeyboardInterrupt:
        finish(step)
    finally:
        loader.close()


if __name__ == '__main__':
    main()
