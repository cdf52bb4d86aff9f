"""Export CLI: a checkpoint -> a standalone `torch.export` artifact (.pt2).

    python -m yolact_minimal_torch.export --weight W [--cfg NAME] [--img_size 544] \
        [--batch 1] [--out PATH] [--device cuda|cpu]

The weight is a `.ckpt` the JAX package wrote or a reference-format `.pth`
state_dict; the config comes from its name unless --cfg gives it. Without
--out the artifact is the weight's path with `.pt2`. The export prints
`Export parity check passed.` when the reloaded artifact reproduces the live
forward (deploy.py). `detect_with_export.py` runs the artifact.
"""
from __future__ import annotations

import argparse
import time

from yolact_minimal_torch.config import cfg_name_from_weight, get_config
from yolact_minimal_torch.deploy import export_model
from yolact_minimal_torch.utils.checkpoint import load_weights_auto
from yolact_minimal_torch.utils.device import resolve_device


def main(argv=None):
    p = argparse.ArgumentParser(description='YOLACT export (PyTorch/CUDA port)')
    p.add_argument('--weight', type=str, required=True)
    p.add_argument('--cfg', type=str, default=None)
    p.add_argument('--img_size', type=int, default=544)
    p.add_argument('--batch', type=int, default=1,
                   help='Batch size fixed in the artifact (the driver pads the last chunk).')
    p.add_argument('--out', type=str, default=None)
    p.add_argument('--device', type=str, default='cuda', choices=('cuda', 'cpu'))
    args = p.parse_args(argv)

    resolve_device(args.device)
    cfg = get_config(args.cfg or cfg_name_from_weight(args.weight), mode='val',
                     img_size=args.img_size)
    out = args.out or args.weight.rsplit('.', 1)[0] + '.pt2'
    t0 = time.perf_counter()
    export_model(cfg, load_weights_auto(args.weight), out, batch=args.batch,
                 device=args.device)
    print(f'Exported to {out} in {time.perf_counter() - t0:.2f} s')


if __name__ == '__main__':
    main()
