"""The plain (no remat) train steps through the remat-aware BatchNorm2d,
ResNet and SwinStage against the parent's, in one call on one card: run this
once per checkout, in turns parent / change / change / parent, each in its
own process.

    python3 probes/h100_bn_remat/compare.py ROOT LABEL

ROOT is a checkout of the repository (this one, or a parent commit unpacked
with `git archive` into a directory that .gitignore lists); its package and
its chip_smoke.py are the ones measured. Prints the card's name and power
limit, then one line `RESULT {json}` with, for res50_coco and
swin_tiny_coco in bf16 at 544/b8 on custom_dataset/ (chip_smoke.py phase
8b/8c's measure, `phase_train_path`): ms a step (6 steps after 2 warm-up,
host clock to a synchronize), the device ms and busy share of one profiled
step, and peak device memory."""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(sys.argv[1]).resolve()
LABEL = sys.argv[2]
sys.path.insert(0, str(ROOT))
import torch                                                     # noqa: E402

import chip_smoke as cs                                          # noqa: E402

assert Path(cs.__file__).resolve().parent == ROOT, cs.__file__


def main():
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    dev = torch.device('cuda', 0)
    batches = cs._train_batches(cs.TRAIN_STEPS + 2)
    out = {}
    for name in ('res50_coco', 'swin_tiny_coco'):
        _, numbers = cs.phase_train_path(dev, name, 'bfloat16', batches, smi)
        out[name] = {k: numbers[k] for k in ('ms_per_step', 'device_ms_per_step', 'busy_share',
                                             'peak_gb')}
    print('RESULT ' + json.dumps(dict(label=LABEL, root=str(ROOT), card=smi, **out)))


if __name__ == '__main__':
    main()
