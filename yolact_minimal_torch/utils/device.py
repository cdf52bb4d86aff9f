"""The device an entry point runs on: the card unless the caller asks for
the CPU, and never the CPU in the card's place."""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """torch.device of `device`; raises for a CUDA device without a card."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('CUDA is not available; pass device="cpu" to run '
                           'on the CPU')
    return device
