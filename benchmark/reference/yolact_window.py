"""YOLACT (Bolya et al., 2019) on a Swin backbone whose window, widths and
depths come from the configuration file's `model` group
(`reference/swin_window.py`): the neck, ProtoNet and head of
`reference/yolact.py`, laid out and returned as there (the semantic head's
logits too in training). The forward runs with TF32 off; a backward of it
wants `ops.exact_float32()` around it too."""
from __future__ import annotations

import torch
import torch.nn as nn

from benchmark.reference import ops
from benchmark.reference.layers import Conv
from benchmark.reference.swin_window import Swin
from benchmark.reference.yolact import FPN, Head, ProtoNet


class Yolact(nn.Module):
    """Built from a configuration file's `model` group, whose backbone is a
    swin with a `window`."""

    def __init__(self, model: dict, train_mode: bool = False):
        super().__init__()
        self.train_mode = train_mode
        bb = model['backbone']
        if bb['kind'] != 'swin':
            raise ValueError(f'this reference takes a swin backbone, got {bb["kind"]!r}')
        self.backbone = Swin(bb['embed_dim'], bb['depths'], bb['num_heads'], bb['window'],
                             bb['patch_size'], bb['drop_path_rate'])
        self.fpn = FPN([bb['embed_dim'] * 2 ** i for i in (1, 2, 3)])
        self.proto_net = ProtoNet()
        self.prediction_layers = Head(model['num_classes'], len(model['aspect_ratios']))
        if train_mode:
            self.semantic_seg_conv = Conv(256, model['num_classes'] - 1, 1)

    def forward(self, img, generator=None):
        """img [B, S, S, 3] normalized."""
        with ops.exact_float32():
            c3, c4, c5 = (t.permute(0, 3, 1, 2) for t in self.backbone(img, generator)[1:])
            levels = self.fpn(c3, c4, c5)
            proto = self.proto_net(levels[0]).permute(0, 2, 3, 1)
            heads = [self.prediction_layers(p) for p in levels]
            conf, box, coef = (torch.cat([h[i] for h in heads], dim=1) for i in range(3))
            if self.train_mode:
                seg = self.semantic_seg_conv(levels[0]).permute(0, 2, 3, 1)
                return conf, box, coef, proto, seg
            return torch.softmax(conf, dim=-1), box, coef, proto
