"""YOLACT (Bolya et al., 2019) on a ResNet-50 or Swin-T backbone.

FPN: 1x1 laterals on C3..C5 to 256 channels, top-down sums with bilinear
upsampling (align_corners=False), a 3x3 convolution and ReLU on P3..P5, two
stride-2 3x3 convolutions with ReLU for P6 and P7. ProtoNet on P3: three
3x3 convolutions with ReLU, a 2x bilinear upsampling (align_corners=True),
a 3x3 convolution with ReLU and a 1x1 to 32 prototypes with ReLU. One head
shared by the five levels: a 3x3 convolution with ReLU, then 3x3
convolutions to the boxes, the class scores and the tanh mask coefficients
of each anchor, anchors ordered by row, column and ratio. In eval the class
scores go through a softmax; in training the model also returns the
semantic head's logits (1x1 on P3 to the classes without the background).
Outputs are laid out as (class [B, A, C], box [B, A, 4], coef [B, A, 32],
proto [B, S/4, S/4, 32][, seg [B, S/8, S/8, C-1]]).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.layers import Conv, ConvReLU
from benchmark.reference.resnet import ResNet
from benchmark.reference.swin import SwinT

COEF = 32


def _up(x, h, w, align_corners=False):
    return F.interpolate(x, size=(h, w), mode='bilinear', align_corners=align_corners)


class FPN(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.lat_layers = nn.ModuleList(Conv(c, 256, 1) for c in channels)
        self.pred_layers = nn.ModuleList(ConvReLU(256, 256) for _ in range(3))
        self.downsample_layers = nn.ModuleList(ConvReLU(256, 256, stride=2) for _ in range(2))

    def forward(self, c3, c4, c5):
        p5 = self.lat_layers[2](c5)
        p4 = self.lat_layers[1](c4) + _up(p5, *c4.shape[-2:])
        p3 = self.lat_layers[0](c3) + _up(p4, *c3.shape[-2:])
        p3, p4, p5 = (layer(p) for layer, p in zip(self.pred_layers, (p3, p4, p5)))
        p6 = self.downsample_layers[0](p5)
        return p3, p4, p5, p6, self.downsample_layers[1](p6)


class ProtoNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.proto1 = nn.Sequential(*ConvReLU(256, 256), *ConvReLU(256, 256), *ConvReLU(256, 256))
        self.proto2 = nn.Sequential(*ConvReLU(256, 256), *ConvReLU(256, COEF, k=1))

    def forward(self, x):
        x = self.proto1(x)
        return self.proto2(_up(x, 2 * x.shape[-2], 2 * x.shape[-1], align_corners=True))


class Head(nn.Module):
    def __init__(self, num_classes, ratios):
        super().__init__()
        self.num_classes = num_classes
        self.upfeature = ConvReLU(256, 256)
        self.bbox_layer = Conv(256, ratios * 4, 3, padding=1)
        self.conf_layer = Conv(256, ratios * num_classes, 3, padding=1)
        self.coef_layer = nn.Sequential(Conv(256, ratios * COEF, 3, padding=1), nn.Tanh())

    def forward(self, x):
        b = x.shape[0]
        x = self.upfeature(x)
        flat = lambda t, n: t.permute(0, 2, 3, 1).reshape(b, -1, n)
        return (flat(self.conf_layer(x), self.num_classes), flat(self.bbox_layer(x), 4),
                flat(self.coef_layer(x), COEF))


class Yolact(nn.Module):
    """Built from a configuration file's `model` group."""

    def __init__(self, model: dict, train_mode: bool = False):
        super().__init__()
        self.train_mode = train_mode
        bb = model['backbone']
        if bb['kind'] == 'resnet':
            self.backbone = ResNet(bb['depths'])
            self.fpn = FPN([256 * 2 ** i for i in (1, 2, 3)])
        elif bb['kind'] == 'swin':
            self.backbone = SwinT(bb['embed_dim'], bb['depths'], bb['num_heads'],
                                  bb['patch_size'], bb['drop_path_rate'])
            self.fpn = FPN([bb['embed_dim'] * 2 ** i for i in (1, 2, 3)])
        else:
            raise ValueError(f'unknown backbone kind {bb["kind"]!r}')
        self.proto_net = ProtoNet()
        self.prediction_layers = Head(model['num_classes'], len(model['aspect_ratios']))
        if train_mode:
            self.semantic_seg_conv = Conv(256, model['num_classes'] - 1, 1)

    def forward(self, img, generator=None):
        """img [B, S, S, 3] normalized."""
        if isinstance(self.backbone, SwinT):
            c3, c4, c5 = (t.permute(0, 3, 1, 2) for t in self.backbone(img, generator)[1:])
        else:
            c3, c4, c5 = self.backbone(img.permute(0, 3, 1, 2))[1:]
        levels = self.fpn(c3, c4, c5)
        proto = self.proto_net(levels[0]).permute(0, 2, 3, 1)
        heads = [self.prediction_layers(p) for p in levels]
        conf, box, coef = (torch.cat([h[i] for h in heads], dim=1) for i in range(3))
        if self.train_mode:
            seg = self.semantic_seg_conv(levels[0]).permute(0, 2, 3, 1)
            return conf, box, coef, proto, seg
        return torch.softmax(conf, dim=-1), box, coef, proto
