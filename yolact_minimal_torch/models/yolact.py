"""YOLACT model assembly: backbone + FPN + ProtoNet + shared head.

NCHW inside, as PyTorch's convolutions prefer (the swin backbone keeps its
tokens [B, H, W, C] and hands the FPN permuted views); the public outputs
keep the JAX package's layout: dense per-anchor predictions (softmax class scores,
box offsets, mask coefs) in (rows, cols, ratios) anchor order and the
prototype map as [B, H/4, W/4, 32]. Module names follow the reference
state_dict (`fpn.lat_layers.0`, `proto_net.proto1.0`,
`prediction_layers.upfeature.0`, ...).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from yolact_minimal_torch.config import SWIN_SPECS, Config
from yolact_minimal_torch.models.resnet import ResNet
from yolact_minimal_torch.models.swin import Swin, WindowAttention
from yolact_minimal_torch.ops.resize import resize_bilinear

COEF_DIM = 32

BACKBONE_LAYERS = {'resnet50': (3, 4, 6, 3), 'resnet101': (3, 4, 23, 3)}


def _conv_relu(cin: int, cout: int, k: int = 3, stride: int = 1) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2),
                         nn.ReLU(inplace=True))


class FPN(nn.Module):
    """3 lateral 1x1 convs + top-down bilinear + 3x3 pred convs -> P3..P5,
    then two stride-2 convs -> P6, P7; 256 channels everywhere."""

    def __init__(self, in_channels: Tuple[int, int, int]):
        super().__init__()
        self.lat_layers = nn.ModuleList([nn.Conv2d(c, 256, 1) for c in in_channels])
        self.pred_layers = nn.ModuleList([_conv_relu(256, 256) for _ in range(3)])
        self.downsample_layers = nn.ModuleList(
            [_conv_relu(256, 256, stride=2) for _ in range(2)])

    def forward(self, c3, c4, c5):
        p5_1 = self.lat_layers[2](c5)
        p4_1 = self.lat_layers[1](c4) + resize_bilinear(p5_1, *c4.shape[-2:])
        p3_1 = self.lat_layers[0](c3) + resize_bilinear(p4_1, *c3.shape[-2:])
        p3 = self.pred_layers[0](p3_1)
        p4 = self.pred_layers[1](p4_1)
        p5 = self.pred_layers[2](p5_1)
        p6 = self.downsample_layers[0](p5)
        p7 = self.downsample_layers[1](p6)
        return p3, p4, p5, p6, p7


class ProtoNet(nn.Module):
    """3x(3x3 conv+ReLU) -> 2x bilinear (align_corners=True) -> 3x3
    conv+ReLU -> 1x1 conv to COEF_DIM prototypes + ReLU, on P3."""

    def __init__(self):
        super().__init__()
        self.proto1 = nn.Sequential(*_conv_relu(256, 256), *_conv_relu(256, 256),
                                    *_conv_relu(256, 256))
        self.proto2 = nn.Sequential(*_conv_relu(256, 256), *_conv_relu(256, COEF_DIM, k=1))

    def forward(self, x):
        x = self.proto1(x)
        x = resize_bilinear(x, x.shape[-2] * 2, x.shape[-1] * 2, align_corners=True)
        return self.proto2(x)


class PredictionHead(nn.Module):
    """One head shared by the five FPN levels: upfeature conv, then three
    parallel 3x3 convs -> box (AR*4), conf (AR*C), coef (AR*32, tanh)."""

    def __init__(self, num_classes: int, num_ratios: int):
        super().__init__()
        self.num_classes = num_classes
        self.upfeature = _conv_relu(256, 256)
        self.bbox_layer = nn.Conv2d(256, num_ratios * 4, 3, padding=1)
        self.conf_layer = nn.Conv2d(256, num_ratios * num_classes, 3, padding=1)
        self.coef_layer = nn.Sequential(nn.Conv2d(256, num_ratios * COEF_DIM, 3, padding=1),
                                        nn.Tanh())

    def forward(self, x):
        b = x.shape[0]
        x = self.upfeature(x)
        # NCHW -> NHWC before the reshape: anchors iterate rows, cols, ratios,
        # the order of ops/boxes.py::make_anchors.
        nhwc = lambda t: t.permute(0, 2, 3, 1)
        conf = nhwc(self.conf_layer(x)).reshape(b, -1, self.num_classes)
        box = nhwc(self.bbox_layer(x)).reshape(b, -1, 4)
        coef = nhwc(self.coef_layer(x)).reshape(b, -1, COEF_DIM)
        return conf, box, coef


class Yolact(nn.Module):
    """YOLACT. `forward(img [B, S, S, 3])` returns (softmax class scores
    [B, A, C], box offsets [B, A, 4], mask coefs [B, A, 32], proto
    [B, S/4, S/4, 32]), all float32 whatever cfg.compute_dtype.

    With `train_mode` the model also holds the train-only semantic head
    (`semantic_seg_conv`, 1x1 on P3 to C-1 classes) and returns (raw class
    logits, box, coef, proto, seg logits [B, S/8, S/8, C-1]), all float32.
    BatchNorm follows the module's train()/eval() mode. With cfg.remat the
    backbone's blocks are recomputed in the backward of a training
    forward."""

    def __init__(self, cfg: Config, train_mode: bool = False):
        super().__init__()
        self.cfg = cfg
        self.train_mode = train_mode
        if cfg.backbone in BACKBONE_LAYERS:
            self.backbone = ResNet(BACKBONE_LAYERS[cfg.backbone], remat=cfg.remat)
            self.fpn = FPN((512, 1024, 2048))
        elif cfg.is_swin:
            # The swin modules take their compute dtype at construction.
            spec = SWIN_SPECS[cfg.backbone]
            self.backbone = Swin(**spec, dtype=getattr(torch, cfg.compute_dtype),
                                 remat=cfg.remat)
            self.fpn = FPN(tuple(spec['embed_dim'] * 2 ** i for i in (1, 2, 3)))
        else:
            raise ValueError(f'Unknown backbone {cfg.backbone!r}')
        self.proto_net = ProtoNet()
        self.prediction_layers = PredictionHead(cfg.num_classes, len(cfg.aspect_ratios))
        if train_mode:
            self.semantic_seg_conv = nn.Conv2d(256, cfg.num_classes - 1, 1)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Xavier-uniform conv weights and zero biases (the reference init),
        drawn from `generator`; BatchNorm to identity statistics. Swin:
        truncated normal (std 0.02) Linear weights and bias tables, zero
        biases, LayerNorm to identity."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.xavier_uniform_(m.weight, generator=generator)
            elif isinstance(m, nn.Linear):
                nn.init.trunc_normal_(m.weight, std=0.02, generator=generator)
            elif isinstance(m, WindowAttention):
                nn.init.trunc_normal_(m.relative_position_bias_table, std=0.02,
                                      generator=generator)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
                m.reset_running_stats()
            elif isinstance(m, nn.LayerNorm):
                m.reset_parameters()
            if isinstance(m, (nn.Conv2d, nn.Linear)) and m.bias is not None:
                nn.init.zeros_(m.bias)

    def forward(self, img: torch.Tensor, generator: Optional[torch.Generator] = None):
        """`generator` draws swin's stochastic depth in training."""
        # cfg.compute_dtype 'bfloat16' runs the convolutions in bf16 under
        # autocast while parameters and BatchNorm statistics stay float32,
        # as flax's Conv/BatchNorm(dtype=bf16) do in the JAX package.
        bf16 = self.cfg.compute_dtype == 'bfloat16'
        with torch.autocast(img.device.type, dtype=torch.bfloat16, enabled=bf16):
            if isinstance(self.backbone, Swin):
                c3, c4, c5 = (t.permute(0, 3, 1, 2)
                              for t in self.backbone(img, generator)[1:])
            else:
                _, c3, c4, c5 = self.backbone(img.permute(0, 3, 1, 2))
            p3, p4, p5, p6, p7 = self.fpn(c3, c4, c5)
            proto = self.proto_net(p3)
            outs = [self.prediction_layers(p) for p in (p3, p4, p5, p6, p7)]
            seg = self.semantic_seg_conv(p3) if self.train_mode else None
        class_pred, box_pred, coef_pred = (
            torch.cat([o[i] for o in outs], dim=1).float() for i in range(3))
        proto = proto.permute(0, 2, 3, 1).float().contiguous()
        if self.train_mode:
            return class_pred, box_pred, coef_pred, proto, seg.permute(0, 2, 3, 1).float()
        return torch.softmax(class_pred, dim=-1), box_pred, coef_pred, proto

