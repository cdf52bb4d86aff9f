"""ResNet-50 (He et al., 2016): a 7x7 stem, max pool and four stages of
bottleneck blocks (3, 4, 6, 3), the stride in each stage's first 3x3
convolution, a projection shortcut where the shape changes. Returns C2..C5
(256, 512, 1024, 2048 channels at strides 4, 8, 16, 32)."""
from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.layers import BatchNorm, Conv


class Bottleneck(nn.Module):
    def __init__(self, cin, planes, stride, projection):
        super().__init__()
        self.conv1 = Conv(cin, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm(planes * 4)
        self.downsample = nn.Sequential(Conv(cin, planes * 4, 1, stride, bias=False),
                                        BatchNorm(planes * 4)) if projection else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + (x if self.downsample is None else self.downsample(x)))


class ResNet(nn.Module):
    def __init__(self, depths):
        super().__init__()
        self.conv1 = Conv(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(64)
        self.layers = nn.ModuleList()
        cin = 64
        for stage, depth in enumerate(depths):
            planes = 64 * 2 ** stage
            stride = 1 if stage == 0 else 2
            self.layers.append(nn.Sequential(*(
                Bottleneck(cin if b == 0 else planes * 4, planes, stride if b == 0 else 1,
                           b == 0) for b in range(depth))))
            cin = planes * 4

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        outs = []
        for stage in self.layers:
            x = stage(x)
            outs.append(x)
        return outs
