"""Parameter holders named as the published state_dicts name them, with
forwards through `ops` so that the precision of every product is one
switch."""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference import ops


class Conv(nn.Module):
    def __init__(self, cin, cout, k, stride=1, padding=0, bias=True):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x):
        return ops.conv2d(x, self.weight, self.bias, self.stride, self.padding)


class ConvReLU(nn.Sequential):
    """nn.Sequential(conv, relu): the conv is entry 0, as published."""

    def __init__(self, cin, cout, k=3, stride=1):
        super().__init__(Conv(cin, cout, k, stride, k // 2), nn.ReLU())


class BatchNorm(nn.Module):
    """Batch statistics in training, running statistics in eval; the
    running statistics are not updated (no comparison reads them)."""

    def __init__(self, c, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))
        self.register_buffer('running_mean', torch.zeros(c))
        self.register_buffer('running_var', torch.ones(c))
        self.register_buffer('num_batches_tracked', torch.zeros((), dtype=torch.long))

    def forward(self, x):
        if self.training:
            return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)


class LayerNorm(nn.Module):
    def __init__(self, c, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))

    def forward(self, x):
        return F.layer_norm(x, (x.shape[-1],), self.weight, self.bias, self.eps)


class Linear(nn.Module):
    def __init__(self, cin, cout, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x):
        return ops.linear(x, self.weight, self.bias)
