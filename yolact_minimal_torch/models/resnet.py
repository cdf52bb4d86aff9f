"""ResNet-50/101 backbone (NCHW).

Bottleneck residual stages (3, 4, 6, 3) / (3, 4, 23, 3) returning the
C2..C5 pyramid. Convolutions use torch's symmetric padding, as the JAX
package does explicitly, so one set of weights gives the same activations in
both. Module names follow the reference state_dict
(`layers.{stage}.{block}.conv1`, `downsample.0/1`).

In training mode BatchNorm normalizes with the batch statistics and updates
its running statistics by flax's rule (`BatchNorm2d`); in a process group
the statistics are those of the global batch (parallel/mesh.py). With `remat` each
Bottleneck is recomputed in the backward (`models/remat.py`); the stem stays
outside, as in the JAX package.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from yolact_minimal_torch.models import remat as _remat
from yolact_minimal_torch.parallel import mesh


class _GlobalBatchNorm(torch.autograd.Function):
    """Training-mode batch norm over the global batch of a process group.

    Forward: the mean from the summed (sum, count), then the variance from
    the summed centred second moment (two passes, as torch.var_mean).
    Backward: nn.BatchNorm2d's formula, dx = w * invstd * (dy - mean(dy) -
    xhat * mean(dy * xhat)), with the two means (the gradients of the
    statistics) summed over the world; the weight and bias gradients stay
    this process's, and the train step sums them with the others. The sums
    accumulate as nn.BatchNorm2d's do (float64 on the CPU, float32 on the
    card), the rest computes in float32 at least. Returns (y, mean, biased
    var)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        acc = torch.float64 if x.device.type == 'cpu' else torch.float32
        dtype = torch.promote_types(x.dtype, torch.float32)
        xa = x.to(torch.promote_types(x.dtype, acc))
        count = xa.new_tensor([xa.numel() // xa.shape[1]])
        sums = mesh.global_sum(torch.cat([xa.sum(dim=(0, 2, 3)), count]))
        count, mean = sums[-1], sums[:-1] / sums[-1]
        var = mesh.global_sum((xa - mean[None, :, None, None]).square().sum(dim=(0, 2, 3))) / count
        mean, invstd, var = mean.to(dtype), torch.rsqrt(var + eps).to(dtype), var.to(dtype)
        y = (x.to(dtype) - mean[None, :, None, None]) * (invstd * weight)[None, :, None, None] \
            + bias[None, :, None, None]
        ctx.save_for_backward(x, weight, mean, invstd, count)
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        x, weight, mean, invstd, count = ctx.saved_tensors
        c, acc = mean.shape[0], count.dtype
        xhat = (x.to(mean.dtype) - mean[None, :, None, None]) * invstd[None, :, None, None]
        dyf = dy.to(mean.dtype)
        sum_dy = dyf.sum(dim=(0, 2, 3), dtype=acc)
        sum_dy_xhat = (dyf * xhat).sum(dim=(0, 2, 3), dtype=acc)
        means = (mesh.global_sum(torch.cat([sum_dy, sum_dy_xhat])) / count).to(mean.dtype)
        dx = (dyf - means[None, :c, None, None] - xhat * means[None, c:, None, None]) \
            * (invstd * weight)[None, :, None, None]
        return dx.to(x.dtype), sum_dy_xhat.to(weight.dtype), sum_dy.to(weight.dtype), None


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d whose training-mode update of the running statistics
    is flax's (momentum 0.9): running = 0.9 * running + 0.1 * batch, with the
    BIASED batch variance, where nn.BatchNorm2d takes the unbiased one. The
    output and the eval mode are nn.BatchNorm2d's. The backward's recompute
    of a rematerialized block leaves the statistics as the forward left
    them.

    In a process group of more than one process the batch is the global
    one, as flax's BatchNorm reduces over the sharded batch axis
    (`_GlobalBatchNorm`), and every process updates the running statistics
    alike. The recompute of a rematerialized block reduces again: its
    output needs the statistics."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if mesh.distributed():
            y, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps)
            if not _remat.recomputing():
                self._update_running(mean, var)
            return y
        if not _remat.recomputing():
            with torch.no_grad():
                var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), unbiased=False)
                self._update_running(mean, var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)

    def _update_running(self, mean, var):
        with torch.no_grad():
            self.running_mean.mul_(0.9).add_(mean, alpha=0.1)
            self.running_var.mul_(0.9).add_(var, alpha=0.1)
            self.num_batches_tracked.add_(1)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 (x4) with identity or projection shortcut."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 projection: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes, eps=1e-5)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = BatchNorm2d(planes, eps=1e-5)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * 4, eps=1e-5)
        self.downsample = nn.Sequential(
            nn.Conv2d(in_planes, planes * 4, 1, stride=stride, bias=False),
            BatchNorm2d(planes * 4, eps=1e-5)) if projection else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class ResNet(nn.Module):
    """Returns (C2, C3, C4, C5): channels (256, 512, 1024, 2048) at strides
    (4, 8, 16, 32). `remat`: each Bottleneck is recomputed in the backward
    when training with grad enabled."""

    def __init__(self, layers: Sequence[int], remat: bool = False):
        super().__init__()
        self.remat = remat
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64, eps=1e-5)
        self.layers = nn.ModuleList()
        in_planes = 64
        for stage, blocks in enumerate(layers):
            planes = 64 * (2 ** stage)
            stride = 1 if stage == 0 else 2
            stage_blocks = []
            for b in range(blocks):
                stage_blocks.append(Bottleneck(
                    in_planes if b == 0 else planes * 4, planes,
                    stride=stride if b == 0 else 1,
                    projection=(b == 0 and (stride != 1 or in_planes != planes * 4))))
            self.layers.append(nn.Sequential(*stage_blocks))
            in_planes = planes * 4

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs = []
        remat = _remat.active(self, self.remat)
        for stage in self.layers:
            for block in stage:
                x = _remat.run(block, x) if remat else block(x)
            outs.append(x)
        return tuple(outs)
