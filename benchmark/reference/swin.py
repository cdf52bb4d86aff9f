"""Swin-T (Liu et al., 2021): 4x4 patch embedding to 96 channels, four
stages of (2, 2, 6, 2) blocks with (3, 6, 12, 24) heads of width 32 in 7x7
windows, every second block's windows shifted by 3, patch merging between
stages, MLP ratio 4, LayerNorm on the outputs of stages 1-3.

A block: x + attn(pad(LN1(x))) then x + MLP(LN2(x)). The map is padded at
the bottom and right to a multiple of the window after LN1, rolled by -3
in a shifted block, and token pairs of a shifted window that come from
different regions get -100 added to their score; the relative position
bias is gathered from a (2*7-1)^2 table a head. In training each block
with a nonzero stochastic-depth rate (linspace(0, 0.2, 12) over the
blocks) keeps each sample's branch with probability 1 - rate, scaled by
1 / (1 - rate): one uniform draw a sample for the attention branch and
then one for the MLP branch, from the generator the forward is given.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference import ops
from benchmark.reference.layers import Conv, LayerNorm, Linear

WINDOW = 7
NEG = -100.0


def relative_index(w=WINDOW) -> torch.Tensor:
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing='ij')).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0) + (w - 1)
    return torch.from_numpy(rel[:, :, 0] * (2 * w - 1) + rel[:, :, 1])


def region_ids(hp, wp, w=WINDOW, shift=WINDOW // 2) -> torch.Tensor:
    """[nW, w*w] region id of every token of the shifted partition."""
    img = np.zeros((hp, wp), np.int64)
    cuts = (slice(0, -w), slice(-w, -shift), slice(-shift, None))
    for i, hs in enumerate(cuts):
        for j, ws in enumerate(cuts):
            img[hs, ws] = 3 * i + j
    img = img.reshape(hp // w, w, wp // w, w).transpose(0, 2, 1, 3)
    return torch.from_numpy(img.reshape(-1, w * w))


def drop_path(x, rate, generator):
    if rate == 0.0:
        return x
    u = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1), generator=generator,
                   device=x.device)
    keep = 1.0 - rate
    return x / keep * torch.floor(keep + u)


class Attention(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * WINDOW - 1) ** 2, heads))

    def forward(self, x, region):
        """x [windows, N, C]; region [nW, N] or None."""
        bw, n, c = x.shape
        hd = c // self.heads
        qkv = self.qkv(x).reshape(bw, n, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * hd ** -0.5, qkv[1], qkv[2]
        idx = relative_index().to(x.device).reshape(-1)
        bias = self.relative_position_bias_table[idx].reshape(n, n, -1).permute(2, 0, 1)
        scores = ops.matmul(q, k.transpose(-1, -2)) + bias
        if region is not None:
            nw = region.shape[0]
            mask = torch.where(region[:, :, None] == region[:, None, :], 0.0, NEG)
            scores = (scores.reshape(bw // nw, nw, self.heads, n, n)
                      + mask[None, :, None]).reshape(bw, self.heads, n, n)
        out = ops.matmul(torch.softmax(scores, dim=-1), v)
        return self.proj(out.transpose(1, 2).reshape(bw, n, c))


class Mlp(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.fc1 = Linear(dim, 4 * dim)
        self.fc2 = Linear(4 * dim, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim, heads, shift, rate):
        super().__init__()
        self.shift, self.rate = shift, rate
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, heads)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim)

    def forward(self, x, generator):
        b, h, w, c = x.shape
        rate = self.rate if self.training else 0.0
        y = self.norm1(x)
        hp, wp = -(-h // WINDOW) * WINDOW, -(-w // WINDOW) * WINDOW
        y = F.pad(y, (0, 0, 0, wp - w, 0, hp - h))
        region = None
        if self.shift:
            y = torch.roll(y, (-self.shift, -self.shift), dims=(1, 2))
            region = region_ids(hp, wp).to(x.device)
        win = y.reshape(b, hp // WINDOW, WINDOW, wp // WINDOW, WINDOW, c)
        win = win.permute(0, 1, 3, 2, 4, 5).reshape(-1, WINDOW * WINDOW, c)
        y = self.attn(win, region).reshape(b, hp // WINDOW, wp // WINDOW, WINDOW, WINDOW, c)
        y = y.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
        if self.shift:
            y = torch.roll(y, (self.shift, self.shift), dims=(1, 2))
        x = x + drop_path(y[:, :h, :w], rate, generator)
        return x + drop_path(self.mlp(self.norm2(x)), rate, generator)


class PatchMerging(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        h, w = x.shape[1:3]
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1)
        return self.reduction(self.norm(x))


class Stage(nn.Module):
    def __init__(self, dim, depth, heads, rates, downsample):
        super().__init__()
        self.blocks = nn.ModuleList(Block(dim, heads, 0 if i % 2 == 0 else WINDOW // 2, r)
                                    for i, r in enumerate(rates))
        self.downsample = PatchMerging(dim) if downsample else None


class PatchEmbed(nn.Module):
    def __init__(self, dim, patch):
        super().__init__()
        self.proj = Conv(3, dim, patch, patch)
        self.norm = LayerNorm(dim)


class SwinT(nn.Module):
    """forward(x [B, H, W, 3]) -> 4 maps [B, h, w, C]; maps 1-3 normed."""

    def __init__(self, embed_dim, depths, heads, patch, drop_path_rate):
        super().__init__()
        self.patch = patch
        self.patch_embed = PatchEmbed(embed_dim, patch)
        rates = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        start = np.cumsum((0,) + tuple(depths)).tolist()
        self.layers = nn.ModuleList(
            Stage(embed_dim * 2 ** i, d, heads[i], rates[start[i]:start[i] + d],
                  i < len(depths) - 1) for i, d in enumerate(depths))
        for i in range(1, len(depths)):
            setattr(self, f'norm{i}', LayerNorm(embed_dim * 2 ** i))

    def forward(self, x, generator=None):
        p = self.patch
        h, w = x.shape[1:3]
        x = F.pad(x.permute(0, 3, 1, 2), (0, (p - w % p) % p, 0, (p - h % p) % p))
        x = self.patch_embed.norm(self.patch_embed.proj(x).permute(0, 2, 3, 1))
        outs = []
        for i, stage in enumerate(self.layers):
            for block in stage.blocks:
                x = block(x, generator)
            outs.append(getattr(self, f'norm{i}')(x) if i else x)
            if stage.downsample is not None:
                x = stage.downsample(x)
        return outs
