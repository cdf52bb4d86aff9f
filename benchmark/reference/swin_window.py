"""Swin (Liu et al., 2021) with its window taken from the configuration:
4x4 patch embedding to C channels, four stages of `depths` blocks with
`num_heads` heads of width 32 in w x w windows, every second block's
windows shifted by w // 2, patch merging between stages, MLP ratio 4,
LayerNorm on the outputs of stages 1-3. At w = 7 it is `reference/swin.py`'s
Swin-T; Swin-L at window 12 is C 192, depths (2, 2, 18, 2), heads (6, 12,
24, 48).

A block: x + attn(pad(LN1(x))) then x + MLP(LN2(x)). The map is padded at
the bottom and right to a multiple of the window after LN1, rolled by
-w // 2 in a shifted block, and token pairs of a shifted window that come
from different regions get -100 added to their score; the relative
position bias is gathered from a (2w-1)^2 table a head. In training each
block with a nonzero stochastic-depth rate (linspace(0, rate, blocks))
keeps each sample's branch with probability 1 - rate, scaled by
1 / (1 - rate): one uniform draw a sample for the attention branch and then
one for the MLP branch, from the generator the forward is given.

Where this departs from the paper's classification model, it follows the
published detection backbone (Swin-Transformer-Object-Detection): a map
smaller than the window is padded to one window and keeps its shift, where
the classification model shrinks the window to the map and drops the
shift; the three outputs have LayerNorms of their own and the classifier
head is gone. The stochastic-depth draws are this repository's (one
generator, forward order).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference import ops
from benchmark.reference.layers import LayerNorm, Linear
from benchmark.reference.swin import (NEG, Mlp, PatchEmbed, PatchMerging, drop_path,
                                      region_ids, relative_index)


class Attention(nn.Module):
    def __init__(self, dim, heads, window):
        super().__init__()
        self.heads, self.window = heads, window
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * window - 1) ** 2, heads))

    def forward(self, x, region):
        """x [windows, N, C]; region [nW, N] or None."""
        bw, n, c = x.shape
        hd = c // self.heads
        qkv = self.qkv(x).reshape(bw, n, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * hd ** -0.5, qkv[1], qkv[2]
        idx = relative_index(self.window).to(x.device).reshape(-1)
        bias = self.relative_position_bias_table[idx].reshape(n, n, -1).permute(2, 0, 1)
        scores = ops.matmul(q, k.transpose(-1, -2)) + bias
        if region is not None:
            nw = region.shape[0]
            mask = torch.where(region[:, :, None] == region[:, None, :], 0.0, NEG)
            scores = (scores.reshape(bw // nw, nw, self.heads, n, n)
                      + mask[None, :, None]).reshape(bw, self.heads, n, n)
        out = ops.matmul(torch.softmax(scores, dim=-1), v)
        return self.proj(out.transpose(1, 2).reshape(bw, n, c))


class Block(nn.Module):
    def __init__(self, dim, heads, window, shift, rate):
        super().__init__()
        self.window, self.shift, self.rate = window, shift, rate
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, heads, window)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim)

    def forward(self, x, generator):
        b, h, w, c = x.shape
        win = self.window
        rate = self.rate if self.training else 0.0
        y = self.norm1(x)
        hp, wp = -(-h // win) * win, -(-w // win) * win
        y = F.pad(y, (0, 0, 0, wp - w, 0, hp - h))
        region = None
        if self.shift:
            y = torch.roll(y, (-self.shift, -self.shift), dims=(1, 2))
            region = region_ids(hp, wp, win, self.shift).to(x.device)
        y = y.reshape(b, hp // win, win, wp // win, win, c)
        y = y.permute(0, 1, 3, 2, 4, 5).reshape(-1, win * win, c)
        y = self.attn(y, region).reshape(b, hp // win, wp // win, win, win, c)
        y = y.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
        if self.shift:
            y = torch.roll(y, (self.shift, self.shift), dims=(1, 2))
        x = x + drop_path(y[:, :h, :w], rate, generator)
        return x + drop_path(self.mlp(self.norm2(x)), rate, generator)


class Stage(nn.Module):
    def __init__(self, dim, heads, window, rates, downsample):
        super().__init__()
        self.blocks = nn.ModuleList(Block(dim, heads, window, 0 if i % 2 == 0 else window // 2, r)
                                    for i, r in enumerate(rates))
        self.downsample = PatchMerging(dim) if downsample else None


class Swin(nn.Module):
    """forward(x [B, H, W, 3]) -> 4 maps [B, h, w, C]; maps 1-3 normed."""

    def __init__(self, embed_dim, depths, heads, window, patch, drop_path_rate):
        super().__init__()
        self.patch = patch
        self.patch_embed = PatchEmbed(embed_dim, patch)
        rates = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        start = np.cumsum((0,) + tuple(depths)).tolist()
        self.layers = nn.ModuleList(
            Stage(embed_dim * 2 ** i, heads[i], window, rates[start[i]:start[i] + d],
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
