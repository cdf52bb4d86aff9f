"""Swin-Tiny backbone, eval mode: tokens stay [B, H, W, C] inside.

4x4 patch embed (dim 96) + 4 stages of shifted-window attention blocks,
depths (2, 2, 6, 2), heads (3, 6, 12, 24), window 7, MLP ratio 4, patch
merging between stages, LayerNorm on the three FPN-facing outputs
(192/384/768 channels at strides 8/16/32). Names and semantics follow
`yolact_minimal_tpu/models/swin.py`; module names follow the reference
state_dict (`patch_embed.proj`, `layers.{s}.blocks.{b}.attn.qkv`,
`layers.{s}.downsample.reduction`, `norm{1,2,3}`), so a strict
`load_state_dict` takes published key names.

Every block runs hand-written kernels, in one of three forms (`FORMS`) that
compute the same function from the same parameters:
- 'composed' (the default): `ops/window_attention.py` between the qkv and
  proj Linears, and `ops/swin_mlp.py` for the whole MLP half;
- 'attn_block': `ops/attn_block.py` for qkv, attention and proj in one
  kernel, then `ops/swin_mlp.py`;
- 'whole': `ops/swin_block.py` for the whole block, norm1 to the second
  residual, on the windowed pre-norm rows.
`SwinTiny` takes the form per stage and `set_block_forms` switches an
instance. In bfloat16 the forms round at different places ('whole' keeps the
residual between the halves in float32, the others round it); in float32 they
differ by summation order only. The window padding sizes, the shifted-window
region ids, the padding rowmask and the relative-position index are
data-independent numpy tables.

`dtype` is the compute dtype: parameters stay float32, and each Linear keeps
a copy cast once for calls that need no gradient; LayerNorm runs in float32
and rounds its result, as flax's `LayerNorm(dtype=...)` does.

Training (the module in train mode) runs the 'composed' form only, as the
JAX package does: kernel 3 and, in blocks without stochastic depth, kernel
4, each under autograd (their backward recomputes the plain version).
Stochastic depth (`drop_path`, rates by linspace to `drop_path_rate` over the
12 blocks) draws one keep bit a sample from the generator the forward is
given; a block with a nonzero rate runs its MLP half in plain ops, as the
JAX block does. With `remat` each block is recomputed in the backward
(`models/remat.py`, which replays its drop_path draws); the patch embed,
PatchMerging and the output norms stay outside, as in the JAX package.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from yolact_minimal_torch.models import remat as _remat
from yolact_minimal_torch.ops.attn_block import attn_block
from yolact_minimal_torch.ops.swin_block import swin_block
from yolact_minimal_torch.ops.swin_mlp import LN_EPS, mlp_block
from yolact_minimal_torch.ops.window_attention import window_attention

WINDOW = 7
FORMS = ('composed', 'attn_block', 'whole')


@functools.lru_cache(maxsize=None)
def relative_position_index(window: int = WINDOW) -> np.ndarray:
    """[N, N] indices into the (2w-1)^2 bias table for every token pair."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing='ij'))
    flat = coords.reshape(2, -1)                            # [2, N]
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1).astype(np.int32)                     # [N, N]


@functools.lru_cache(maxsize=None)
def shifted_window_regions(hp: int, wp: int, window: int = WINDOW,
                           shift: int = WINDOW // 2) -> np.ndarray:
    """Static [nW, N] int32 region ids of the shifted-window partition: token
    pairs in the same window with different ids must not attend to each
    other. hp/wp are padded sizes."""
    img = np.zeros((hp, wp), np.int32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    img = img.reshape(hp // window, window, wp // window, window)
    return img.transpose(0, 2, 1, 3).reshape(-1, window * window)


@functools.lru_cache(maxsize=None)
def _cached_table(make, args: tuple, device: torch.device) -> Optional[torch.Tensor]:
    table = make(*args)
    return None if table is None else torch.from_numpy(np.ascontiguousarray(table)).to(device)


def _table_on(make, *args, device: torch.device) -> Optional[torch.Tensor]:
    """The static numpy table `make(*args)` on `device`, made once per
    arguments and device; under torch.export made afresh, so that no traced
    tensor enters the cache."""
    if torch.compiler.is_exporting():
        return _cached_table.__wrapped__(make, args, device)
    return _cached_table(make, args, device)


def _regions_on(hp: int, wp: int, device: torch.device) -> torch.Tensor:
    return _table_on(shifted_window_regions, hp, wp, device=device)


@functools.lru_cache(maxsize=None)
def pad_rowmask(h: int, w: int, hp: int, wp: int, shift: int,
                window: int = WINDOW) -> Optional[np.ndarray]:
    """Static [nW, N] float32 1/0 validity of each windowed row after padding
    (h, w) -> (hp, wp) and rolling by -shift: 0 marks a padding token. None
    when no padding is needed. The whole-block kernel zeroes its LayerNorm1
    output on padding rows, which is what padding after norm1 does."""
    if hp == h and wp == w:
        return None
    m = np.zeros((hp, wp), np.float32)
    m[:h, :w] = 1.0
    if shift:
        m = np.roll(m, (-shift, -shift), axis=(0, 1))
    m = m.reshape(hp // window, window, wp // window, window)
    return m.transpose(0, 2, 1, 3).reshape(-1, window * window)


def _rowmask_on(h: int, w: int, hp: int, wp: int, shift: int,
                device: torch.device) -> Optional[torch.Tensor]:
    return _table_on(pad_rowmask, h, w, hp, wp, shift, device=device)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """[B, H, W, C] -> [B * nW, window*window, C]."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def window_reverse(x: torch.Tensor, window: int, h: int, w: int) -> torch.Tensor:
    """[B * nW, window*window, C] -> [B, H, W, C]."""
    c = x.shape[-1]
    b = x.shape[0] // ((h // window) * (w // window))
    x = x.reshape(b, h // window, w // window, window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def _layer_norm(x: torch.Tensor, norm: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias,
                        norm.eps).to(dtype)


class _Derived:
    """A value derived from parameters, recomputed only after one of them was
    written in place or moved. Under torch.export it is computed afresh and
    nothing is stored: traced parameters have no storage to key on, and a
    traced value must not reach a later eager call."""

    def __init__(self):
        self._key = None
        self._value = None

    def get(self, params: Sequence[torch.Tensor], make):
        if torch.compiler.is_exporting():
            return make()
        key = tuple((p.device, p.data_ptr(), p._version) for p in params)
        if key != self._key:
            self._key, self._value = key, make()
        return self._value


def _needs_grad(params: Sequence[torch.Tensor]) -> bool:
    return torch.is_grad_enabled() and any(p.requires_grad for p in params)


def drop_path(x: torch.Tensor, rate: float,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    """Per-sample stochastic depth: each sample's x kept with probability
    1 - rate and then scaled by 1 / (1 - rate); the identity at rate 0."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    u = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1), generator=generator,
                   device=x.device)
    return x / keep * torch.floor(keep + u).to(x.dtype)


class Linear(nn.Linear):
    """nn.Linear that runs in `compute_dtype`. A call that needs no gradient
    uses copies of the float32 parameters cast once, rather than on every
    call; a call that does casts them afresh, so the gradient reaches the
    parameters."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype
        self._cast = _Derived()

    def cast(self) -> Tuple[torch.Tensor, ...]:
        """(weight,) or (weight, bias) in the compute dtype."""
        params = (self.weight,) if self.bias is None else (self.weight, self.bias)
        if _needs_grad(params):
            return tuple(p.to(self.compute_dtype) for p in params)
        return self._cast.get(
            params, lambda: tuple(p.detach().to(self.compute_dtype) for p in params))

    def forward(self, x):
        weight, *bias = self.cast()
        return F.linear(x.to(self.compute_dtype), weight, *bias)


class WindowAttention(nn.Module):
    """Per-window multi-head attention with relative position bias. `region`
    is the [nW, N] int32 region-id map of the shifted partition (None for an
    unshifted block)."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.qkv = Linear(dim, 3 * dim, compute_dtype=dtype)
        self.proj = Linear(dim, dim, compute_dtype=dtype)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * WINDOW - 1) ** 2, num_heads))
        self.register_buffer(
            'relative_position_index',
            torch.from_numpy(relative_position_index().astype(np.int64)), persistent=False)
        self._bias = _Derived()

    def bias(self) -> torch.Tensor:
        """[heads, N, N] in the compute dtype: gathered once per table for
        calls that need no gradient, afresh for calls that do."""
        table = self.relative_position_bias_table
        n = WINDOW * WINDOW

        def make(t):
            b = t[self.relative_position_index.reshape(-1)]
            return b.reshape(n, n, -1).permute(2, 0, 1).to(self.dtype).contiguous()
        if _needs_grad((table,)):
            return make(table)
        return self._bias.get((table,), lambda: make(table.detach()))

    def forward(self, x, region, fused_block: bool = False):
        """`fused_block`: qkv, attention and proj as one kernel."""
        if fused_block:
            return attn_block(x.contiguous(), self.qkv.cast()[0], self.qkv.bias, self.bias(),
                              region, self.proj.cast()[0], self.proj.bias, self.num_heads)
        out = window_attention(self.qkv(x).contiguous(), self.bias(), region, self.num_heads)
        return self.proj(out)


class Mlp(nn.Module):
    """Holds fc1 and fc2; SwinBlock hands their parameters to `mlp_block`:
    the weights in the compute dtype, the biases in float32."""

    def __init__(self, dim: int, hidden: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Linear(dim, hidden, compute_dtype=dtype)
        self.fc2 = Linear(hidden, dim, compute_dtype=dtype)


class SwinBlock(nn.Module):
    """W-MSA / SW-MSA block on [B, H, W, C]. The input is padded bottom/right
    to a multiple of the window with zeros AFTER norm1, and the regions are
    those of the padded size. `fused_attn_block` and `fused_whole` pick the
    form (module docstring); the parameters are the same in all three.
    `drop_path_rate` is the block's stochastic depth in training."""

    def __init__(self, dim: int, num_heads: int, shift: int,
                 dtype: torch.dtype = torch.float32, fused_attn_block: bool = False,
                 fused_whole: bool = False, drop_path_rate: float = 0.0):
        super().__init__()
        self.shift = shift
        self.dtype = dtype
        self.drop_path_rate = drop_path_rate
        self.fused_attn_block = fused_attn_block
        self.fused_whole = fused_whole
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, num_heads, dtype)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, dim * 4, dtype)

    def _to_windows(self, x):
        """Pad to a multiple of the window, roll by the shift, partition.
        Returns the windows, the padded size and the region ids (or None)."""
        _, h, w, _ = x.shape
        pad_b = (WINDOW - h % WINDOW) % WINDOW
        pad_r = (WINDOW - w % WINDOW) % WINDOW
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = h + pad_b, w + pad_r
        region = None
        if self.shift > 0:
            x = torch.roll(x, (-self.shift, -self.shift), dims=(1, 2))
            region = _regions_on(hp, wp, x.device)
        return window_partition(x, WINDOW), hp, wp, region

    def _from_windows(self, windows, hp, wp, h, w):
        x = window_reverse(windows, WINDOW, hp, wp)
        if self.shift > 0:
            x = torch.roll(x, (self.shift, self.shift), dims=(1, 2))
        return x[:, :h, :w, :] if (hp, wp) != (h, w) else x

    def forward(self, x, generator: Optional[torch.Generator] = None):
        b, h, w, c = x.shape
        if self.training and (self.fused_whole or self.fused_attn_block):
            raise NotImplementedError('swin trains in the composed form only: the '
                                      "'attn_block' and 'whole' kernels have no backward")
        if self.fused_whole:
            return self._whole(x)
        rate = self.drop_path_rate if self.training else 0.0
        shortcut = x
        x = _layer_norm(x, self.norm1, self.dtype)
        windows, hp, wp, region = self._to_windows(x)
        attended = self.attn(windows, region, fused_block=self.fused_attn_block)
        x = self._from_windows(attended, hp, wp, h, w)
        x = shortcut + drop_path(x, rate, generator)
        fc1, fc2 = self.mlp.fc1, self.mlp.fc2
        if rate > 0.0:
            # stochastic depth on the MLP branch: plain ops, as in the JAX block
            y = fc2(F.gelu(fc1(_layer_norm(x, self.norm2, self.dtype)).float()).to(self.dtype))
            return x + drop_path(y, rate, generator)
        y = mlp_block(x.reshape(-1, c), self.norm2.weight, self.norm2.bias, fc1.cast()[0],
                      fc1.bias, fc2.cast()[0], fc2.bias)
        return y.reshape(b, h, w, c)

    def _whole(self, x):
        """Both halves as one kernel on the windowed PRE-norm rows; the
        rowmask tells it which rows the padding added."""
        _, h, w, _ = x.shape
        windows, hp, wp, region = self._to_windows(x.to(self.dtype))
        attn, fc1, fc2 = self.attn, self.mlp.fc1, self.mlp.fc2
        y = swin_block(windows.contiguous(), _rowmask_on(h, w, hp, wp, self.shift, x.device),
                       self.norm1.weight, self.norm1.bias, attn.qkv.cast()[0], attn.qkv.bias,
                       attn.bias(), region, attn.proj.cast()[0], attn.proj.bias,
                       self.norm2.weight, self.norm2.bias, fc1.cast()[0], fc1.bias,
                       fc2.cast()[0], fc2.bias, attn.num_heads)
        return self._from_windows(y, hp, wp, h, w)


class PatchMerging(nn.Module):
    """2x2 spatial concat -> LayerNorm -> Linear 4C -> 2C. Channels are
    [x0 x1 x2 x3] = (row, col) offsets (0,0), (1,0), (0,1), (1,1); odd sizes
    pad first."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm = nn.LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False, compute_dtype=dtype)

    def forward(self, x):
        _, h, w, _ = x.shape
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(_layer_norm(x, self.norm, self.dtype))


class SwinStage(nn.Module):
    """`depth` blocks, alternating unshifted and shifted, then the optional
    patch merging; returns (the blocks' output, the next stage's input)."""

    def __init__(self, dim: int, depth: int, num_heads: int, downsample: bool,
                 dtype: torch.dtype = torch.float32, fused_attn_block: bool = False,
                 fused_whole: bool = False, drop_path_rates: Sequence[float] = (),
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        rates = list(drop_path_rates) or [0.0] * depth
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, 0 if i % 2 == 0 else WINDOW // 2, dtype,
                      fused_attn_block=fused_attn_block, fused_whole=fused_whole,
                      drop_path_rate=rates[i])
            for i in range(depth))
        self.downsample = PatchMerging(dim, dtype) if downsample else None

    def forward(self, x, generator: Optional[torch.Generator] = None):
        remat = _remat.active(self, self.remat)
        for block in self.blocks:
            x = _remat.run(block, x, generator) if remat else block(x, generator)
        return x, (x if self.downsample is None else self.downsample(x))


class PatchEmbed(nn.Module):
    def __init__(self, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, 4, stride=4)
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)


class SwinTiny(nn.Module):
    """`forward(x [B, H, W, 3])` returns 4 [B, h, w, C] feature maps (96,
    192, 384, 768 channels at strides 4/8/16/32) in the compute dtype;
    outputs 1-3 are LayerNormed. `block_forms` is one of `FORMS` for every
    stage, or one per stage. `drop_path_rate` is the last block's stochastic
    depth in training; block i of all 12 gets linspace(0, rate, 12)[i].
    `remat`: each block is recomputed in the backward when training with
    grad enabled."""

    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 dtype: torch.dtype = torch.float32,
                 block_forms: Union[str, Sequence[str]] = 'composed',
                 drop_path_rate: float = 0.2, remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.patch_embed = PatchEmbed(embed_dim)
        rates = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        starts = np.cumsum((0,) + tuple(depths)).tolist()
        self.layers = nn.ModuleList(
            SwinStage(embed_dim * 2 ** i, depth, num_heads[i],
                      downsample=i < len(depths) - 1, dtype=dtype,
                      drop_path_rates=rates[starts[i]:starts[i] + depth], remat=remat)
            for i, depth in enumerate(depths))
        for i in (1, 2, 3):
            setattr(self, f'norm{i}', nn.LayerNorm(embed_dim * 2 ** i, eps=LN_EPS))
        self.set_block_forms(block_forms)

    def set_block_forms(self, forms: Union[str, Sequence[str]]) -> None:
        """Switch every block of stage i to `forms[i]` (or all to `forms`);
        the parameters stay as they are."""
        forms = [forms] * len(self.layers) if isinstance(forms, str) else list(forms)
        if len(forms) != len(self.layers) or any(f not in FORMS for f in forms):
            raise ValueError(f'block forms must be one of {FORMS}, or one per stage for '
                             f'{len(self.layers)} stages, got {forms}')
        for stage, form in zip(self.layers, forms):
            for block in stage.blocks:
                block.fused_attn_block = form == 'attn_block'
                block.fused_whole = form == 'whole'

    def block_forms(self) -> Tuple[str, ...]:
        """The form of each stage's blocks, as `set_block_forms` set them."""
        return tuple('whole' if stage.blocks[0].fused_whole else
                     'attn_block' if stage.blocks[0].fused_attn_block else 'composed'
                     for stage in self.layers)

    def forward(self, x, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, ...]:
        """`generator` draws the stochastic depth in training."""
        h, w = x.shape[1:3]
        x = x.permute(0, 3, 1, 2)
        if h % 4 or w % 4:
            x = F.pad(x, (0, (4 - w % 4) % 4, 0, (4 - h % 4) % 4))
        proj = self.patch_embed.proj
        x = F.conv2d(x.to(self.dtype), proj.weight.to(self.dtype),
                     proj.bias.to(self.dtype), stride=4).permute(0, 2, 3, 1)
        x = _layer_norm(x, self.patch_embed.norm, self.dtype)
        outs = []
        for i, stage in enumerate(self.layers):
            out, x = stage(x, generator)
            if i > 0:
                out = _layer_norm(out, getattr(self, f'norm{i}'), self.dtype)
            outs.append(out)
        return tuple(outs)
