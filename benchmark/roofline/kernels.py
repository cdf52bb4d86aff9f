"""Bytes and operations of the program's hand-written kernels, from the
shapes of a launch: each input byte read once, each output byte written
once, and the operations the algorithm needs.

  * mask finalize (kernel 2): reads proto [B, ph, pw, C] float32, coefs
    [B, D, C] and boxes [B, D, 4] float32, valid [B, D] bool; writes bool
    [B, D, S, S]. Operations: the lincomb over the whole proto plane, which
    is more than a cropped slot needs; the bytes bound it either way.
  * window attention (kernel 3): reads qkv [W*49, 3C] and the bias [h, 49,
    49] in the compute dtype, and the region ids [nW, 49] int32 of a
    shifted block; writes [W*49, C]. Operations: q k^T and p v, 4 * rows *
    49 * C.
  * swin MLP (kernel 4): reads x [R, C] and the weights fc1 [4C, C], fc2
    [C, 4C] in the compute dtype, the LayerNorm and bias vectors in
    float32; writes [R, C]. Operations: the two products, 16 * R * C^2.
"""
from __future__ import annotations

from typing import List, Optional

TOKENS = 49


def mask_finalize(batch: int, slots: int, ph: int, pw: int, coef: int, out: int):
    """(bytes, operations) of one launch."""
    n_bytes = 4 * batch * ph * pw * coef + 4 * batch * slots * (coef + 4) + batch * slots \
        + batch * slots * out * out
    return n_bytes, 2 * batch * slots * ph * pw * coef


def window_attention(windows: int, n_win: int, heads: int, c: int, shifted: bool,
                     elem: int = 2):
    rows = windows * TOKENS
    n_bytes = elem * (rows * 3 * c + rows * c + heads * TOKENS * TOKENS) \
        + (4 * n_win * TOKENS if shifted else 0)
    return n_bytes, 4 * rows * TOKENS * c


def swin_mlp(rows: int, c: int, elem: int = 2):
    n_bytes = elem * (2 * rows * c + 8 * c * c) + 4 * (2 * c + 4 * c + c)
    return n_bytes, 16 * rows * c * c


def swin_stages(model_spec: dict, batch: int, size: int) -> Optional[List[dict]]:
    """Each swin stage's map at a cell's shapes: h (= w), the padded side,
    the windows of the batch and of one image, heads, width, MLP rows."""
    bb = model_spec['backbone']
    if bb['kind'] != 'swin':
        return None
    win = bb['window']
    side = -(-size // bb['patch_size'])
    out = []
    for i, heads in enumerate(bb['num_heads']):
        padded = -(-side // win) * win
        n_win = (padded // win) ** 2
        out.append(dict(side=side, padded=padded, n_win=n_win, windows=batch * n_win,
                        heads=heads, c=bb['embed_dim'] * 2 ** i, rows=batch * side * side,
                        depth=bb['depths'][i]))
        side = -(-side // 2)
    return out
