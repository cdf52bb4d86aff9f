"""Bytes and operations of kernel 3 (window attention) at any window: N =
window * window tokens, each input byte read once and each output byte
written once, as `kernels.window_attention` counts them at N = 49.

  * reads qkv [W*N, 3C] and the bias [h, N, N] in the compute dtype, and
    the region ids [nW, N] int32 of a shifted block; writes [W*N, C].
  * operations: q k^T and p v, 4 * rows * N * C.
"""
from __future__ import annotations

import math


def stage_tokens(stage: dict) -> int:
    """N of a stage of `kernels.swin_stages`: its padded side over its
    windows a side, squared."""
    return (stage['padded'] // math.isqrt(stage['n_win'])) ** 2


def window_attention(windows: int, n_win: int, heads: int, c: int, shifted: bool,
                     tokens: int, elem: int = 2):
    """(bytes, operations) of one launch."""
    rows = windows * tokens
    n_bytes = elem * (rows * 3 * c + rows * c + heads * tokens * tokens) \
        + (4 * n_win * tokens if shifted else 0)
    return n_bytes, 4 * rows * tokens * c
