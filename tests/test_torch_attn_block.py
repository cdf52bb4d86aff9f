"""The port's attention half-block (plain version, which the wrapper runs for
CPU tensors) against the JAX package: the Pallas kernel in interpret mode and
its XLA oracle, masked and unmasked, at the four swin stage geometries; and
the bf16 kernel's launch geometry and shared-memory plan."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolact_minimal_tpu.models.swin import shifted_window_regions as jax_regions
from yolact_minimal_tpu.ops.window_attention import _block_xla, window_attention_block_fused
from yolact_minimal_torch.ops.attn_block import (HEAD_SHAPES, PROJ_SHAPES, ROW_TILE,
                                                 SHARED_MEMORY_LIMIT, TILED_WINDOWS,
                                                 WINDOW_ROWS, Geometry, TwoPhaseGeometry,
                                                 attn_block, attn_block_plain,
                                                 kernel_geometry, shared_bytes)

torch.set_num_threads(1)

N = 49
# (heads, dim, hp): the swin_tiny stages at img_size 224, as the JAX
# package's own kernel test uses them
STAGES = [(3, 96, 56), (6, 192, 28), (12, 384, 14), (24, 768, 7)]
# float32: both sides sum up to 768 products in float32, in another order.
F32_TOL = 1e-5


def _inputs(heads, c, hp, masked, seed=0):
    """JAX layout: x, wqkv [C, 3C], bqkv, bias, region, wproj [C, C], bproj."""
    rng = np.random.RandomState(seed)
    nw = (hp // 7) ** 2
    f32 = lambda a: a.astype(np.float32)
    return (f32(rng.randn(2 * nw, N, c)), f32(rng.randn(c, 3 * c) * 0.05),
            f32(rng.randn(3 * c) * 0.05), f32(rng.randn(heads, N, N) * 0.1),
            jax_regions(hp, hp).astype(np.int32) if masked else None,
            f32(rng.randn(c, c) * 0.05), f32(rng.randn(c) * 0.05))


def _ours(args, dtype=torch.float32):
    """The port takes nn.Linear's [out, in] layout; x and the
    relative-position bias in the compute dtype."""
    t = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a))
    x, wqkv, bqkv, bias, region, wproj, bproj = (t(a) for a in args)
    return (x.to(dtype), wqkv.T.contiguous(), bqkv, bias.to(dtype), region,
            wproj.T.contiguous(), bproj)


def _jax(args, dtype=jnp.float32):
    x, wqkv, bqkv, bias, region, wproj, bproj = (None if a is None else jnp.asarray(a)
                                                 for a in args)
    return x.astype(dtype), wqkv, bqkv, bias.astype(dtype), region, wproj, bproj


@pytest.mark.parametrize('heads,c,hp', STAGES)
@pytest.mark.parametrize('masked', [False, True])
def test_plain_matches_jax_float32(heads, c, hp, masked):
    args = _inputs(heads, c, hp, masked)
    ours = attn_block_plain(*_ours(args), heads).numpy()
    assert ours.shape == args[0].shape and np.abs(ours).max() > 0.1
    for ref in (window_attention_block_fused(*_jax(args), heads), _block_xla(*_jax(args), heads)):
        np.testing.assert_allclose(ours, np.asarray(ref), rtol=0, atol=F32_TOL)
    if masked:      # the mask matters on these inputs
        free = attn_block_plain(*_ours(args[:4] + (None,) + args[5:]), heads).numpy()
        assert np.abs(free - ours).max() > 1e-3


@pytest.mark.parametrize('masked', [False, True])
def test_plain_matches_jax_bfloat16(masked):
    heads, c, hp = 3, 96, 28
    args = _inputs(heads, c, hp, masked, seed=1)
    ours = attn_block_plain(*_ours(args, torch.bfloat16), heads)
    assert ours.dtype == torch.bfloat16
    # weights already in bf16 (what models/swin.py hands over) change nothing
    x, wqkv, bqkv, bias, region, wproj, bproj = _ours(args, torch.bfloat16)
    again = attn_block_plain(x, wqkv.bfloat16(), bqkv, bias, region, wproj.bfloat16(), bproj,
                             heads)
    assert torch.equal(ours, again)
    ours = ours.float().numpy()
    # The kernel rounds the weights to bf16, as the port does; the JAX oracle
    # multiplies by the float32 weights, so it agrees within the limit but
    # not to the bit.
    for ref, same in ((window_attention_block_fused(*_jax(args, jnp.bfloat16), heads), 0.9),
                      (_block_xla(*_jax(args, jnp.bfloat16), heads), 0.3)):
        ref = np.asarray(ref.astype(jnp.float32))
        # the same rounding places on both sides: a difference is a float32
        # sum that rounds to the other bf16 neighbour, one bf16 ulp (2^-7) of
        # the output's largest magnitude
        assert np.abs(ours - ref).max() <= 2.0 ** -7 * np.abs(ref).max()
        # and not a float32 result in disguise: most entries agree to the bit
        assert (ours == ref).mean() > same


def test_wrapper_runs_plain_on_cpu_and_checks_its_inputs():
    heads = 3
    args = _ours(_inputs(heads, 96, 14, True))
    x, wqkv, bqkv, bias, region, wproj, bproj = args
    before = attn_block.launches
    assert torch.equal(attn_block(*args, heads), attn_block_plain(*args, heads))
    assert attn_block.launches == before                # no kernel on the CPU
    with pytest.raises(ValueError, match='windows'):
        attn_block(x[0], *args[1:], heads)
    with pytest.raises(ValueError, match='wqkv must be'):
        attn_block(x, wqkv.T.contiguous(), *args[2:], heads)
    with pytest.raises(ValueError, match='bproj must be'):
        attn_block(*args[:6], bproj.bfloat16(), heads)
    with pytest.raises(ValueError, match='bias must be'):
        attn_block(x, wqkv, bqkv, bias.bfloat16(), region, wproj, bproj, heads)
    with pytest.raises(ValueError, match='region must be'):
        attn_block(x, wqkv, bqkv, bias, region.long(), wproj, bproj, heads)
    with pytest.raises(ValueError, match='whole number of images'):
        attn_block(x[:5].contiguous(), *args[1:], heads)
    with pytest.raises(ValueError, match='unsupported device'):
        attn_block(*(None if t is None else t.to('meta') for t in args), heads)


# Window counts for the bf16 kernel's launch: small ones against tiles of 3
# windows and against phase 1's warpgroups (chunks x warpgroups: 66 / 33 /
# 10 on 132 multiprocessors), counts either side of a 132-multiprocessor
# grid and of its multiples, and the four stages' counts of swin_tiny at 544,
# batch 16 (6400, 1600, 400, 144).
GEOMETRY_BNW = [1, 2, 3, 4, 5, 6, 7, 9, 10, 11, 32, 33, 34, 65, 66, 67, 131, 132, 133, 264,
                265, 395, 396, 397, 144, 400, 1600, 6400]


@pytest.mark.parametrize('c', [96, 192, 384, 768])
@pytest.mark.parametrize('bnw', GEOMETRY_BNW)
@pytest.mark.parametrize('sms', [132, 7])
def test_kernel_geometry_walks_every_window_once(c, bnw, sms):
    geo = kernel_geometry(bnw, c, sms)
    if c in TILED_WINDOWS:
        g = TILED_WINDOWS[c]
        assert isinstance(geo, Geometry)
        assert geo.windows_per_tile == g and geo.tiles == -(-bnw // g)
        assert 1 <= geo.blocks <= min(sms, geo.tiles)   # persistent: one a multiprocessor
        walks = [geo.windows(b) for b in range(geo.blocks)]
        # tiles of consecutive windows, G each but a last partial one
        assert all(len(r) == g for walk in walks for r in walk if r.stop < bnw)
        assert all(1 <= len(r) <= g for walk in walks for r in walk)
        seen = sorted(w for walk in walks for r in walk for w in r)
        assert seen == list(range(bnw))
        # the rounds as stated: the most tiles a block walks, every block busy
        # in all rounds but the last
        assert geo.rounds == -(-geo.tiles // geo.blocks) == max(len(walk) for walk in walks)
        assert min(len(walk) for walk in walks) >= geo.rounds - 1
        return
    assert isinstance(geo, TwoPhaseGeometry)
    heads = c // 32
    assert geo.heads == heads and geo.warpgroups == HEAD_SHAPES[c][0]
    assert 1 <= geo.chunks and (geo.chunks == 1 or geo.blocks <= sms)
    # phase 1: every (head, window) pair exactly once, spread evenly
    for h in range(heads):
        walks = [list(geo.windows(b, wg)) for b in range(h, geo.blocks, heads)
                 for wg in range(geo.warpgroups)]
        assert sorted(w for walk in walks for w in walk) == list(range(bnw))
        assert max(len(walk) for walk in walks) == geo.rounds
        assert min(len(walk) for walk in walks) >= geo.rounds - 1
    assert all(b % heads == h for h in range(heads) for b in range(h, geo.blocks, heads))
    # phase 2: every row tile of the output exactly once, in groups of
    # consecutive tiles, all full but the last
    n = PROJ_SHAPES[c][0]
    assert geo.tiles_per_group == n
    assert geo.row_tiles * ROW_TILE >= bnw * 49 > (geo.row_tiles - 1) * ROW_TILE
    assert 1 <= geo.proj_blocks <= min(sms, -(-geo.row_tiles // n))
    groups = [r for b in range(geo.proj_blocks) for r in geo.tiles(b)]
    assert all(len(r) == n for r in groups if r.stop < geo.row_tiles)
    assert sorted(t for r in groups for t in r) == list(range(geo.row_tiles))


@pytest.mark.parametrize('c', [96, 192, 384, 768])
def test_shared_memory_plan_fits(c):
    """The limits csrc/attn_block.cu's header states for each width. Tiled
    (C = 96): 3 windows a tile, 56 rows apart, so that a window's 49 rows
    and its 64-row product tile fit; swizzle atoms of 1024 bytes; both
    weight matrices resident (every head's q | k | v rows and all proj rows,
    the k-tail padded to 64). Two phases: the head's 96 rows of wqkv and
    each warpgroup's ring of x k-blocks (at least 3 slots) and k, v tiles;
    phase 2 one or two groups of 64-row tiles, a warpgroup a tile and column
    group, and a ring of at least 3 slots of 96 proj rows for each column
    group, whose columns split C in pieces of 96. Every block within an
    H100 block's 227 KB."""
    kb = -(-c // 64)
    sizes = shared_bytes(c)
    if c in TILED_WINDOWS:
        g = TILED_WINDOWS[c]
        assert 49 <= WINDOW_ROWS and WINDOW_ROWS % 8 == 0 and WINDOW_ROWS + 8 >= 64
        assert ((g * WINDOW_ROWS + 8) * 128) % 1024 == 0
        weights = 4 * c * kb * 64 * 2
        tiles = 2 * kb * (g * WINDOW_ROWS + 8) * 128
        assert len(sizes) == 1 and weights + tiles < sizes[0] <= SHARED_MEMORY_LIMIT
        return
    wgn, xs = HEAD_SHAPES[c]
    rw, cs, stages, abuf = PROJ_SHAPES[c]
    assert len(sizes) == 2 and xs >= 3 and 1 <= wgn <= 3 and 1 <= rw * cs <= 4
    assert c % 64 == 0 and c % (96 * cs) == 0 and stages >= 3 and abuf in (1, 2)
    assert kb * 96 * 128 + wgn * xs * 64 * 128 < sizes[0] <= SHARED_MEMORY_LIMIT
    assert abuf * rw * kb * 64 * 128 + stages * cs * 96 * 128 < sizes[1] <= SHARED_MEMORY_LIMIT


def test_kernel_geometry_rejects_bad_arguments():
    for args in ((0, 96, 132), (-3, 192, 132), (10, 64, 132), (10, 1536, 132), (10, 96, 0)):
        with pytest.raises(ValueError, match='kernel_geometry'):
            kernel_geometry(*args)
