"""The port's whole-SwinBlock op (plain version, which the wrapper runs for
CPU tensors) against the JAX package: the Pallas kernel in interpret mode and
its XLA oracle, with and without window padding, shifted and unshifted."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolact_minimal_tpu.models import swin as jax_swin
from yolact_minimal_tpu.ops.swin_block import _block_xla, swin_block_fused
from yolact_minimal_torch.ops.attn_block import (HEAD_SHAPES, SHARED_MEMORY_LIMIT,
                                                 attn_block_plain)
from yolact_minimal_torch.ops.swin_block import (FLAT_LAUNCHES, GEMM_LAUNCHES, GEMM_ROWS,
                                                 GEMM_SHAPES, KERNEL_SHAPES, LN_ROWS,
                                                 SCRATCH_WIDTHS, WEIGHT_BOX_ROWS, FlatGeometry,
                                                 gemm_shape, kernel_geometry, launch_shapes,
                                                 scratch_bytes, shared_bytes, swin_block,
                                                 swin_block_plain)
from yolact_minimal_torch.ops.swin_mlp import mlp_block_plain

torch.set_num_threads(1)

N = 49
# float32, outputs of O(1): LayerNorm, four products of up to 384 terms and
# erf (against the JAX kernel's 1.5e-7 rational form), summed in another order.
F32_TOL = 2e-5
# bf16: the rounding places are the same, but a float32 sum that rounds to the
# other bf16 neighbour in the first half (qkv, p, the attention output, LN2's
# input row) is passed on through LayerNorm2 and two more products, so more
# than the last rounding differs: two bf16 ulps (2^-6) of the output's largest
# magnitude, with nearly all entries equal to the bit.
BF16_REL_TOL = 2.0 ** -6
# (map h, w, C, heads): 30x26 pads to 35x28, so boundary windows mix real
# and padding tokens; 28x28 and 14x14 need no padding (rowmask None)
GEOMETRIES = [(30, 26, 96, 3), (28, 28, 96, 3), (14, 14, 192, 6)]


def _inputs(h, w, c, heads, shift, seed=0):
    """JAX layout: x (windowed pre-norm rows of a [2, h, w, C] map), rowmask,
    ln1 scale/bias, wqkv [C, 3C], bqkv, bias, region, wproj, bproj, ln2
    scale/bias, k1 [C, 4C], b1, k2 [4C, C], b2."""
    rng = np.random.RandomState(seed)
    f32 = lambda a: a.astype(np.float32)
    hp, wp = -(-h // 7) * 7, -(-w // 7) * 7
    x = np.pad(f32(rng.randn(2, h, w, c)), ((0, 0), (0, hp - h), (0, wp - w), (0, 0)))
    if shift:
        x = np.roll(x, (-shift, -shift), axis=(1, 2))
    x = np.asarray(jax_swin.window_partition(jnp.asarray(x), 7))
    rowmask = jax_swin.pad_rowmask(h, w, hp, wp, shift)
    region = jax_swin.shifted_window_regions(hp, wp).astype(np.int32) if shift else None
    return (x, rowmask, f32(rng.randn(c) * 0.1 + 1.0), f32(rng.randn(c) * 0.1),
            f32(rng.randn(c, 3 * c) * 0.05), f32(rng.randn(3 * c) * 0.05),
            f32(rng.randn(heads, N, N) * 0.1), region,
            f32(rng.randn(c, c) * 0.05), f32(rng.randn(c) * 0.05),
            f32(rng.randn(c) * 0.1 + 1.0), f32(rng.randn(c) * 0.1),
            f32(rng.randn(c, 4 * c) * 0.05), f32(rng.randn(4 * c) * 0.05),
            f32(rng.randn(4 * c, c) * 0.05), f32(rng.randn(c) * 0.05))


WEIGHTS = (4, 8, 12, 14)          # positions of wqkv, wproj, k1, k2


def _ours(args, dtype=torch.float32):
    """The port takes nn.Linear's [out, in] layout; x and the
    relative-position bias in the compute dtype."""
    out = [None if a is None else torch.from_numpy(np.array(a)) for a in args]
    for i in WEIGHTS:
        out[i] = out[i].T.contiguous()
    out[0], out[6] = out[0].to(dtype), out[6].to(dtype)
    return tuple(out)


def _jax(args, dtype=jnp.float32):
    out = [None if a is None else jnp.asarray(a) for a in args]
    out[0], out[6] = out[0].astype(dtype), out[6].astype(dtype)
    return tuple(out)


@pytest.mark.parametrize('h,w,c,heads', GEOMETRIES)
@pytest.mark.parametrize('shift', [0, 3])
def test_plain_matches_jax_float32(h, w, c, heads, shift):
    args = _inputs(h, w, c, heads, shift)
    assert (args[1] is None) == (h % 7 == 0 and w % 7 == 0)
    ours = swin_block_plain(*_ours(args), heads).numpy()
    assert ours.shape == args[0].shape and np.abs(ours - args[0]).max() > 0.1
    for ref in (swin_block_fused(*_jax(args), heads), _block_xla(*_jax(args), heads)):
        np.testing.assert_allclose(ours, np.asarray(ref), rtol=0, atol=F32_TOL)
    if args[1] is not None:      # the rowmask matters on these inputs
        free = swin_block_plain(*_ours((args[0], None) + args[2:]), heads).numpy()
        assert np.abs(free - ours).max() > 1e-3


@pytest.mark.parametrize('shift', [0, 3])
def test_plain_matches_jax_bfloat16(shift):
    h, w, c, heads = 30, 26, 96, 3
    args = _inputs(h, w, c, heads, shift, seed=1)
    ours = swin_block_plain(*_ours(args, torch.bfloat16), heads)
    assert ours.dtype == torch.bfloat16
    # weights already in bf16 (what models/swin.py hands over) change nothing
    cast = list(_ours(args, torch.bfloat16))
    for i in WEIGHTS:
        cast[i] = cast[i].bfloat16()
    assert torch.equal(ours, swin_block_plain(*cast, heads))
    ours = ours.float().numpy()
    for ref in (swin_block_fused(*_jax(args, jnp.bfloat16), heads),
                _block_xla(*_jax(args, jnp.bfloat16), heads)):
        ref = np.asarray(ref.astype(jnp.float32))
        assert np.abs(ours - ref).max() <= BF16_REL_TOL * np.abs(ref).max()
        assert (ours == ref).mean() > 0.9


def test_plain_is_not_the_composition_of_the_half_blocks():
    """In bf16 the whole block keeps h in float32 between its halves and
    rounds the hidden activations once; composing the two half-block ops
    rounds h and rounds before the gelu too. Close, but not equal. In float32
    the two are the same function up to summation order."""
    h, w, c, heads = 28, 28, 96, 3
    for dtype, low, high in ((torch.bfloat16, 0.0, 2.0 ** -5), (torch.float32, -1.0, 1e-5)):
        (x, rowmask, l1s, l1b, wqkv, bqkv, bias, region, wproj, bproj, l2s, l2b, k1, b1, k2,
         b2) = _ours(_inputs(h, w, c, heads, 3, seed=2), dtype)
        whole = swin_block_plain(x, rowmask, l1s, l1b, wqkv, bqkv, bias, region, wproj, bproj,
                                 l2s, l2b, k1, b1, k2, b2, heads).float()
        xn = torch.nn.functional.layer_norm(x.float(), (c,), l1s, l1b, 1e-5).to(dtype)
        half = (x.float() + attn_block_plain(xn, wqkv, bqkv, bias, region, wproj, bproj,
                                             heads).float()).to(dtype)
        composed = mlp_block_plain(half.reshape(-1, c), l2s, l2b, k1, b1, k2, b2)
        diff = (whole - composed.reshape(whole.shape).float()).abs().max() / whole.abs().max()
        assert low < diff.item() < high, (dtype, diff.item())


def test_wrapper_runs_plain_on_cpu_and_checks_its_inputs():
    heads = 3
    args = _ours(_inputs(30, 26, 96, heads, 3))
    before = swin_block.launches
    assert torch.equal(swin_block(*args, heads), swin_block_plain(*args, heads))
    assert swin_block.launches == before                # no kernel on the CPU

    def swapped(i, t):
        return args[:i] + (t,) + args[i + 1:]
    with pytest.raises(ValueError, match='windows'):
        swin_block(*swapped(0, args[0][0]), heads)
    with pytest.raises(ValueError, match='rowmask must be'):
        swin_block(*swapped(1, args[1].double()), heads)
    with pytest.raises(ValueError, match='rowmask has 4 windows an image, region 20'):
        swin_block(*swapped(1, args[1][:4].contiguous()), heads)
    with pytest.raises(ValueError, match='k1 must be'):
        swin_block(*swapped(12, args[12].T.contiguous()), heads)
    with pytest.raises(ValueError, match='ln2_bias must be'):
        swin_block(*swapped(11, args[11].bfloat16()), heads)
    with pytest.raises(ValueError, match='bias must be'):
        swin_block(*swapped(6, args[6].bfloat16()), heads)
    with pytest.raises(ValueError, match='unsupported device'):
        swin_block(*(None if t is None else t.to('meta') for t in args), heads)


# Window counts for the bf16 kernels' launches: small ones against tiles of
# 1-3 windows, counts either side of a 132-multiprocessor grid, and the four
# stages' counts of swin_tiny at 544, batch 16 (6400, 1600, 400, 144).
GEOMETRY_BNW = [1, 2, 3, 4, 5, 131, 132, 133, 264, 265, 395, 397, 144, 400, 1600, 6400]


def _check_flat_walks(geo, bnw, c, sms):
    """C = 768: the attention walks every window once for each head; each
    product walks every (row tile, column tile) of the flat rows once, on
    persistent blocks; the LayerNorms' warps walk every row once; the grids
    the wrapper passes are these, in the range the kernel accepts."""
    assert isinstance(geo, FlatGeometry) and geo.rows == 49 * bnw
    assert geo.heads == c // 32 and geo.blocks == geo.heads * geo.chunks
    for head in range(geo.heads):
        walks = [geo.windows(b, g) for b in range(head, geo.blocks, geo.heads)
                 for g in range(geo.warpgroups)]
        assert sorted(w for walk in walks for w in walk) == list(range(bnw))
        assert geo.rounds == max(len(walk) for walk in walks)
    assert (geo.ln_blocks - 1) * LN_ROWS < geo.rows <= geo.ln_blocks * LN_ROWS
    ln_walks = [range(b * LN_ROWS + w, geo.rows, geo.ln_blocks * LN_ROWS)
                for b in range(geo.ln_blocks) for w in range(LN_ROWS)]
    assert sorted(r for walk in ln_walks for r in walk) == list(range(geo.rows))
    assert geo.grids == (geo.ln_blocks, geo.blocks, geo.gemm_blocks[0], geo.ln_blocks,
                         geo.gemm_blocks[1], geo.gemm_blocks[2])
    assert (geo.row_tiles - 1) * GEMM_ROWS < geo.rows <= geo.row_tiles * GEMM_ROWS
    for i, launch in enumerate(GEMM_LAUNCHES):
        width, _, per_sm = GEMM_SHAPES[launch]
        cols = gemm_shape(launch, c)[1] // width
        tiles = geo.row_tiles * cols
        assert geo.col_tiles[i] == cols and 1 <= geo.gemm_blocks[i] == min(per_sm * sms, tiles)
        walks = [geo.tiles(launch, b) for b in range(geo.gemm_blocks[i])]
        seen = sorted(t for walk in walks for t in walk)
        assert seen == [(r, col) for r in range(geo.row_tiles) for col in range(cols)]
        assert geo.gemm_rounds(launch) == -(-tiles // geo.gemm_blocks[i]) == \
            max(len(walk) for walk in walks)
        assert min(len(walk) for walk in walks) >= geo.gemm_rounds(launch) - 1


@pytest.mark.parametrize('c', [96, 192, 384, 768])
@pytest.mark.parametrize('bnw', GEOMETRY_BNW)
@pytest.mark.parametrize('sms', [132, 7])
def test_kernel_geometry_walks_every_window_once(c, bnw, sms):
    geo = kernel_geometry(bnw, c, sms)
    if c in SCRATCH_WIDTHS:     # the flat form: windows, then row tiles
        _check_flat_walks(geo, bnw, c, sms)
        return
    g = KERNEL_SHAPES[c][0]
    assert geo.windows_per_tile == g and geo.tiles == -(-bnw // g)
    # persistent: one block a multiprocessor at most
    assert 1 <= geo.blocks <= min(sms, geo.tiles)
    walks = [geo.windows(b) for b in range(geo.blocks)]
    # tiles of consecutive windows, G each but the last
    assert all(len(r) == g for walk in walks for r in walk if r.stop < bnw)
    seen = sorted(w for walk in walks for r in walk for w in r)
    assert seen == list(range(bnw))
    # the rounds as stated: the most tiles a block walks, every block busy
    # in all rounds but the last
    assert geo.rounds == -(-geo.tiles // geo.blocks) == max(len(walk) for walk in walks)
    assert min(len(walk) for walk in walks) >= geo.rounds - 1


@pytest.mark.parametrize('c', sorted(KERNEL_SHAPES))
def test_kernel_shape_respects_its_limits(c):
    """The limits csrc/swin_block.cu's header states for each tiled width: per
    window the LN tile [64, C], the attention-output tile and its q, k, v
    tiles with h [49, C] float32 over them and, with the columns split, a
    second set of q, k, v tiles and a gelu tile; uses of whole k-blocks; TMA
    boxes of at most 256 rows; a ring of at least 3 slots; shared memory
    within an H100 block's 227 KB; a warpgroup's columns in pieces of 96."""
    g, cs, stages, kq, k1 = KERNEL_SHAPES[c]
    kb = -(-c // 64)
    tile = kb * 64 * 128
    assert 1 <= g * cs <= 4 and stages >= 3 and c % (96 * cs) == 0
    assert kb % kq == 0 and kb % k1 == 0
    assert max(WEIGHT_BOX_ROWS) <= 256 and 96 * cs <= 256
    window = max(2 * tile + (2 if cs > 1 else 1) * 3 * 64 * 64, 49 * c * 4 + tile) + \
        (64 * 128 if cs > 1 else 0)
    slot = max(96 * kq, 64 * k1, 96 * cs) * 128
    (size,) = shared_bytes(c)
    assert g * window + stages * slot < size <= SHARED_MEMORY_LIMIT


def test_flat_form_respects_its_limits():
    """The limits csrc/swin_block.cu's header states for C = 768: TMA boxes of
    at most 256 rows (the attention's 64-row x and 32-row wqkv boxes, the
    products' A and B tiles); product tiles that two warpgroups take on wgmma
    (64 rows each, a width that is a multiple of 8 up to 256) from whole
    64-wide k-blocks and column tiles; a ring of at least 3 slots; each
    launch's shared memory within an H100 block's 227 KB, and the blocks
    that share a multiprocessor within its 228 KB (1 KB of each reserved); a
    scratch of the four buffers the launches pass on."""
    c = 768
    sizes = dict(zip(FLAT_LAUNCHES, shared_bytes(c)))
    assert len(sizes) == len(FLAT_LAUNCHES) == 6
    assert sizes['ln1'] == sizes['ln2'] == 0 and 32 * LN_ROWS <= 1024
    assert 0 < sizes['heads'] <= SHARED_MEMORY_LIMIT
    assert GEMM_ROWS == 2 * 64 and set(GEMM_SHAPES) == set(GEMM_LAUNCHES)
    for launch in GEMM_LAUNCHES:
        width, stages, per_sm = GEMM_SHAPES[launch]
        k, n = gemm_shape(launch, c)
        assert width % 8 == 0 and max(64, 32, GEMM_ROWS, width) <= 256
        assert k % 64 == 0 and n % width == 0 and stages >= 3 and per_sm >= 1
        ring = stages * (GEMM_ROWS + width) * 64 * 2
        assert ring < sizes[launch] <= SHARED_MEMORY_LIMIT
        assert per_sm * (sizes[launch] + 1024) <= 233472
    rows = 144 * 49
    assert scratch_bytes(144, c) == rows * 4 * c * 2 + rows * c * 4 + 2 * rows * c * 2


@pytest.mark.parametrize('c', [96, 192, 384, 768])
def test_launch_shapes_name_each_launch(c):
    """One entry a launch, in the order they run, at every width: the tiled
    kernel's (G, CS, ring slots), or the flat form's six, each as the module's
    constants state it; shared_bytes gives one size for each."""
    shapes = launch_shapes(c)
    assert len(shared_bytes(c)) == len(shapes)
    if c in KERNEL_SHAPES:
        assert shapes == {'tiled': KERNEL_SHAPES[c][:3]}
        return
    assert tuple(shapes) == FLAT_LAUNCHES
    assert shapes['ln1'] == shapes['ln2'] == (LN_ROWS,)
    assert shapes['heads'] == HEAD_SHAPES[c]
    for launch in GEMM_LAUNCHES:
        assert shapes[launch] == (GEMM_ROWS,) + GEMM_SHAPES[launch]


def test_launch_shapes_rejects_other_widths():
    with pytest.raises(ValueError, match='launch_shapes'):
        launch_shapes(64)


def test_kernel_geometry_rejects_bad_arguments():
    for args in ((0, 96, 132), (10, 64, 132), (10, 96, 0)):
        with pytest.raises(ValueError, match='kernel_geometry'):
            kernel_geometry(*args)
