"""The port's attention half-block (plain version, which the wrapper runs for
CPU tensors) against the JAX package: the Pallas kernel in interpret mode and
its XLA oracle, masked and unmasked, at the four swin stage geometries."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolact_minimal_tpu.models.swin import shifted_window_regions as jax_regions
from yolact_minimal_tpu.ops.window_attention import _block_xla, window_attention_block_fused
from yolact_minimal_torch.ops.attn_block import attn_block, attn_block_plain

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
