"""The port's window attention (plain version, which the wrapper runs for CPU
tensors) against the JAX package: the Pallas kernel in interpret mode and its
XLA oracle, masked and unmasked, at the four swin stage geometries."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolact_minimal_tpu.models.swin import shifted_window_regions as jax_regions
from yolact_minimal_tpu.ops.window_attention import _attention_xla, window_attention_fused
from yolact_minimal_torch.ops.window_attention import (BLOCKS_PER_SM, GROUPS_PER_BLOCK,
                                                       kernel_geometry, window_attention,
                                                       window_attention_plain)

torch.set_num_threads(1)

N = 49
# (heads, dim, hp): the swin_tiny stages at img_size 224, as the JAX
# package's own kernel test uses them
STAGES = [(3, 96, 56), (6, 192, 28), (12, 384, 14), (24, 768, 7)]
# float32: both sides sum 32 and 49 products in float32, in another order.
F32_TOL = 1e-5
# bf16: the rounding places are the same on both sides, so a difference is a
# float32 sum that rounds to the other bf16 neighbour: one ulp of outputs up
# to ~4, 2^-6.
BF16_TOL = 2e-2


def _inputs(heads, c, hp, masked, seed=0):
    rng = np.random.RandomState(seed)
    nw = (hp // 7) ** 2
    qkv = rng.randn(2 * nw, N, 3 * c).astype(np.float32)
    bias = (rng.randn(heads, N, N) * 0.1).astype(np.float32)
    region = jax_regions(hp, hp).astype(np.int32) if masked else None
    return qkv, bias, region


def _torch(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(
        dtype if a.dtype == np.float32 else torch.int32)


@pytest.mark.parametrize('heads,c,hp', STAGES)
@pytest.mark.parametrize('masked', [False, True])
def test_plain_matches_jax_float32(heads, c, hp, masked):
    qkv, bias, region = _inputs(heads, c, hp, masked)
    jreg = None if region is None else jnp.asarray(region)
    ours = window_attention_plain(_torch(qkv), _torch(bias), _torch(region), heads).numpy()
    assert ours.shape == (qkv.shape[0], N, c)
    for ref in (window_attention_fused(jnp.asarray(qkv), jnp.asarray(bias), jreg, heads),
                _attention_xla(jnp.asarray(qkv), jnp.asarray(bias), jreg, heads)):
        np.testing.assert_allclose(ours, np.asarray(ref), rtol=0, atol=F32_TOL)
    if masked:      # the mask matters on these inputs
        free = window_attention_plain(_torch(qkv), _torch(bias), None, heads).numpy()
        assert np.abs(free - ours).max() > 1e-2


@pytest.mark.parametrize('masked', [False, True])
def test_plain_matches_jax_bfloat16(masked):
    heads, c, hp = 3, 96, 28
    qkv, bias, region = _inputs(heads, c, hp, masked, seed=1)
    jreg = None if region is None else jnp.asarray(region)
    jq, jb = jnp.asarray(qkv).astype(jnp.bfloat16), jnp.asarray(bias).astype(jnp.bfloat16)
    ours = window_attention_plain(_torch(qkv, torch.bfloat16), _torch(bias, torch.bfloat16),
                                  _torch(region), heads)
    assert ours.dtype == torch.bfloat16
    ours = ours.float().numpy()
    for ref in (window_attention_fused(jq, jb, jreg, heads), _attention_xla(jq, jb, jreg, heads)):
        ref = np.asarray(ref.astype(jnp.float32))
        np.testing.assert_allclose(ours, ref, rtol=0, atol=BF16_TOL)
        # and not a float32 result in disguise: most entries agree to the bit
        assert (ours == ref).mean() > 0.9


def test_wrapper_runs_plain_on_cpu_and_checks_its_inputs():
    qkv, bias, region = _inputs(3, 96, 14, True)
    before = window_attention.launches
    out = window_attention(_torch(qkv), _torch(bias), _torch(region), 3)
    assert window_attention.launches == before          # no kernel on the CPU
    assert torch.equal(out, window_attention_plain(_torch(qkv), _torch(bias),
                                                   _torch(region), 3))
    with pytest.raises(ValueError, match='bias must be'):
        window_attention(_torch(qkv), _torch(bias, torch.bfloat16), None, 3)
    with pytest.raises(ValueError, match='region must be'):
        window_attention(_torch(qkv), _torch(bias), _torch(region).long(), 3)
    with pytest.raises(ValueError, match='whole number of images'):
        window_attention(_torch(qkv)[:5].contiguous(), _torch(bias), _torch(region), 3)
    with pytest.raises(ValueError, match='unsupported device'):
        window_attention(_torch(qkv).to('meta'), _torch(bias).to('meta'), None, 3)


# (windows B*nW, heads): swin_tiny's four stages at 544, batch 16, and window
# counts that no grid divides
GEOMETRY_CASES = [(6400, 3), (1600, 6), (400, 12), (144, 24),
                  (1, 3), (2, 6), (131, 12), (133, 24), (6400, 24)]


@pytest.mark.parametrize('bnw,heads', GEOMETRY_CASES)
@pytest.mark.parametrize('sms', [132, 114, 1])
def test_kernel_geometry_walks_every_unit_once(bnw, heads, sms):
    geo = kernel_geometry(bnw, heads, sms)
    assert 1 <= geo.blocks <= max(sms * BLOCKS_PER_SM, -(-heads // GROUPS_PER_BLOCK))
    assert geo.groups % heads == 0 and geo.groups // heads == geo.per_head <= bnw
    assert geo.blocks == -(-geo.groups // GROUPS_PER_BLOCK)
    walked = [u for b in range(geo.blocks) for u in geo.units(b)]
    assert sorted(walked) == [(w, h) for w in range(bnw) for h in range(heads)]
    # the groups walk within one unit of each other
    counts = [len(range(g // heads, bnw, geo.per_head)) for g in range(geo.groups)]
    assert sum(counts) == bnw * heads and max(counts) - min(counts) <= 1
    if sms * BLOCKS_PER_SM * GROUPS_PER_BLOCK >= heads * min(bnw, 2):
        assert geo.per_head == min(bnw, sms * BLOCKS_PER_SM * GROUPS_PER_BLOCK // heads)
