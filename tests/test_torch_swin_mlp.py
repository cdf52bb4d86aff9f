"""The port's swin MLP half-block (plain version, which the wrapper runs for
CPU tensors) against the JAX package: the Pallas kernel in interpret mode and
its XLA oracle, at every stage width and at ragged row counts."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolact_minimal_tpu.ops.swin_mlp import _mlp_xla, mlp_block_fused
from yolact_minimal_torch.ops.swin_mlp import mlp_block, mlp_block_plain

torch.set_num_threads(1)

# float32, outputs of O(1) (|y| < 16): sums of up to 3072 products in another
# order, and erf against the JAX kernel's 1.5e-7 rational form.
F32_TOL = 1e-5
# bf16: same rounding places on both sides; a float32 sum may round to the
# other bf16 neighbour, one ulp of outputs up to ~4 (2^-6), and the hidden
# layer passes a flipped input on.
BF16_TOL = 3e-2


def _params(c, seed=0):
    """JAX layout: ln scale/bias [C], k1 [C, 4C], b1, k2 [4C, C], b2."""
    rng = np.random.RandomState(seed)
    return (rng.randn(c).astype(np.float32) * 0.1 + 1.0,
            rng.randn(c).astype(np.float32) * 0.1,
            rng.randn(c, 4 * c).astype(np.float32) * 0.05,
            rng.randn(4 * c).astype(np.float32) * 0.05,
            rng.randn(4 * c, c).astype(np.float32) * 0.05,
            rng.randn(c).astype(np.float32) * 0.05)


def _ours(p):
    """The port takes nn.Linear's [out, in] layout."""
    lns, lnb, k1, b1, k2, b2 = (torch.from_numpy(a) for a in p)
    return lns, lnb, k1.T.contiguous(), b1, k2.T.contiguous(), b2


# 1156 = 4 * 17^2 and 203 are not multiples of 8
@pytest.mark.parametrize('c,rows', [(96, 1024), (192, 512), (384, 1156), (768, 168),
                                    (96, 203)])
def test_plain_matches_jax_float32(c, rows):
    x = np.random.RandomState(1).randn(rows, c).astype(np.float32)
    p = _params(c)
    ours = mlp_block_plain(torch.from_numpy(x), *_ours(p)).numpy()
    assert ours.shape == (rows, c) and np.abs(ours).max() < 16
    jp = [jnp.asarray(a) for a in p]
    for ref in (mlp_block_fused(jnp.asarray(x), *jp), _mlp_xla(jnp.asarray(x), *jp)):
        np.testing.assert_allclose(ours, np.asarray(ref), rtol=0, atol=F32_TOL)
    assert np.abs(ours - x).max() > 0.1             # the MLP term is not lost


@pytest.mark.parametrize('c,rows', [(96, 512), (192, 203)])
def test_plain_matches_jax_bfloat16(c, rows):
    x = np.random.RandomState(2).randn(rows, c).astype(np.float32)
    p = _params(c)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    ours = mlp_block_plain(xb, *_ours(p))
    assert ours.dtype == torch.bfloat16
    # weights already in bf16 (what models/swin.py hands over) change nothing
    lns, lnb, k1, b1, k2, b2 = _ours(p)
    again = mlp_block_plain(xb, lns, lnb, k1.bfloat16(), b1, k2.bfloat16(), b2)
    assert torch.equal(ours, again)
    ours = ours.float().numpy()
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jp = [jnp.asarray(a) for a in p]
    for ref in (mlp_block_fused(jx, *jp), _mlp_xla(jx, *jp)):
        ref = np.asarray(ref.astype(jnp.float32))
        np.testing.assert_allclose(ours, ref, rtol=0, atol=BF16_TOL)
        assert (ours == ref).mean() > 0.9


def test_wrapper_runs_plain_on_cpu_and_checks_its_inputs():
    x = torch.from_numpy(np.random.RandomState(3).randn(40, 96).astype(np.float32))
    p = _ours(_params(96))
    before = mlp_block.launches
    assert torch.equal(mlp_block(x, *p), mlp_block_plain(x, *p))
    assert mlp_block.launches == before                 # no kernel on the CPU
    with pytest.raises(ValueError, match='rows'):
        mlp_block(x[None], *p)
    with pytest.raises(ValueError, match='k1 must be'):
        mlp_block(x, p[0], p[1], p[2].T.contiguous(), *p[3:])
    with pytest.raises(ValueError, match='b1 must be'):
        mlp_block(x, p[0], p[1], p[2], p[3].bfloat16(), p[4], p[5])
    with pytest.raises(ValueError, match='unsupported device'):
        mlp_block(x.to('meta'), *(t.to('meta') for t in p))
