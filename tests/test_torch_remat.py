"""`--remat` on the CPU: one train_step with cfg.remat against the same step
without it, from the same weights on the same batch and the same step
generator, for res50 and for swin with stochastic depth on (drop_path_rate
0.2). The backward recomputes each backbone block, and nothing else may
change: the four losses, every gradient, BatchNorm's running statistics
and `num_batches_tracked` (updated once a step, not again by the
recompute), and the generator's state after the step (the recompute draws
drop_path's keep masks again from where the forward drew them, then leaves
the generator where the plain step leaves it). Both steps run the same
operations in the same order, so they are held bit for bit. The JAX
package's `remat=True` step is held in test_torch_train_step.py."""
import numpy as np
import pytest
import torch

from yolact_minimal_torch import train_state as TS
from yolact_minimal_torch.config import get_config
from yolact_minimal_torch.models import remat
from yolact_minimal_torch.models.resnet import Bottleneck
from yolact_minimal_torch.models.swin import SwinBlock

torch.set_num_threads(1)

IMG = 64


def _batch(seed, b, g, img):
    rng = np.random.RandomState(seed)
    xy1 = rng.uniform(0, 0.5, size=(b, g, 2)).astype(np.float32)
    wh = rng.uniform(0.2, 0.45, size=(b, g, 2)).astype(np.float32)
    return dict(image=rng.randn(b, img, img, 3).astype(np.float32),
                boxes=np.concatenate([xy1, xy1 + wh], 2),
                labels=rng.randint(0, 4, size=(b, g)).astype(np.int32),
                valid=np.ones((b, g), bool),
                masks_proto=(rng.rand(b, g, img // 4, img // 4) > 0.5).astype(np.uint8),
                masks_seg=(rng.rand(b, g, img // 8, img // 8) > 0.5).astype(np.uint8))


def _step(name, use_remat, monkeypatch):
    """One step from the seed-0 init: (losses, gradients, state_dict after,
    the step generator's state after, block forwards run, of them in a
    recompute)."""
    cfg = get_config(name, mode='train', img_size=IMG, max_gt=4, train_bs=2, remat=use_remat)
    state = TS.create_train_state(cfg, 'cpu', seed=0)
    gens, calls = [], [0, 0]
    step_generator = TS.step_generator
    monkeypatch.setattr(TS, 'step_generator', lambda s: gens.append(step_generator(s)) or gens[-1])
    block = SwinBlock if name.startswith('swin') else Bottleneck
    forward = block.forward

    def counted(self, *args):
        calls[0] += 1
        calls[1] += remat.recomputing()
        return forward(self, *args)
    monkeypatch.setattr(block, 'forward', counted)
    losses = TS.train_step(state, _batch(3, 2, 4, IMG))
    monkeypatch.undo()
    grads = {k: p.grad for k, p in state.model.named_parameters()}
    return losses, grads, state.model.state_dict(), gens[0].get_state(), calls


@pytest.mark.parametrize('name,blocks', [('res50_custom', 16), ('swin_tiny_custom', 12)])
def test_remat_step_equals_the_plain_step(name, blocks, monkeypatch):
    plain = _step(name, False, monkeypatch)
    ours = _step(name, True, monkeypatch)
    assert plain[4] == [blocks, 0]
    assert ours[4] == [2 * blocks, blocks]            # each block once more, in the backward
    for got, want in zip(ours[0], plain[0]):
        assert torch.equal(got, want)
    assert ours[1].keys() == plain[1].keys()
    for k, g in plain[1].items():
        assert torch.equal(ours[1][k], g), k
    for k, v in plain[2].items():                     # parameters, BN statistics, counters
        assert torch.equal(ours[2][k], v), k
    counts = {int(v) for k, v in ours[2].items() if k.endswith('num_batches_tracked')}
    assert counts == ({1} if name.startswith('res50') else set())
    assert torch.equal(ours[3], plain[3])
    if name.startswith('swin'):
        model = TS.create_train_state(get_config(name, mode='train', img_size=IMG),
                                      'cpu').model
        assert max(b.drop_path_rate for s in model.backbone.layers for b in s.blocks) > 0


def test_remat_runs_only_when_training_with_grad():
    cfg = get_config('res50_custom', mode='train', img_size=IMG, remat=True)
    model = TS.create_train_state(cfg, 'cpu').model
    x = torch.randn(1, IMG, IMG, 3)
    assert remat.active(model.backbone, True)
    assert not remat.active(model.backbone, False)
    with torch.no_grad():
        assert not remat.active(model.backbone, True)
    model.eval()
    assert not remat.active(model.backbone, True)
    with torch.no_grad():
        out = model(x)
    assert all(torch.isfinite(t).all() for t in out)
