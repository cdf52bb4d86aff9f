"""Rematerialization of backbone blocks (cfg.remat, the train CLI's --remat).

A block runs under `torch.utils.checkpoint.checkpoint(use_reentrant=False)`:
its activations are dropped after the forward and the block's forward runs
again in the backward, as the JAX package's `nn.remat` does. Two things
must not change under the recompute, and this module keeps both:

- BatchNorm's running statistics: `models/resnet.py::BatchNorm2d` updates
  them in its forward, so it skips the update while `recomputing()`;
- stochastic depth: `drop_path` draws from an explicit `torch.Generator`,
  which `checkpoint` does not save. `run` records the generator's state
  before the block, sets it back for the recompute, so the recompute draws
  the same keep mask, and afterwards returns it to where the backward found
  it, so the step leaves the generator where the plain step does.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

_state = threading.local()


def recomputing() -> bool:
    """True inside the backward's recompute of a checkpointed block (on the
    thread that runs it)."""
    return getattr(_state, 'recomputing', False)


@contextlib.contextmanager
def _recompute():
    before = recomputing()
    _state.recomputing = True
    try:
        yield
    finally:
        _state.recomputing = before


def _contexts():
    return contextlib.nullcontext(), _recompute()


def active(module: torch.nn.Module, remat: bool) -> bool:
    """Whether `module`'s blocks run rematerialized now: remat set, the
    module training, and grad enabled."""
    return remat and module.training and torch.is_grad_enabled()


def run(block: Callable, x: torch.Tensor,
        generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """block(x) (or block(x, generator)) with its activations recomputed in
    the backward."""
    if generator is None:
        return checkpoint(block, x, use_reentrant=False, context_fn=_contexts)
    start = generator.get_state()

    def forward(x):
        if not recomputing():
            return block(x, generator)
        now = generator.get_state()
        generator.set_state(start)
        try:
            return block(x, generator)
        finally:
            generator.set_state(now)
    return checkpoint(forward, x, use_reentrant=False, context_fn=_contexts)
