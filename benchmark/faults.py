"""Faults planted under a run's timed path, to show that the comparison
catches them: each a context manager that wraps the program's entry for
its duration.

  * `half_batch`: the program sees only the first half of each batch, the
    second half replaced by the first (detect), or its batch cut to the
    first half, so that its losses are the mean over those rows (train);
  * `altered_answer`: one detection's class id and one mask pixel of each
    call changed where they are produced (detect);
  * `unchanged_state`: the step computes and then puts the parameters and
    the optimizer back as they were (train).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def _patched(module, name, wrap):
    old = getattr(module, name)
    setattr(module, name, wrap(old))
    try:
        yield
    finally:
        setattr(module, name, old)


def half_batch(entry: str):
    if entry == 'detect':
        from yolact_minimal_torch import pipeline

        def wrap(fn):
            def detect_fixed(self, images, out_size):
                images = np.array(images, copy=True)
                half = len(images) // 2
                images[half:2 * half] = images[:half]
                return fn(self, images, out_size)
            return detect_fixed
        return _patched(pipeline.Detector, 'detect_fixed', wrap)
    from yolact_minimal_torch import train_state

    def wrap(fn):
        def train_step(state, batch, priorities=None):
            half = len(batch['image']) // 2
            return fn(state, {k: v[:half] for k, v in batch.items()},
                      None if priorities is None else priorities[:half])
        return train_step
    return _patched(train_state, 'train_step', wrap)


def altered_answer(entry: str):
    from yolact_minimal_torch import pipeline

    def wrap(fn):
        def detect_fixed(self, images, out_size):
            dets, masks = fn(self, images, out_size)
            ids = dets.ids.clone()
            ids[0, 0] = (ids[0, 0] + 1) % (self.cfg.num_classes - 1)
            masks = masks.clone()
            masks[0, 0, 0, 0] = ~masks[0, 0, 0, 0]
            return dets._replace(ids=ids), masks
        return detect_fixed
    return _patched(pipeline.Detector, 'detect_fixed', wrap)


def unchanged_state(entry: str):
    from yolact_minimal_torch import train_state

    def wrap(fn):
        def train_step(state, batch, priorities=None):
            params = [p.detach().clone() for p in state.model.parameters()]
            opt = {k: {n: (v.clone() if torch.is_tensor(v) else v) for n, v in st.items()}
                   for k, st in state.optimizer.state.items()}
            losses = fn(state, batch, priorities)
            with torch.no_grad():
                for p, old in zip(state.model.parameters(), params):
                    p.copy_(old)
            state.optimizer.state.clear()
            state.optimizer.state.update(opt)
            return losses
        return train_step
    return _patched(train_state, 'train_step', wrap)


FAULTS = {'half_batch': half_batch, 'altered_answer': altered_answer,
          'unchanged_state': unchanged_state}
