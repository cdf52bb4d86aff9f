"""Operations of the model at a cell's shapes, counted by
torch.utils.flop_counter.FlopCounterMode on the reference built on the meta
device: the same count whatever implements the call. A multiply-add counts
two."""
from __future__ import annotations

from functools import lru_cache
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference.yolact import Yolact


def _count(model_spec: dict, batch: int, size: int, train: bool) -> int:
    with torch.device('meta'):
        model = Yolact(model_spec, train_mode=train)
        model.train(train)
        img = torch.empty(batch, size, size, 3)
    counter = FlopCounterMode(display=False)
    with counter:
        outs = model(img)
        if train:
            sum(o.sum() for o in outs).backward()
    return int(counter.get_total_flops())


@lru_cache(maxsize=None)
def _cached(spec_json: str, batch: int, size: int, train: bool) -> int:
    return _count(json.loads(spec_json), batch, size, train)


def forward(model_spec: dict, batch: int, size: int) -> int:
    """The eval forward: backbone, FPN, ProtoNet and the heads."""
    return _cached(json.dumps(model_spec, sort_keys=True), batch, size, False)


def train_step(model_spec: dict, batch: int, size: int) -> int:
    """The training forward (with the semantic head) and its backward, to
    the weights and to every activation but the image; no recompute."""
    return _cached(json.dumps(model_spec, sort_keys=True), batch, size, True)
