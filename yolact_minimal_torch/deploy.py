"""Export the eval forward to a standalone `torch.export` artifact and run it
without the model-building code.

The port's counterpart of the JAX package's `deploy.py` (which writes a
jax.export `.jexport`): `export_model` traces the eval forward at a fixed
batch with `torch.export` (non-strict) into ATen operators and the port's
registered operators, and writes one `.pt2` file by `torch.export.save`;
its extra files carry `meta.json` and `anchors.npy`. The program is kept as
traced: its bf16 autocast region stays one `wrap_with_autocast` call, which
casts where the live model casts (`run_decompositions` would take `F.linear`
apart into a product and a separate bias add, which in bf16 rounds once more
than the live model). The swin kernels are operators of the `yolact_torch` namespace (ops/), so an
exported swin program launches the CUDA kernels on the card and their plain
versions on the CPU; the block forms it was traced with are fixed in it and
recorded in `meta.json`. The export then runs the reference's immediate
parity check: the live forward against the reloaded artifact.

`load_exported` restores a callable whose outputs feed the numpy postprocess
(ops/nms_numpy.py). It imports the operator registrations (the four ops
modules, which this module imports) and nothing of `models/`.
"""
from __future__ import annotations

import io
import json
from typing import Callable, Tuple, Union

import numpy as np
import torch

# Importing the ops modules registers the yolact_torch:: operators that an
# exported swin program calls; torch.export.load needs them.
from yolact_minimal_torch.ops import attn_block, swin_block, swin_mlp, window_attention  # noqa: F401
from yolact_minimal_torch.config import Config
from yolact_minimal_torch.ops.boxes import make_anchors
from yolact_minimal_torch.utils.device import resolve_device

META_FIELDS = ('name', 'img_size', 'compute_dtype')
# sum |live - artifact| an output may reach (the JAX package's deploy check)
PARITY_SUM = 1.0


def export_model(cfg: Config, state_dict_or_model: Union[dict, torch.nn.Module],
                 out_path: str, check_parity: bool = True, batch: int = 1,
                 device: Union[str, torch.device] = 'cuda') -> str:
    """Export the eval forward, images [batch, S, S, 3] float32 -> (class_p
    softmaxed, box_p, coef_p, proto), to `out_path` (.pt2). The model is
    built as `Detector` builds it from a reference-format state_dict, or
    taken as it is: an eval-mode Yolact on `device`, as `Detector.model`
    holds it (a swin model with the block forms it has)."""
    device = resolve_device(device)
    if isinstance(state_dict_or_model, torch.nn.Module):
        model = state_dict_or_model
        if model.training:
            raise ValueError('export_model: the model must be in eval mode')
        where = {p.device.type for p in model.parameters()}
        if where != {device.type}:
            raise ValueError(f'export_model: the model lies on {where}, not on {device}')
    else:
        from yolact_minimal_torch.pipeline import Detector   # builds the model: not at import
        model = Detector(cfg, state_dict_or_model, device=device).model
    example = torch.zeros(batch, cfg.img_size, cfg.img_size, 3, device=device)
    program = torch.export.export(model, (example,), strict=False)

    meta = {f: getattr(cfg, f) for f in META_FIELDS}
    meta.update(class_names=list(cfg.class_names), batch=batch, device=device.type)
    if hasattr(model.backbone, 'block_forms'):
        meta['block_forms'] = list(model.backbone.block_forms())
    anchors = io.BytesIO()
    np.save(anchors, make_anchors(cfg.img_size, cfg.aspect_ratios, cfg.scales))
    # extra files are text: the .npy bytes travel one character a byte
    torch.export.save(program, out_path, extra_files={
        'meta.json': json.dumps(meta), 'anchors.npy': anchors.getvalue().decode('latin-1')})

    if check_parity:
        img = np.random.RandomState(0).rand(batch, cfg.img_size, cfg.img_size,
                                            3).astype(np.float32)
        with torch.inference_mode():
            live = model(torch.from_numpy(img).to(device))
        restored, _, _ = load_exported(out_path, device)
        for name, a, b in zip(('class', 'box', 'coef', 'proto'), live, restored(img)):
            diff = float((a - b).abs().sum())
            if not diff < PARITY_SUM:
                raise RuntimeError(f'Export parity check failed: {name} sum|diff| = {diff}')
        print('Export parity check passed.')
    return out_path


def load_exported(path: str, device: Union[str, torch.device] = 'cuda'
                  ) -> Tuple[Callable, dict, np.ndarray]:
    """(call, meta, anchors) of an artifact that `export_model` wrote: call
    takes images [batch, S, S, 3] (numpy or a tensor) and returns the four
    outputs as float32 tensors on `device`. Raises for `cuda` without a card
    and for a device other than the one the artifact was exported on."""
    device = resolve_device(device)
    extra = {'meta.json': '', 'anchors.npy': ''}
    program = torch.export.load(path, extra_files=extra)
    meta = json.loads(extra['meta.json'])
    if meta['device'] != device.type:
        raise ValueError(f'{path} was exported for {meta["device"]}, not {device.type}: '
                         f'export it again with --device {device.type}')
    anchors = np.load(io.BytesIO(extra['anchors.npy'].encode('latin-1')))
    module = program.module()

    def call(images):
        x = torch.as_tensor(images, dtype=torch.float32).to(device)
        with torch.inference_mode():
            return tuple(module(x))

    return call, meta, anchors
