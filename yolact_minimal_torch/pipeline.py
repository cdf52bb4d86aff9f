"""High-level inference: forward + batched postprocess on the device.

The device side (backbone -> FPN -> heads -> decode -> fast NMS -> masks) is
eager PyTorch plus the CUDA kernels: suppression inside the NMS, the fused
mask finalize behind `detect_fixed`, and, with the swin_tiny backbone, window
attention and the MLP half of every block. The host side only upsamples the
kept masks of one image to its original size and converts boxes to pixels.

With cfg.traditional_nms, `__call__` runs the forward and the box decode on
the device and the rest on the host, as the JAX package does: per-class
greedy NMS in C++ (`ops/traditional_nms.py`), the masks in numpy, padded into
the same fixed slate, so the consumers of `__call__` take either.

With a mesh (`parallel/mesh.py::make_mesh`) the Detector keeps one replica
of the model on each of its devices, splits each batch on its leading axis,
runs each chunk on its replica's device (the forward and fast NMS, or the
--traditional_nms forward and decode) and gathers the slates on the first
device: data-parallel inference, as the JAX package's Detector(mesh=...).

Entry points run on `cuda` unless the caller asks for `device='cpu'`; without
a card they raise rather than carry on on the CPU.
"""
from __future__ import annotations

import copy
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from yolact_minimal_torch.config import Config, cfg_name_from_weight, get_config
from yolact_minimal_torch.models.yolact import Yolact
from yolact_minimal_torch.ops.boxes import crop_numpy, decode, make_anchors
from yolact_minimal_torch.ops.mask_finalize import mask_finalize
from yolact_minimal_torch.ops.nms import (Detections, assemble_masks,
                                          detect_postprocess_batch)
from yolact_minimal_torch.ops.traditional_nms import traditional_nms
from yolact_minimal_torch.utils.checkpoint import load_weights_auto
from yolact_minimal_torch.utils.device import resolve_device
from yolact_minimal_torch.utils.trace import count, span


class Detector:
    """A Yolact model plus its postprocess, on one device.

    `state_dict` is a reference-format state_dict (see utils/weights.py);
    without one the weights are the reference's init (Xavier-uniform
    convolutions; truncated normal for swin's Linears and bias tables) drawn
    from a torch.Generator seeded with `seed`. Parameters and BatchNorm
    statistics stay float32; with cfg.compute_dtype 'bfloat16' the network
    runs under bf16 autocast (models/yolact.py). Its four outputs and the
    postprocess are float32 either way.

    `mesh`, a list of devices, replaces `device`: `model` is the replica on
    the first, and the others are copies of it made here (a later change
    to `model` does not reach them).
    """

    def __init__(self, cfg: Config, state_dict: Optional[dict] = None,
                 device: Union[str, torch.device] = 'cuda', seed: int = 0,
                 mesh: Optional[Sequence[torch.device]] = None):
        self.cfg = cfg
        self.device = resolve_device(mesh[0] if mesh else device)
        model = Yolact(cfg)
        if state_dict is None:
            model.reset_parameters(torch.Generator().manual_seed(seed))
        else:
            model.load_state_dict(state_dict, strict=True)
        self.model = model.eval().to(device=self.device,
                                     memory_format=torch.channels_last)
        self.anchors = torch.from_numpy(
            make_anchors(cfg.img_size, cfg.aspect_ratios, cfg.scales)).to(self.device)
        # a Detector on each device of the mesh, this one on the first
        self.replicas = [self] + [self._replica(dev) for dev in (mesh or [])[1:]]

    def _replica(self, device: torch.device) -> 'Detector':
        """A copy of this Detector, its model and anchors copied to `device`."""
        replica = copy.copy(self)
        replica.device = resolve_device(device)
        replica.model = copy.deepcopy(self.model).to(replica.device)
        replica.anchors = self.anchors.to(replica.device)
        replica.replicas = [replica]
        return replica

    def _over_mesh(self, images, fn):
        """fn(replica, rows) for each replica on its rows of the batch (split
        on the leading axis), the outputs concatenated on the devices of the
        first replica's; fn(self, images) without a mesh."""
        n = len(self.replicas)
        if n == 1:
            return fn(self, images)
        if images.shape[0] % n:
            raise ValueError(f'batch {images.shape[0]} not divisible by mesh size {n}')
        outs = [fn(r, rows) for r, rows in zip(self.replicas, torch.as_tensor(images).chunk(n))]
        cat = lambda ts: torch.cat([t.to(ts[0].device) for t in ts])
        return tuple(Detections(*map(cat, zip(*parts))) if isinstance(parts[0], Detections)
                     else cat(parts) for parts in zip(*outs))

    def _forward(self, images) -> Tuple[torch.Tensor, ...]:
        """The batch copied to the device, then the network's four outputs."""
        with span('yolact.detect.copy'):
            images = torch.as_tensor(images, dtype=torch.float32).to(self.device)
        with span('yolact.detect.forward'):
            return self.model(images)

    def _infer(self, images) -> Tuple[Detections, torch.Tensor]:
        class_p, box_p, coef_p, proto = self._forward(images)
        cfg = self.cfg
        with span('yolact.detect.nms'):
            dets = detect_postprocess_batch(
                class_p, box_p, coef_p, self.anchors, cfg.nms_score_thre,
                cfg.nms_iou_thre, cfg.top_k, cfg.max_detections, cfg.nms_pre_topk)
        count('detect.valid', dets.valid)
        return dets, proto

    def _infer_raw(self, images) -> Tuple[torch.Tensor, ...]:
        """The device half of the --traditional_nms path: the forward and the
        box decode -> (class_p [B, A, C], boxes [B, A, 4] normalized xyxy,
        coefs [B, A, 32], proto [B, ph, pw, 32])."""
        class_p, box_p, coef_p, proto = self._forward(images)
        return class_p, decode(box_p, self.anchors, clip=True), coef_p, proto

    @torch.inference_mode()
    def __call__(self, images):
        """images [B, S, S, 3] normalized RGB -> (Detections, masks_proto
        [B, ph, pw, D] float, proto [B, ph, pw, 32]): on the device for fast
        NMS; CPU tensors of the same shapes with cfg.traditional_nms."""
        with span('yolact.detect'):
            return self._over_mesh(images, Detector._call_one)

    def _call_one(self, images):
        if self.cfg.traditional_nms:
            raw = _to_host(self._infer_raw(images))
            with span('yolact.detect.nms'):
                out = self.traditional_tail(*raw)
            count('detect.valid', out[0].valid)
            return out
        dets, proto = self._infer(images)
        with span('yolact.detect.masks'):
            masks = assemble_masks(proto, dets, do_crop=not self.cfg.no_crop)
        return dets, masks, proto

    def traditional_tail(self, class_p: np.ndarray, boxes_all: np.ndarray,
                         coef_p: np.ndarray, proto: np.ndarray):
        """The host half of the --traditional_nms path on `_infer_raw`'s
        outputs as numpy arrays: per image, greedy per-class NMS on the
        scores without the background, the kept masks sigmoid(proto @
        coefs^T) in float32, cropped unless cfg.no_crop, all padded into the
        fixed [max_detections] slate -> (Detections, masks_proto, proto) of
        CPU tensors."""
        cfg = self.cfg
        bsz, _, n_coef = coef_p.shape
        ph, pw = proto.shape[1:3]
        d = cfg.max_detections
        ids = np.zeros((bsz, d), np.int32)
        scores = np.zeros((bsz, d), np.float32)
        boxes = np.zeros((bsz, d, 4), np.float32)
        coefs = np.zeros((bsz, d, n_coef), np.float32)
        valid = np.zeros((bsz, d), bool)
        masks_proto = np.zeros((bsz, ph, pw, d), np.float32)
        for b in range(bsz):
            cls_scores = np.ascontiguousarray(class_p[b][:, 1:].T)      # [C-1, A]
            bx, cf, cl, sc = traditional_nms(boxes_all[b], coef_p[b], cls_scores, cfg.img_size,
                                             cfg.nms_score_thre, cfg.nms_iou_thre, d)
            k = len(cl)
            if k == 0:
                continue
            ids[b, :k], scores[b, :k] = cl, sc
            boxes[b, :k], coefs[b, :k] = bx, cf
            valid[b, :k] = True
            masks = 1.0 / (1.0 + np.exp(-(proto[b] @ cf.T)))
            if not cfg.no_crop:
                masks = crop_numpy(masks, bx)
            masks_proto[b, :, :, :k] = masks
        dets = Detections(*(torch.from_numpy(a) for a in (ids, scores, boxes, coefs, valid)))
        return dets, torch.from_numpy(masks_proto), torch.from_numpy(np.asarray(proto))

    @torch.inference_mode()
    def detect_fixed(self, images, out_size: int):
        """Detect with square binarized masks on the device: (Detections,
        bool [B, D, out_size, out_size]). Always fast NMS, whatever
        cfg.traditional_nms says, as the JAX package's detect_fixed."""
        with span('yolact.detect'):
            return self._over_mesh(images, lambda det, rows: det._fixed_one(rows, out_size))

    def _fixed_one(self, images, out_size: int):
        dets, proto = self._infer(images)
        with span('yolact.detect.masks'):
            masks = mask_finalize(proto, dets.coefs, dets.boxes, dets.valid,
                                  out_size, not self.cfg.no_crop)
        return dets, masks

    @torch.inference_mode()
    def postprocess_host(self, dets: Detections, masks_proto: torch.Tensor,
                         img_h: int, img_w: int,
                         visual_thre: Optional[float] = None
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """One image's slate (fields without the batch dim) and masks_proto
        [ph, pw, D] -> numpy (ids, scores, pixel boxes int32, bool masks
        [K, img_h, img_w]): filter by visual threshold, upsample the kept
        masks bilinearly (align_corners=False) to the padded square, binarize
        at 0.5, slice the original extent."""
        keep = dets.valid
        if visual_thre is not None:
            keep = keep & (dets.scores >= visual_thre)
        if not bool(keep.any()):
            return (np.zeros(0, np.int32), np.zeros(0, np.float32),
                    np.zeros((0, 4), np.int32), np.zeros((0, img_h, img_w), bool))
        ori = max(img_h, img_w)
        masks = masks_proto[:, :, keep].permute(2, 0, 1)[None]     # [1, K, ph, pw]
        up = F.interpolate(masks, size=(ori, ori), mode='bilinear',
                           align_corners=False)[0] > 0.5
        ids = dets.ids[keep].cpu().numpy()
        scores = dets.scores[keep].cpu().numpy()
        boxes = (dets.boxes[keep].cpu().numpy() * ori).astype(np.int32)
        return ids, scores, boxes, up[:, :img_h, :img_w].cpu().numpy()


def _to_host(tensors) -> list:
    """Device tensors -> numpy arrays, copied behind one synchronize."""
    if all(t.device.type == 'cpu' for t in tensors):
        return [t.numpy() for t in tensors]
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)
            for t in tensors]
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return [t.numpy() for t in host]


def load_detector(weight_path: str, cfg: Optional[Config] = None,
                  device: Union[str, torch.device] = 'cuda',
                  mesh: Optional[Sequence[torch.device]] = None) -> Detector:
    """A Detector from a `.ckpt` of the JAX package or a reference-format
    `.pth` state_dict, recovering the config from the filename when not
    given; data-parallel over `mesh` where one is given."""
    if cfg is None:
        cfg = get_config(cfg_name_from_weight(weight_path), mode='detect')
    resolve_device(mesh[0] if mesh else device)
    return Detector(cfg, load_weights_auto(weight_path), device=device, mesh=mesh)
