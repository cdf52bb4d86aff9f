"""High-level inference: forward + batched postprocess on the device.

The device side (backbone -> FPN -> heads -> decode -> fast NMS -> masks) is
eager PyTorch plus the CUDA kernels: suppression inside the NMS, the fused
mask finalize behind `detect_fixed`, and, with the swin_tiny backbone, window
attention and the MLP half of every block. The host side only upsamples the
kept masks of one image to its original size and converts boxes to pixels.

Entry points run on `cuda` unless the caller asks for `device='cpu'`; without
a card they raise rather than carry on on the CPU.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from yolact_minimal_torch.config import Config, cfg_name_from_weight, get_config
from yolact_minimal_torch.models.yolact import Yolact
from yolact_minimal_torch.ops.boxes import make_anchors
from yolact_minimal_torch.ops.mask_finalize import mask_finalize
from yolact_minimal_torch.ops.nms import (Detections, assemble_masks,
                                          detect_postprocess_batch)
from yolact_minimal_torch.utils.checkpoint import load_weights_auto


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """torch.device of `device`; raises for a CUDA device without a card."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('CUDA is not available; pass device="cpu" to run '
                           'on the CPU')
    return device


class Detector:
    """A Yolact model plus its postprocess, on one device.

    `state_dict` is a reference-format state_dict (see utils/weights.py);
    without one the weights are the reference's init (Xavier-uniform
    convolutions; truncated normal for swin's Linears and bias tables) drawn
    from a torch.Generator seeded with `seed`. Parameters and BatchNorm
    statistics stay float32; with cfg.compute_dtype 'bfloat16' the network
    runs under bf16 autocast (models/yolact.py). Its four outputs and the
    postprocess are float32 either way.
    """

    def __init__(self, cfg: Config, state_dict: Optional[dict] = None,
                 device: Union[str, torch.device] = 'cuda', seed: int = 0):
        if cfg.traditional_nms:
            raise NotImplementedError('--traditional_nms is not ported yet')
        self.cfg = cfg
        self.device = resolve_device(device)
        model = Yolact(cfg)
        if state_dict is None:
            model.reset_parameters(torch.Generator().manual_seed(seed))
        else:
            model.load_state_dict(state_dict, strict=True)
        self.model = model.eval().to(device=self.device,
                                     memory_format=torch.channels_last)
        self.anchors = torch.from_numpy(
            make_anchors(cfg.img_size, cfg.aspect_ratios, cfg.scales)).to(self.device)

    def _infer(self, images) -> Tuple[Detections, torch.Tensor]:
        images = torch.as_tensor(images, dtype=torch.float32).to(self.device)
        class_p, box_p, coef_p, proto = self.model(images)
        cfg = self.cfg
        dets = detect_postprocess_batch(
            class_p, box_p, coef_p, self.anchors, cfg.nms_score_thre,
            cfg.nms_iou_thre, cfg.top_k, cfg.max_detections, cfg.nms_pre_topk)
        return dets, proto

    @torch.inference_mode()
    def __call__(self, images):
        """images [B, S, S, 3] normalized RGB -> (Detections, masks_proto
        [B, ph, pw, D] float, proto [B, ph, pw, 32])."""
        dets, proto = self._infer(images)
        return dets, assemble_masks(proto, dets, do_crop=not self.cfg.no_crop), proto

    @torch.inference_mode()
    def detect_fixed(self, images, out_size: int):
        """Detect with square binarized masks on the device: (Detections,
        bool [B, D, out_size, out_size])."""
        dets, proto = self._infer(images)
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


def load_detector(weight_path: str, cfg: Optional[Config] = None,
                  device: Union[str, torch.device] = 'cuda') -> Detector:
    """A Detector from a `.ckpt` of the JAX package or a reference-format
    `.pth` state_dict, recovering the config from the filename when not
    given."""
    if cfg is None:
        cfg = get_config(cfg_name_from_weight(weight_path), mode='detect')
    resolve_device(device)
    return Detector(cfg, load_weights_auto(weight_path), device=device)
