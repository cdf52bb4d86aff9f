"""The four YOLACT losses as fixed-shape functions over a padded batch.

The port's own copy of the JAX package's `ops/losses.py`:

  * class: softmax cross entropy with OHEM hard-negative mining at neg:pos
    = 3:1, the ranks from two stable argsorts (as `jnp.argsort` is stable);
  * box: smooth-L1 on the encoded offsets of the positives;
  * mask: the lincomb loss over up to `masks_to_train` positives an image,
    "all if <= K, else a uniform random K-subset" by top-k over random
    priorities, BCE of the cropped sigmoid(proto @ coef) against the gt
    mask at prototype size, area-normalized;
  * semantic: per-class BCE-with-logits against the scatter-max of the gt
    masks at seg size.

Ground-truth masks arrive downsampled and binarized (`data/coco.py`), as
uint8 or float.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from yolact_minimal_torch.ops.boxes import crop
from yolact_minimal_torch.ops.matching import match


class LossBreakdown(NamedTuple):
    loss_c: torch.Tensor
    loss_b: torch.Tensor
    loss_m: torch.Tensor
    loss_s: torch.Tensor

    @property
    def total(self) -> torch.Tensor:
        return self.loss_c + self.loss_b + self.loss_m + self.loss_s


_TINY = torch.finfo(torch.float32).tiny


def _log_clamped(x: torch.Tensor) -> torch.Tensor:
    """log(x) clamped at -100 (binary_cross_entropy's rule) with a finite
    gradient at x == 0, where crop() zeroes the mask: a plain
    max(log(x), -100) gives 0 * inf = NaN there. A subnormal x counts as
    0, as XLA's flush-to-zero makes it in the JAX package."""
    safe = torch.log(x.clamp(min=1e-30))
    return torch.where(x >= _TINY, safe.clamp(min=-100.0), -100.0)


def category_loss(class_p: torch.Tensor, conf_gt: torch.Tensor, conf_alpha: float,
                  np_ratio: int = 3) -> torch.Tensor:
    """class_p [B, A, C] logits, conf_gt [B, A] (>0 class + 1, 0 bg, -1
    neutral)."""
    a = class_p.shape[1]
    pos = conf_gt > 0
    neutral = conf_gt < 0
    with torch.no_grad():
        # background hardness: log-sum-exp minus the background logit
        mark = torch.logsumexp(class_p, dim=-1) - class_p[..., 0]
        mark = torch.where(pos | neutral, 0.0, mark)
        order = torch.argsort(-mark, dim=1, stable=True)
        rank = torch.argsort(order, dim=1, stable=True)
    num_pos = pos.sum(dim=1, keepdim=True)
    num_neg = (np_ratio * num_pos).clamp(max=a - 1)
    neg = (rank < num_neg) & ~pos & ~neutral

    target = conf_gt.clamp(min=0)
    logp = F.log_softmax(class_p, dim=-1)
    ce = -torch.gather(logp, -1, target[..., None])[..., 0]
    ce_sum = torch.where(pos | neg, ce, 0.0).sum()
    return conf_alpha * ce_sum / num_pos.sum().clamp(min=1)


def box_loss(box_p: torch.Tensor, offsets_gt: torch.Tensor, pos: torch.Tensor,
             bbox_alpha: float) -> torch.Tensor:
    diff = (box_p - offsets_gt).abs()
    sl1 = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)
    loss = torch.where(pos[..., None], sl1, 0.0).sum()
    return bbox_alpha * loss / pos.sum().clamp(min=1)


def lincomb_mask_loss(pos, anchor_max_i, coef_p, proto_p, masks_proto, anchor_max_gt,
                      mask_alpha: float, masks_to_train: int,
                      generator: Optional[torch.Generator] = None,
                      priorities: Optional[torch.Tensor] = None) -> torch.Tensor:
    """pos [B, A] bool, anchor_max_i [B, A], coef_p [B, A, 32], proto_p
    [B, ph, pw, 32], masks_proto [B, G, ph, pw], anchor_max_gt [B, A, 4].
    `priorities` [B, A] in [0, 1) rank the positives for the subsample;
    without them they are drawn uniformly from `generator`."""
    b, a = pos.shape
    ph, pw = proto_p.shape[1], proto_p.shape[2]
    if priorities is None:
        priorities = torch.rand((b, a), generator=generator, device=pos.device)
    k = min(masks_to_train, a)
    priority = torch.where(pos, priorities.to(torch.float32), -torch.inf)
    sel = torch.topk(priority, k, dim=1).indices                           # [B, K]
    sel_valid = torch.gather(pos, 1, sel)

    sel_coef = torch.gather(coef_p, 1, sel[..., None].expand(b, k, coef_p.shape[2]))
    sel_box = torch.gather(anchor_max_gt, 1, sel[..., None].expand(b, k, 4))
    sel_gt_i = torch.gather(anchor_max_i, 1, sel)
    mask_gt = torch.gather(masks_proto, 1, sel_gt_i[:, :, None, None].expand(b, k, ph, pw))
    mask_gt = mask_gt.permute(0, 2, 3, 1).float()                          # [B, ph, pw, K]

    mask_p = torch.sigmoid(torch.einsum('bhwc,bkc->bhwk', proto_p, sel_coef))
    mask_p = crop(mask_p, sel_box)                                         # 0 outside the box
    bce = -(mask_gt * _log_clamped(mask_p) + (1.0 - mask_gt) * _log_clamped(1.0 - mask_p))

    area = (sel_box[..., 2] - sel_box[..., 0]) * (sel_box[..., 3] - sel_box[..., 1])
    per_pos = bce.sum(dim=(1, 2)) / area.clamp(min=1e-10)
    per_pos = torch.where(sel_valid, per_pos, 0.0)

    # a subsampled image is scaled up to all its positives, as the reference does
    old_num_pos = pos.sum(dim=1)
    num_used = old_num_pos.clamp(max=masks_to_train)
    scale = torch.where(old_num_pos > num_used, old_num_pos / num_used.clamp(min=1), 1.0)
    per_img = per_pos.sum(dim=1) * scale
    return mask_alpha * per_img.sum() / ph / pw / pos.sum().clamp(min=1)


def semantic_seg_loss(seg_p: torch.Tensor, masks_seg: torch.Tensor, labels_gt: torch.Tensor,
                      gt_valid: torch.Tensor, semantic_alpha: float) -> torch.Tensor:
    """seg_p [B, sh, sw, C-1] logits; the target of class c is the max of
    the valid gt masks labelled c."""
    b, sh, sw, c = seg_p.shape
    g = masks_seg.shape[1]
    m = masks_seg.float() * gt_valid[:, :, None, None].float()
    index = labels_gt.long()[:, :, None, None].expand(b, g, sh, sw)
    seg_gt = torch.zeros((b, c, sh, sw), dtype=m.dtype, device=m.device)
    seg_gt = seg_gt.scatter_reduce(1, index, m, reduce='amax')
    seg_gt = seg_gt.permute(0, 2, 3, 1)
    x = seg_p
    bce = x.clamp(min=0.0) - x * seg_gt + torch.log1p(torch.exp(-x.abs()))
    return semantic_alpha * bce.sum() / sh / sw / b


def compute_loss(cfg, outputs, gt: dict, anchors: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 priorities: Optional[torch.Tensor] = None) -> LossBreakdown:
    """outputs: (class_p, box_p, coef_p, proto_p, seg_p) of the train-mode
    Yolact. gt: 'boxes' [B, G, 4], 'labels' [B, G], 'valid' [B, G],
    'masks_proto' [B, G, ph, pw], 'masks_seg' [B, G, sh, sw]. `generator`
    (or `priorities`) feeds the lincomb subsample."""
    class_p, box_p, coef_p, proto_p, seg_p = outputs
    m = match(gt['boxes'], gt['labels'], gt['valid'], anchors,
              cfg.pos_iou_thre, cfg.neg_iou_thre)
    pos = m.conf_gt > 0
    loss_c = category_loss(class_p, m.conf_gt, cfg.conf_alpha)
    loss_b = box_loss(box_p, m.offsets, pos, cfg.bbox_alpha)
    loss_m = lincomb_mask_loss(pos, m.anchor_max_i, coef_p, proto_p, gt['masks_proto'],
                               m.anchor_max_gt, cfg.mask_alpha, cfg.masks_to_train,
                               generator=generator, priorities=priorities)
    loss_s = semantic_seg_loss(seg_p, gt['masks_seg'], gt['labels'], gt['valid'],
                               cfg.semantic_alpha)
    return LossBreakdown(loss_c, loss_b, loss_m, loss_s)
