"""Anchor-to-ground-truth matching over a batch of padded gt.

Ground truth arrives padded to a fixed `max_gt` rows with a validity mask;
the whole batch is matched at once:

  * each anchor's best gt by IoU (invalid rows score -1);
  * force-match: each valid gt's best anchor gets IoU 2 and that gt; where
    several gts claim one anchor, the largest gt index wins (the
    reference's sequential loop lets the later gt overwrite);
  * conf = class + 1 at IoU >= pos_thre, -1 (neutral) below it, 0
    (background) below neg_thre;
  * offsets = SSD encode of the matched gt box against the anchor.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from yolact_minimal_torch.ops.boxes import box_iou, encode


class MatchResult(NamedTuple):
    offsets: torch.Tensor        # [B, A, 4] encoded regression targets
    conf_gt: torch.Tensor        # [B, A] int64: >0 fg class, 0 bg, -1 neutral
    anchor_max_gt: torch.Tensor  # [B, A, 4] matched gt box per anchor (xyxy)
    anchor_max_i: torch.Tensor   # [B, A] int64 index of the matched gt


def match(boxes_gt: torch.Tensor, labels_gt: torch.Tensor, gt_valid: torch.Tensor,
          anchors: torch.Tensor, pos_thre: float, neg_thre: float) -> MatchResult:
    """boxes_gt [B, G, 4] normalized xyxy (padded rows arbitrary), labels_gt
    [B, G] 0-based class ids, gt_valid [B, G] bool, anchors [A, 4] cxcywh."""
    b, g = gt_valid.shape
    a = anchors.shape[0]
    decoded = torch.cat([anchors[:, :2] - anchors[:, 2:] / 2,
                         anchors[:, :2] + anchors[:, 2:] / 2], dim=1)
    overlaps = box_iou(boxes_gt, decoded[None])                      # [B, G, A]
    overlaps = torch.where(gt_valid[:, :, None], overlaps, -1.0)

    gt_max_i = overlaps.argmax(dim=2)                                # [B, G]
    anchor_max, anchor_max_i = overlaps.max(dim=1)                   # [B, A]

    gt_ids = torch.arange(g, device=anchors.device)
    claims = (gt_max_i[:, :, None] == torch.arange(a, device=anchors.device)) \
        & gt_valid[:, :, None]                                       # [B, G, A]
    claimant = torch.where(claims, gt_ids[:, None], -1).amax(dim=1)  # [B, A]
    forced = claimant >= 0
    anchor_max = torch.where(forced, 2.0, anchor_max)
    anchor_max_i = torch.where(forced, claimant, anchor_max_i)

    anchor_max_gt = torch.gather(boxes_gt, 1, anchor_max_i[..., None].expand(b, a, 4))
    conf = torch.gather(labels_gt.long(), 1, anchor_max_i) + 1
    conf = torch.where(anchor_max < pos_thre, -1, conf)
    conf = torch.where(anchor_max < neg_thre, 0, conf)
    return MatchResult(encode(anchor_max_gt, anchors), conf, anchor_max_gt, anchor_max_i)
