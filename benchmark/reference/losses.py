"""The matcher and the four YOLACT losses, over a padded batch.

Matching: each anchor's best gt by IoU of its corner box; each valid gt's
best anchor is forced to it (IoU 2; the later gt wins a contested anchor);
positives at IoU >= 0.5, neutral below, background below 0.4. Class loss:
softmax cross entropy over the positives and the 3x as many hardest
negatives of each image (ranked by logsumexp - background logit, stable).
Box loss: smooth L1 on the SSD-encoded offsets of the positives. Mask loss:
for up to `masks_to_train` positives an image, chosen by the highest
`priorities`, BCE (log clamped at -100) of the cropped sigmoid(proto @
coef) against the gt mask at proto size, over the box area, scaled up to
all the image's positives. Semantic loss: BCE with logits against the max
of the gt masks of each class at 1/8 size. Class, box and mask losses are
divided by the batch's positives, the semantic loss by the images.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import ops
from benchmark.reference.postprocess import VARIANCES, box_iou, crop


def encode(gt, anc):
    cxcy = ((gt[..., :2] + gt[..., 2:]) / 2 - anc[..., :2]) / (VARIANCES[0] * anc[..., 2:])
    wh = torch.log(((gt[..., 2:] - gt[..., :2]) / anc[..., 2:]).clamp(min=1e-12)) / VARIANCES[1]
    return torch.cat([cxcy, wh], dim=-1)


def match(boxes, labels, valid, anc, pos_thre, neg_thre):
    b, g = valid.shape
    a = anc.shape[0]
    corners = torch.cat([anc[:, :2] - anc[:, 2:] / 2, anc[:, :2] + anc[:, 2:] / 2], dim=1)
    iou = torch.where(valid[:, :, None], box_iou(boxes, corners[None]), -1.0)   # [B, G, A]
    best_anchor = iou.argmax(dim=2)
    best, best_i = iou.max(dim=1)
    claims = (best_anchor[:, :, None] == torch.arange(a, device=anc.device)) & valid[:, :, None]
    claimant = torch.where(claims, torch.arange(g, device=anc.device)[:, None], -1).amax(dim=1)
    best = torch.where(claimant >= 0, 2.0, best)
    best_i = torch.where(claimant >= 0, claimant, best_i)
    gt_box = torch.gather(boxes, 1, best_i[..., None].expand(b, a, 4))
    conf = torch.gather(labels.long(), 1, best_i) + 1
    conf = torch.where(best < neg_thre, 0, torch.where(best < pos_thre, -1, conf))
    return encode(gt_box, anc), conf, gt_box, best_i


def _log(x):
    tiny = torch.finfo(torch.float32).tiny
    return torch.where(x >= tiny, torch.log(x.clamp(min=1e-30)).clamp(min=-100.0), -100.0)


def losses(train: dict, outputs, gt: dict, anc, priorities):
    """outputs (class logits, box, coef, proto, seg); gt dict of tensors as
    the batch holds them; priorities [B, A]. Returns (class, box, mask,
    semantic) losses."""
    class_p, box_p, coef_p, proto, seg = outputs
    offsets, conf, gt_box, gt_i = match(gt['boxes'], gt['labels'], gt['valid'], anc,
                                        train['pos_iou_thre'], train['neg_iou_thre'])
    pos = conf > 0
    n_pos = pos.sum().clamp(min=1)
    b, a = pos.shape

    with torch.no_grad():
        hard = torch.logsumexp(class_p, dim=-1) - class_p[..., 0]
        hard = torch.where(conf != 0, 0.0, hard)
        rank = torch.argsort(torch.argsort(-hard, dim=1, stable=True), dim=1, stable=True)
    n_neg = (3 * pos.sum(dim=1, keepdim=True)).clamp(max=a - 1)
    neg = (rank < n_neg) & (conf == 0)
    ce = -torch.gather(F.log_softmax(class_p, dim=-1), -1, conf.clamp(min=0)[..., None])[..., 0]
    loss_c = train['conf_alpha'] * torch.where(pos | neg, ce, 0.0).sum() / n_pos

    d = (box_p - offsets).abs()
    sl1 = torch.where(d < 1.0, 0.5 * d * d, d - 0.5)
    loss_b = train['bbox_alpha'] * torch.where(pos[..., None], sl1, 0.0).sum() / n_pos

    ph, pw = proto.shape[1:3]
    k = min(train['masks_to_train'], a)
    sel = torch.topk(torch.where(pos, priorities.float(), -torch.inf), k, dim=1).indices
    sel_ok = torch.gather(pos, 1, sel)
    sel_coef = torch.gather(coef_p, 1, sel[..., None].expand(b, k, coef_p.shape[2]))
    sel_box = torch.gather(gt_box, 1, sel[..., None].expand(b, k, 4))
    sel_gt = torch.gather(gt_i, 1, sel)
    target = torch.gather(gt['masks_proto'], 1, sel_gt[:, :, None, None].expand(b, k, ph, pw))
    target = target.permute(0, 2, 3, 1).float()
    pred = crop(torch.sigmoid(ops.matmul(proto, sel_coef.transpose(1, 2)[:, None])), sel_box)
    bce = -(target * _log(pred) + (1.0 - target) * _log(1.0 - pred))
    area = (sel_box[..., 2] - sel_box[..., 0]) * (sel_box[..., 3] - sel_box[..., 1])
    per_pos = torch.where(sel_ok, bce.sum(dim=(1, 2)) / area.clamp(min=1e-10), 0.0)
    n_img = pos.sum(dim=1)
    used = n_img.clamp(max=train['masks_to_train'])
    scale = torch.where(n_img > used, n_img / used.clamp(min=1), 1.0)
    loss_m = train['mask_alpha'] * (per_pos.sum(dim=1) * scale).sum() / ph / pw / n_pos

    _, sh, sw, c = seg.shape
    g = gt['masks_seg'].shape[1]
    m = gt['masks_seg'].float() * gt['valid'][:, :, None, None].float()
    index = gt['labels'].long()[:, :, None, None].expand(b, g, sh, sw)
    seg_gt = torch.zeros((b, c, sh, sw), device=m.device).scatter_reduce(
        1, index, m, reduce='amax').permute(0, 2, 3, 1)
    bce_s = seg.clamp(min=0.0) - seg * seg_gt + torch.log1p(torch.exp(-seg.abs()))
    loss_s = train['semantic_alpha'] * bce_s.sum() / sh / sw / b
    return loss_c, loss_b, loss_m, loss_s
