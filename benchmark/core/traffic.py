"""The one generator of the benchmark's inputs, read from a traffic file.

Everything is drawn from the seed by a torch.Generator on the cell's device
in a few large calls, then handed to the program as host arrays, as a
decoder or a data loader would hand them over.

Images: normalized NHWC float32; a smooth random field (normal noise at
1/8 size, upsampled bilinearly) plus fine normal noise, so that values and
their spatial structure are image-like.

Training ground truth, laid out as the program's loader lays it (boxes
[B, G, 4] normalized xyxy, labels [B, G] int32, valid [B, G] bool, masks
[B, G, S/4, S/4] and [B, G, S/8, S/8] uint8, G = max_gt): each image holds
`instances` = clip(round(exp(N(mu, sigma))), lo, hi) objects; each object is
small, medium or large with the traffic's shares, its side sqrt(area) drawn
log-uniformly inside its band and its aspect ratio log-uniformly in
[1/3, 3]; its mask is the filled ellipse inside its box; its label is
uniform over the classes.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def images(n: int, size: int, gen: torch.Generator, device) -> torch.Tensor:
    """[n, size, size, 3] float32 on the device."""
    low = torch.randn(n, 3, max(size // 8, 1), max(size // 8, 1), generator=gen, device=device)
    field = F.interpolate(low, size=(size, size), mode='bilinear', align_corners=False)
    noise = torch.randn(n, 3, size, size, generator=gen, device=device)
    return (0.9 * field + 0.3 * noise).permute(0, 2, 3, 1).contiguous()


def detect_pool(traffic: dict, batch: int, size: int, seed: int, device) -> List[np.ndarray]:
    gen = generator(seed, device)
    pool = images(traffic['pool'] * batch, size, gen, device).cpu().numpy()
    return [pool[i * batch:(i + 1) * batch] for i in range(traffic['pool'])]


def _ellipses(boxes: torch.Tensor, side: int) -> torch.Tensor:
    """boxes [..., 4] normalized xyxy -> uint8 [..., side, side] filled
    ellipses, a pixel set where its centre lies inside."""
    c = (torch.arange(side, device=boxes.device, dtype=torch.float32) + 0.5) / side
    cx, cy = (boxes[..., 0] + boxes[..., 2]) / 2, (boxes[..., 1] + boxes[..., 3]) / 2
    rx = ((boxes[..., 2] - boxes[..., 0]) / 2).clamp(min=1e-6)
    ry = ((boxes[..., 3] - boxes[..., 1]) / 2).clamp(min=1e-6)
    dx = ((c - cx[..., None]) / rx[..., None]) ** 2          # [..., side] over columns
    dy = ((c - cy[..., None]) / ry[..., None]) ** 2          # [..., side] over rows
    return (dy[..., :, None] + dx[..., None, :] <= 1.0).to(torch.uint8)


def train_pool(traffic: dict, batch: int, size: int, max_gt: int, num_classes: int,
               n_anchors: int, seed: int, device) -> List[Dict[str, object]]:
    """`pool` training batches, each a dict of host arrays plus 'priorities'
    [B, n_anchors] on the device (the lincomb subsample's ranking)."""
    gen = generator(seed, device)
    p, b, g = traffic['pool'], batch, max_gt
    inst = traffic['instances']
    imgs = images(p * b, size, gen, device).reshape(p, b, size, size, 3)
    counts = torch.exp(inst['mu'] + inst['sigma'] * torch.randn(p, b, generator=gen, device=device))
    counts = counts.round().clamp(inst['min'], min(inst['max'], g)).long()
    valid = torch.arange(g, device=device) < counts[..., None]                     # [P, B, G]
    shares = torch.tensor([s for _, s in traffic['area_bands']], device=device)
    band = torch.multinomial(shares / shares.sum(), p * b * g, replacement=True,
                             generator=gen).reshape(p, b, g)
    lo = torch.tensor([math.log(r[0]) for r, _ in traffic['area_bands']], device=device)[band]
    hi = torch.tensor([math.log(r[1]) for r, _ in traffic['area_bands']], device=device)[band]
    u = torch.rand(p, b, g, 5, generator=gen, device=device)
    side = torch.exp(lo + (hi - lo) * u[..., 0]) / traffic['area_scale']           # sqrt(area)/S
    ratio = torch.exp(math.log(3.0) * (2 * u[..., 1] - 1))
    w, h = (side * ratio.sqrt()).clamp(max=1.0), (side / ratio.sqrt()).clamp(max=1.0)
    x1, y1 = u[..., 2] * (1 - w), u[..., 3] * (1 - h)
    boxes = torch.stack([x1, y1, x1 + w, y1 + h], dim=-1)
    boxes = torch.where(valid[..., None], boxes, 0.0)
    labels = (u[..., 4] * (num_classes - 1)).long().clamp(max=num_classes - 2)
    labels = torch.where(valid, labels, 0)
    prio = torch.rand(p, b, n_anchors, generator=gen, device=device)
    out = []
    for i in range(p):
        masks_proto = _ellipses(boxes[i], size // 4) * valid[i, :, :, None, None]
        masks_seg = _ellipses(boxes[i], size // 8) * valid[i, :, :, None, None]
        out.append(dict(image=imgs[i].cpu().numpy(), boxes=boxes[i].cpu().numpy(),
                        labels=labels[i].int().cpu().numpy(), valid=valid[i].cpu().numpy(),
                        masks_proto=masks_proto.cpu().numpy(),
                        masks_seg=masks_seg.cpu().numpy(), priorities=prio[i]))
    return out
