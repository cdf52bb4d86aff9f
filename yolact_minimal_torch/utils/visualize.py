"""Detection visualization (host-side): semantic-color mask overlay,
per-class boxes and score labels, cutout export, the realtime fps overlay
and the --save_lincomb grid of prototypes (`draw_lincomb`, needs cv2).

The blend and the rectangles are numpy, pixel for pixel what cv2.addWeighted
and cv2.rectangle draw. Text goes through the library that `image_io` reads
and writes with: cv2, else PIL's ImageDraw (its default font, white glyphs
laid on the image). Nothing is imported until first use.
"""
from __future__ import annotations

import os
import os.path as osp
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np

from yolact_minimal_torch.config import COLORS
from yolact_minimal_torch.utils import image_io

FONT_SCALE, FONT_THICKNESS = 0.6, 1


def blend(a: np.ndarray, b: np.ndarray, alpha: float, beta: float) -> np.ndarray:
    """cv2.addWeighted(a, alpha, b, beta, 0) for uint8 images: float32
    products and sum, rounded to nearest even."""
    out = np.rint(a.astype(np.float32) * np.float32(alpha) + b.astype(np.float32) * np.float32(beta))
    return np.clip(out, 0, 255).astype(np.uint8)


def rectangle(img: np.ndarray, p1, p2, color, filled: bool = False) -> None:
    """cv2.rectangle(img, p1, p2, color, 1 or -1) in place: the outline one
    pixel wide (or the whole box), corners included, clipped to the image."""
    h, w = img.shape[:2]
    (xa, xb), (ya, yb) = sorted((int(p1[0]), int(p2[0]))), sorted((int(p1[1]), int(p2[1])))
    cols = slice(max(xa, 0), max(min(xb + 1, w), 0))
    rows = slice(max(ya, 0), max(min(yb + 1, h), 0))
    color = np.asarray(color, img.dtype)
    if filled:
        img[rows, cols] = color
        return
    for y in (ya, yb):
        if 0 <= y < h:
            img[y, cols] = color
    for x in (xa, xb):
        if 0 <= x < w:
            img[rows, x] = color


@lru_cache(maxsize=64)
def _pil_glyphs(text: str) -> np.ndarray:
    """The text in PIL's default font as a bool mask [th, tw]."""
    from PIL import Image, ImageDraw, ImageFont
    font = ImageFont.load_default()
    left, top, right, bottom = ImageDraw.Draw(Image.new('L', (1, 1))).textbbox((0, 0), text,
                                                                              font=font)
    canvas = Image.new('L', (max(right - left, 1), max(bottom - top, 1)))
    ImageDraw.Draw(canvas).text((-left, -top), text, fill=255, font=font)
    return np.asarray(canvas) > 127


def text_size(text: str) -> Tuple[int, int]:
    """(width, height) of `text` as put_text draws it."""
    if image_io.backend() == 'cv2':
        import cv2
        return cv2.getTextSize(text, cv2.FONT_HERSHEY_DUPLEX, FONT_SCALE, FONT_THICKNESS)[0]
    th, tw = _pil_glyphs(text).shape
    return tw, th


def put_text(img: np.ndarray, text: str, org) -> None:
    """White text in place, with its baseline's left end at org (cv2's
    convention; PIL's glyphs sit on the same baseline)."""
    if image_io.backend() == 'cv2':
        import cv2
        cv2.putText(img, text, (int(org[0]), int(org[1])), cv2.FONT_HERSHEY_DUPLEX, FONT_SCALE,
                    (255, 255, 255), FONT_THICKNESS, cv2.LINE_AA)
    else:
        glyphs = _pil_glyphs(text)
        th, tw = glyphs.shape
        x0, y0 = int(org[0]), int(org[1]) - th
        h, w = img.shape[:2]
        ys, xs = max(y0, 0), max(x0, 0)
        ye, xe = min(y0 + th, h), min(x0 + tw, w)
        if ys < ye and xs < xe:
            region = img[ys:ye, xs:xe]
            region[glyphs[ys - y0:ye - y0, xs - x0:xe - x0]] = 255


def draw_img(ids_p, scores_p, boxes_p, masks_p, img_origin, cfg,
             img_name: Optional[str] = None, fps: Optional[float] = None,
             out_dir: str = 'results/images') -> np.ndarray:
    """Overlay masks/boxes/labels on the original image; optionally export
    cutouts. Inputs are host numpy; boxes in pixels, masks binary at image
    resolution."""
    if ids_p is None or len(ids_p) == 0:
        return img_origin

    ids_p = np.asarray(ids_p)
    scores_p = np.asarray(scores_p)
    boxes_p = np.asarray(boxes_p).astype(int)
    masks_p = np.asarray(masks_p).astype(np.uint8)
    num = len(ids_p)
    fused = img_origin

    if not cfg.hide_mask:
        # Color each pixel by (sum of instance ids + 1) mapped into
        # [1, len(COLORS) - 1], so overlaps get a distinct color and a
        # covered pixel never takes the background value 0.
        raw = (masks_p * (ids_p[:, None, None] + 1)).astype(int).sum(0)
        sem = np.where(raw > 0, 1 + (raw - 1) % (len(COLORS) - 1), 0)
        color_masks = COLORS[sem].astype(np.uint8)
        fused = blend(color_masks, img_origin, 0.4, 0.6)

        if cfg.cutout and img_name is not None:
            os.makedirs(out_dir, exist_ok=True)
            total = (sem != 0)[:, :, None] * img_origin
            backdrop = ((sem == 0) * 255)[:, :, None].repeat(3, 2)
            image_io.imwrite(osp.join(out_dir, f'{img_name}_total_obj.jpg'),
                             (total + backdrop).astype(np.uint8))
            for i in range(num):
                one = masks_p[i][:, :, None] * img_origin
                back = ((masks_p[i] == 0) * 255)[:, :, None].repeat(3, 2)
                x1, y1, x2, y2 = boxes_p[i]
                crop = (one + back)[y1:y2, x1:x2]
                if crop.size:       # a box outside the image crops to no image
                    image_io.imwrite(osp.join(out_dir, f'{img_name}_{i}.jpg'),
                                     crop.astype(np.uint8))

    if not cfg.hide_bbox:
        for i in reversed(range(num)):
            x1, y1, x2, y2 = boxes_p[i]
            color = COLORS[(ids_p[i] + 1) % len(COLORS)].tolist()
            rectangle(fused, (x1, y1), (x2, y2), color)
            name = cfg.class_names[ids_p[i]]
            text = name if cfg.hide_score else f'{name}: {scores_p[i]:.2f}'
            tw, th = text_size(text)
            rectangle(fused, (x1, y1), (x1 + tw, y1 + th + 5), color, filled=True)
            put_text(fused, text, (x1, y1 + 15))

    if cfg.real_time and fps is not None:
        text = f'fps: {fps:.2f}'
        tw, th = text_size(text)
        fused = fused.astype(np.float32)
        fused[0:th + 8, 0:tw + 8] *= 0.6
        fused = fused.astype(np.uint8)
        put_text(fused, text, (0, th + 2))
    return fused


def draw_lincomb(proto: np.ndarray, coefs: np.ndarray, img_name: str,
                 out_dir: str = 'results/images') -> None:
    """The --save_lincomb debug grid: the 32 prototypes [ph, pw, 32] of an
    image in 4 rows of 8, most-weighted first by |coef| of the first kept
    detection (coefs [K, 32]), each scaled by its maximum and its coef,
    mapped by cv2's WINTER colormap and written to
    `out_dir/lincomb_<img_name>`. The JAX package's draw_lincomb."""
    import cv2
    os.makedirs(out_dir, exist_ok=True)
    coef = np.asarray(coefs)[0]
    order = np.argsort(-np.abs(coef))
    ph, pw = proto.shape[:2]
    rows, cols = 4, 8
    grid = np.zeros((ph * rows, pw * cols), np.float32)
    for y in range(rows):
        for x in range(cols):
            i = y * cols + x
            p = np.asarray(proto[:, :, order[i]])
            cell = p / max(float(p.max()), 1e-6) * coef[order[i]]
            grid[y * ph:(y + 1) * ph, x * pw:(x + 1) * pw] = cell
    img = ((grid + 1) * 127.5).astype(np.uint8)
    img = cv2.applyColorMap(img, cv2.COLORMAP_WINTER)
    cv2.imwrite(osp.join(out_dir, f'lincomb_{img_name}'), img)
