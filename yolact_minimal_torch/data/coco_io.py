"""COCO annotation IO: the json index, polygon rasterization and the COCO
compressed-RLE codec (the port's own copy; no pycocotools).

The RLE string codec follows the public COCO mask format: 5-bit varints,
delta-coded from two counts back, column-major runs starting with zeros.
Polygons are filled with cv2.fillPoly, imported when a polygon is first
rasterized: another fill rule (PIL's) differs at edge pixels, and so would
every mask IoU that the evaluation computes. Importing this module needs no
cv2.
"""
from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List

import numpy as np

NO_CV2 = ('evaluation needs cv2: polygon annotations are rasterized with '
          'cv2.fillPoly, and no other fill gives the same edge pixels')


# --- RLE codec (COCO compressed format) ------------------------------------

def rle_encode_counts(counts: List[int]) -> str:
    s = []
    for i, c in enumerate(counts):
        x = int(c)
        if i > 2:
            x -= int(counts[i - 2])
        while True:
            ch = x & 0x1F
            x >>= 5
            more = (x != -1) if (ch & 0x10) else (x != 0)
            if more:
                ch |= 0x20
            s.append(chr(ch + 48))
            if not more:
                break
    return ''.join(s)


def rle_decode_counts(s: str) -> List[int]:
    counts: List[int] = []
    p = 0
    while p < len(s):
        x, k = 0, 0
        while True:
            c = ord(s[p]) - 48
            x |= (c & 0x1F) << (5 * k)
            p += 1
            k += 1
            if not (c & 0x20):
                if c & 0x10:
                    x |= -1 << (5 * k)
                break
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def mask_to_rle(mask: np.ndarray) -> Dict:
    """Binary [h, w] mask -> {'size': [h, w], 'counts': str} (column-major
    runs, the first run counts zeros)."""
    h, w = mask.shape
    flat = np.asfortranarray(mask.astype(np.uint8)).ravel(order='F')
    diffs = np.nonzero(flat[1:] != flat[:-1])[0] + 1
    bounds = np.concatenate([[0], diffs, [flat.size]])
    counts = np.diff(bounds).tolist()
    if flat.size and flat[0] == 1:
        counts = [0] + counts
    if not flat.size:
        counts = [0]
    return {'size': [int(h), int(w)], 'counts': rle_encode_counts(counts)}


def rle_to_mask(rle: Dict) -> np.ndarray:
    h, w = rle['size']
    counts = rle['counts']
    if isinstance(counts, (bytes, str)):
        counts = rle_decode_counts(counts if isinstance(counts, str)
                                   else counts.decode('ascii'))
    flat = np.zeros(h * w, np.uint8)
    pos, val = 0, 0
    for c in counts:
        if val:
            flat[pos:pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape((w, h)).T  # column-major layout


def require_cv2():
    """Raise ImportError with NO_CV2 when cv2 does not import."""
    try:
        import cv2  # noqa: F401
    except ImportError:
        raise ImportError(NO_CV2) from None


# --- annotation index --------------------------------------------------------

class COCO:
    """A minimal pycocotools.coco.COCO: imgToAnns / getAnnIds / loadAnns /
    loadImgs / annToMask over an instances-style json."""

    def __init__(self, annotation_file: str):
        with open(annotation_file) as f:
            d = json.load(f)
        self.dataset = d
        self.anns = {a['id']: a for a in d.get('annotations', [])}
        self.imgs = {i['id']: i for i in d.get('images', [])}
        self.cats = {c['id']: c for c in d.get('categories', [])}
        self.imgToAnns: Dict[int, List[dict]] = defaultdict(list)
        for a in d.get('annotations', []):
            self.imgToAnns[a['image_id']].append(a)
        self.imgToAnns = dict(self.imgToAnns)

    def getAnnIds(self, imgIds) -> List[int]:
        if np.isscalar(imgIds):
            imgIds = [imgIds]
        out = []
        for i in imgIds:
            out += [a['id'] for a in self.imgToAnns.get(i, [])]
        return out

    def loadAnns(self, ids) -> List[dict]:
        if np.isscalar(ids):
            ids = [ids]
        return [self.anns[i] for i in ids]

    def loadImgs(self, ids) -> List[dict]:
        if np.isscalar(ids):
            ids = [ids]
        return [self.imgs[i] for i in ids]

    def annToMask(self, ann: dict) -> np.ndarray:
        img = self.imgs[ann['image_id']]
        h, w = img['height'], img['width']
        seg = ann['segmentation']
        if isinstance(seg, list):                       # polygons
            require_cv2()
            import cv2
            mask = np.zeros((h, w), np.uint8)
            for poly in seg:
                pts = np.asarray(poly, np.float64).reshape(-1, 2)
                cv2.fillPoly(mask, [np.round(pts).astype(np.int32)], 1)
            return mask
        return rle_to_mask(seg)                         # RLE (crowd regions)
