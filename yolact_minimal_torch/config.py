"""Configuration system: dataclass registry with inheritance.

The port's own copy of the experiment registry (the six reference names plus
`swin_tiny_custom`), so the PyTorch package depends on nothing outside
itself, and `swin_large_coco`, which only the port has. Derived quantities
(anchor scales, batch-size-adaptive lr/lr_steps) are computed in
__post_init__ as the reference config does.
"""
from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

# Visualization palette: a deterministic random table (background first).
_rng = np.random.RandomState(42)
COLORS = np.concatenate(
    [np.zeros((1, 3), dtype='uint8'),
     _rng.randint(30, 256, size=(80, 3)).astype('uint8')], axis=0)

COCO_CLASSES = ('person', 'bicycle', 'car', 'motorcycle', 'airplane', 'bus', 'train',
                'truck', 'boat', 'traffic light', 'fire hydrant', 'stop sign', 'parking meter', 'bench',
                'bird', 'cat', 'dog', 'horse', 'sheep', 'cow', 'elephant',
                'bear', 'zebra', 'giraffe', 'backpack', 'umbrella', 'handbag', 'tie',
                'suitcase', 'frisbee', 'skis', 'snowboard', 'sports ball', 'kite', 'baseball bat',
                'baseball glove', 'skateboard', 'surfboard', 'tennis racket', 'bottle', 'wine glass', 'cup',
                'fork', 'knife', 'spoon', 'bowl', 'banana', 'apple', 'sandwich',
                'orange', 'broccoli', 'carrot', 'hot dog', 'pizza', 'donut', 'cake',
                'chair', 'couch', 'potted plant', 'bed', 'dining table', 'toilet', 'tv',
                'laptop', 'mouse', 'remote', 'keyboard', 'cell phone', 'microwave', 'oven',
                'toaster', 'sink', 'refrigerator', 'book', 'clock', 'vase', 'scissors',
                'teddy bear', 'hair drier', 'toothbrush')

PASCAL_CLASSES = ('aeroplane', 'bicycle', 'bird', 'boat', 'bottle',
                  'bus', 'car', 'cat', 'chair', 'cow',
                  'diningtable', 'dog', 'horse', 'motorbike', 'person',
                  'pottedplant', 'sheep', 'sofa', 'train', 'tvmonitor')

CUSTOM_CLASSES = ('dog', 'person', 'bear', 'sheep')

# COCO's 90 sparse category ids -> 80 contiguous ids (1-based).
_COCO_RAW_IDS = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19,
                 20, 21, 22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38,
                 39, 40, 41, 42, 43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55,
                 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 67, 70, 72, 73, 74, 75,
                 76, 77, 78, 79, 80, 81, 82, 84, 85, 86, 87, 88, 89, 90]
COCO_LABEL_MAP = {raw: i + 1 for i, raw in enumerate(_COCO_RAW_IDS)}

# The swin backbones by name: embed width, depths, heads (of width 32) a
# stage, window side and the last block's stochastic depth in training.
# Swin-T is the JAX package's. Swin-L at window 12 is the published one (Liu
# et al. 2021, arXiv:2103.14030 section 3.3; microsoft/Swin-Transformer,
# configs/swin/swin_large_patch4_window12_384_22k.yaml); its drop-path rate
# 0.3 is what the public Swin-L detection and segmentation configs train with.
SWIN_SPECS = {
    'swin_tiny': dict(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24),
                      window=7, drop_path_rate=0.2),
    'swin_large': dict(embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48),
                       window=12, drop_path_rate=0.3),
}

# Pixel normalization constants (BGR order).
NORM_MEAN = np.array([103.94, 116.78, 123.68], dtype=np.float32)
NORM_STD = np.array([57.38, 57.12, 58.40], dtype=np.float32)


@dataclass
class Config:
    """Base experiment config == reference `res101_coco`."""
    name: str = 'res101_coco'
    mode: str = 'detect'                     # train | val | detect
    backbone: str = 'resnet101'              # resnet50 | resnet101 | a SWIN_SPECS name
    img_size: int = 544
    class_names: Tuple[str, ...] = COCO_CLASSES
    continuous_id: Dict[int, int] = field(default_factory=lambda: dict(COCO_LABEL_MAP))

    # anchor geometry
    base_scales: Tuple[int, ...] = (24, 48, 96, 192, 384)
    aspect_ratios: Tuple[float, ...] = (1.0, 1 / 2, 2.0)

    # data paths
    data_root: str = 'data/'
    train_imgs: str = 'data/coco2017/train2017/'
    train_ann: str = 'data/coco2017/annotations/instances_train2017.json'
    val_imgs: str = 'data/coco2017/val2017/'
    val_ann: str = 'data/coco2017/annotations/instances_val2017.json'

    # training
    train_bs: int = 8
    base_lr: float = 0.001
    warmup_until: int = 500                  # warmup steps (not bs-scaled)
    base_lr_steps: Tuple[int, ...] = (0, 280000, 560000, 620000, 680000)
    pos_iou_thre: float = 0.5
    neg_iou_thre: float = 0.4
    conf_alpha: float = 1.0
    bbox_alpha: float = 1.5
    mask_alpha: float = 6.125
    semantic_alpha: float = 1.0
    masks_to_train: int = 100                # max masks in the lincomb loss
    max_gt: int = 128                        # static padded gt capacity
    optimizer: str = 'sgd'                   # sgd | adamw
    momentum: float = 0.9
    weight_decay: float = 5e-4
    val_interval: int = 4000
    val_num: int = -1
    val_bs: int = 8
    coco_api: bool = False
    strict: bool = False

    # postprocessing
    traditional_nms: bool = False
    nms_score_thre: float = 0.05
    nms_iou_thre: float = 0.5
    top_k: int = 200
    max_detections: int = 100
    # Candidate-anchor cap before the per-class top_k: anchors are ranked
    # once by max-class score and the per-class top_k runs inside the top
    # `nms_pre_topk`. Exact whenever at most this many anchors pass
    # nms_score_thre in one image; beyond the cap the lowest max-score
    # anchors drop first. <= 0 disables the preselect.
    nms_pre_topk: int = 1024

    # detect-mode options (reference detect.py argparse surface)
    visual_thre: float = 0.3
    hide_mask: bool = False
    hide_bbox: bool = False
    hide_score: bool = False
    cutout: bool = False
    save_lincomb: bool = False
    no_crop: bool = False
    real_time: bool = False
    image: Optional[str] = None
    video: Optional[str] = None
    video_bs: int = 8

    # pretrained backbone for training init; None -> per-backbone default.
    backbone_weight: Optional[str] = None

    # numerics: parameters are kept in f32; the network runs in this dtype.
    compute_dtype: str = 'float32'           # float32 | bfloat16
    # Recompute each backbone block in the backward pass (training only):
    # activation memory drops to about one block's, for one more forward of
    # the backbone.
    remat: bool = False

    def __post_init__(self):
        if self.img_size % 32:
            raise ValueError(f'img_size must be divisible by 32, got {self.img_size}.')
        self.scales = tuple(int(self.img_size / 544 * s) for s in self.base_scales)
        self.bs_factor = self.train_bs / 8
        self.lr = self.base_lr * self.bs_factor
        self.warmup_init = self.lr * 0.1
        self.lr_steps = tuple(int(s / self.bs_factor) for s in self.base_lr_steps)
        if self.backbone_weight is None:
            self.backbone_weight = {
                'resnet50': 'weights/backbone_res50.pth',
                'resnet101': 'weights/backbone_res101.pth',
            }.get(self.backbone)
            if self.is_swin:
                self.backbone_weight = f'weights/{self.backbone}.pth'

    @property
    def is_swin(self) -> bool:
        """Whether the backbone is one of SWIN_SPECS."""
        return self.backbone in SWIN_SPECS

    def replace(self, **kw) -> 'Config':
        return dataclasses.replace(self, **kw)

    @property
    def num_classes(self) -> int:
        return len(self.class_names) + 1

    def print_cfg(self):
        print()
        print('-' * 30 + self.name + '-' * 30)
        for k, v in vars(self).items():
            if k not in ('continuous_id', 'data_root'):
                print(f'{k}: {v}')
        print()


def _pascal_overrides():
    return dict(
        class_names=PASCAL_CLASSES,
        continuous_id={i + 1: i + 1 for i in range(len(PASCAL_CLASSES))},
        base_scales=(32, 64, 128, 256, 512),
        base_lr_steps=(0, 60000, 100000, 120000),
        train_imgs='data/pascal_sbd/img', train_ann='data/pascal_sbd/pascal_sbd_train.json',
        val_imgs='data/pascal_sbd/img', val_ann='data/pascal_sbd/pascal_sbd_val.json',
    )


def _custom_overrides():
    return dict(
        class_names=CUSTOM_CLASSES,
        continuous_id={i + 1: i + 1 for i in range(len(CUSTOM_CLASSES))},
        warmup_until=100,
        base_lr_steps=(0, 1200, 1600, 2000),
        train_imgs='custom_dataset/images', train_ann='custom_dataset/annotations.json',
        val_imgs='custom_dataset/images', val_ann='custom_dataset/annotations.json',
    )


CONFIG_REGISTRY: Dict[str, dict] = {
    'res101_coco': dict(backbone='resnet101'),
    'res50_coco': dict(backbone='resnet50'),
    'swin_tiny_coco': dict(backbone='swin_tiny', base_lr=0.00005,
                           optimizer='adamw', weight_decay=0.05),
    'res50_pascal': dict(backbone='resnet50', **_pascal_overrides()),
    'res101_custom': dict(backbone='resnet101', **_custom_overrides()),
    'res50_custom': dict(backbone='resnet50', **_custom_overrides()),
    'swin_tiny_custom': dict(backbone='swin_tiny', base_lr=0.00005,
                             optimizer='adamw', weight_decay=0.05,
                             **_custom_overrides()),
    # the port's own: Swin-L with swin_tiny_coco's neck, heads, postprocess
    # and AdamW settings (Yolact_minimal has no Swin-L config)
    'swin_large_coco': dict(backbone='swin_large', base_lr=0.00005,
                            optimizer='adamw', weight_decay=0.05),
}


def get_config(name: str, mode: str = 'detect', **overrides) -> Config:
    """Build a named experiment config."""
    if name not in CONFIG_REGISTRY:
        raise KeyError(f'Unknown config {name!r}; choose from {sorted(CONFIG_REGISTRY)}')
    kw = dict(CONFIG_REGISTRY[name])
    kw.update(overrides)
    return Config(name=name, mode=mode, **kw)


def cfg_name_from_weight(path: str) -> str:
    """Recover the config name from a checkpoint filename, which encodes
    `best_{mAP}_{cfg}_{step}` / `latest_{cfg}_{step}`."""
    stem = path.replace('\\', '/').split('/')[-1]
    for suffix in ('.ckpt', '.pth', '.msgpack'):
        if stem.endswith(suffix):
            stem = stem[: -len(suffix)]
    m = re.match(r'best_[\d.]+_(.+)_\d+$', stem) or re.match(r'latest_(.+)_\d+$', stem)
    if m:
        return m.group(1)
    for name in CONFIG_REGISTRY:
        if name in stem:
            return name
    raise ValueError(f'Cannot recover config name from weight filename {path!r}')
