"""SCRFD face detector (insightface antelopev2's `scrfd_10g_bnkps`),
counterpart of `adaface_tpu/models/scrfd.py`.

NCHW inside, NHWC at the interface; submodules carry the flax tree's names
(`backbone.layer1_0.ds_conv`, `neck.lateral_0`, `head.cls_gn_0`), so
`interop/from_jax.scrfd_state_dict_from_jax` is the plain tree map.

- backbone: ResNetV1e, a deep 3x3 stem (s, s, 2s) and BasicBlocks; the
  downsample is a 2x2 average pool (at stride 2 only) and then a 1x1 conv;
  its BatchNorm is the inference formula with the running statistics as
  parameters, eps 1e-5 (`models/arcface.BN`);
- neck: PAFPN over the last three stages, top-down upsamples as
  `jax.image.resize(..., "nearest")` (torch's `nearest-exact`);
- head: one shared head per scale, conv + GroupNorm (flax's eps 1e-6, not
  torch's 1e-5) + ReLU towers, sigmoid scores, stride-unit distances.

`decode_scrfd` (numpy) follows insightface: anchor centres `(x, y) *
stride` repeated per anchor, distances times the stride, a `>=` score
threshold, greedy NMS (`retinaface.nms`). `SCRFDDetector` letterboxes at the
top left, normalizes as (x - 127.5) / 128 and divides boxes and keypoints by
the scale. Its resize is Pillow's default (bicubic) filter, which JAX's
detector takes where PIL imports, computed by `data/resample.py` bit for bit
with no PIL (the card's machine has none); `resample="index"` takes the
integer-index sampling of JAX's branch without PIL instead. A frame already
at the letterbox size is copied, as PIL's resize copies it. JAX has no SCRFD weight reader, so neither has
the port; `init_scrfd` draws seeded weights.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from adaface_tpu_torch.data.resample import resize
from adaface_tpu_torch.models.arcface import BN
from adaface_tpu_torch.models.flax_init import seeded
from adaface_tpu_torch.models.retinaface import nms

STRIDES = (8, 16, 32)
NUM_ANCHORS = 2
NUM_KPS = 5
GN_EPS = 1e-6  # flax nn.GroupNorm's default


@dataclasses.dataclass(frozen=True)
class SCRFDConfig:
    # ResNetV1e backbone: NAS-searched stage widths/depths of SCRFD-10G
    stem_channels: int = 28  # stem convs run at stem_channels, out 2x
    stage_blocks: tuple = (3, 5, 2, 3)
    stage_planes: tuple = (56, 88, 88, 224)
    neck_out: int = 56
    head_stacked_convs: int = 4
    head_feat_channels: int = 80
    gn_groups: int = 8

    @classmethod
    def scrfd_10g(cls) -> "SCRFDConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "SCRFDConfig":
        return cls(stem_channels=8, stage_blocks=(1, 1, 1, 1), stage_planes=(16, 16, 16, 16),
                   neck_out=16, head_stacked_convs=1, head_feat_channels=16, gn_groups=4)


def _conv(cin: int, cout: int, k: int = 3, s: int = 1, bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, s, (k - 1) // 2, bias=bias)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv1 = _conv(cin, planes, 3, stride)
        self.bn1 = BN(planes)
        self.conv2 = _conv(planes, planes)
        self.bn2 = BN(planes)
        self.has_downsample = stride != 1 or cin != planes
        if self.has_downsample:
            self.ds_conv = _conv(cin, planes, 1)
            self.ds_bn = BN(planes)

    def forward(self, x):
        h = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        if self.has_downsample:
            # ResNetV1e: 2x2 average pool, then the 1x1 conv
            if self.stride != 1:
                x = F.avg_pool2d(x, 2, 2)
            x = self.ds_bn(self.ds_conv(x))
        return F.relu(h + x)


class ResNetV1e(nn.Module):
    def __init__(self, cfg: SCRFDConfig):
        super().__init__()
        s = cfg.stem_channels
        self.stem1, self.stem_bn1 = _conv(3, s, 3, 2), BN(s)
        self.stem2, self.stem_bn2 = _conv(s, s), BN(s)
        self.stem3, self.stem_bn3 = _conv(s, 2 * s), BN(2 * s)
        self.stages = []
        c = 2 * s
        for i, (blocks, planes) in enumerate(zip(cfg.stage_blocks, cfg.stage_planes)):
            names = []
            for j in range(blocks):
                self.add_module(f"layer{i + 1}_{j}", BasicBlock(c, planes, 2 if j == 0 else 1))
                names.append(f"layer{i + 1}_{j}")
                c = planes
            self.stages.append(names)

    def forward(self, x) -> List[torch.Tensor]:
        h = F.relu(self.stem_bn1(self.stem1(x)))
        h = F.relu(self.stem_bn2(self.stem2(h)))
        h = F.relu(self.stem_bn3(self.stem3(h)))
        outs = []
        for names in self.stages:
            for name in names:
                h = getattr(self, name)(h)
            outs.append(h)
        return outs  # strides 4, 8, 16, 32


class PAFPN(nn.Module):
    """Path-aggregation FPN over the last 3 backbone stages -> 3 maps at
    strides 8/16/32, all `neck_out` channels."""

    def __init__(self, cfg: SCRFDConfig):
        super().__init__()
        c = cfg.neck_out
        for i, cin in enumerate(cfg.stage_planes[-3:]):
            self.add_module(f"lateral_{i}", _conv(cin, c, 1, bias=True))
            self.add_module(f"fpn_{i}", _conv(c, c, bias=True))
            self.add_module(f"pafpn_{i}", _conv(c, c, bias=True))
        for i in range(2):
            self.add_module(f"down_{i}", _conv(c, c, 3, 2, bias=True))

    def forward(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        lat = [getattr(self, f"lateral_{i}")(f) for i, f in enumerate(feats[-3:])]
        for i in range(len(lat) - 1, 0, -1):
            lat[i - 1] = lat[i - 1] + F.interpolate(lat[i], size=lat[i - 1].shape[2:],
                                                    mode="nearest-exact")
        inter = [getattr(self, f"fpn_{i}")(l) for i, l in enumerate(lat)]
        outs = [inter[0]]
        for i in range(1, len(inter)):
            outs.append(inter[i] + getattr(self, f"down_{i - 1}")(outs[-1]))
        return [getattr(self, f"pafpn_{i}")(o) for i, o in enumerate(outs)]


class SCRFDHead(nn.Module):
    """The head shared by the three scales: conv+GN+ReLU towers; the kps
    branch rides the reg tower (the `bnkps` variant)."""

    def __init__(self, cfg: SCRFDConfig):
        super().__init__()
        self.n = cfg.head_stacked_convs
        f = cfg.head_feat_channels
        for i in range(self.n):
            cin = cfg.neck_out if i == 0 else f
            for branch in ("cls", "reg"):
                self.add_module(f"{branch}_conv_{i}", _conv(cin, f, bias=True))
                self.add_module(f"{branch}_gn_{i}", nn.GroupNorm(cfg.gn_groups, f, eps=GN_EPS))
        self.cls_pred = _conv(f, NUM_ANCHORS, 1, bias=True)
        self.bbox_pred = _conv(f, NUM_ANCHORS * 4, 1, bias=True)
        self.kps_pred = _conv(f, NUM_ANCHORS * NUM_KPS * 2, 1, bias=True)

    def forward(self, x):
        cls = reg = x
        for i in range(self.n):
            cls = F.relu(getattr(self, f"cls_gn_{i}")(getattr(self, f"cls_conv_{i}")(cls)))
            reg = F.relu(getattr(self, f"reg_gn_{i}")(getattr(self, f"reg_conv_{i}")(reg)))
        nhwc = lambda t: t.permute(0, 2, 3, 1)
        return (nhwc(torch.sigmoid(self.cls_pred(cls))), nhwc(self.bbox_pred(reg)),
                nhwc(self.kps_pred(reg)))


class SCRFD(nn.Module):
    def __init__(self, cfg: SCRFDConfig = SCRFDConfig()):
        super().__init__()
        self.cfg = cfg
        self.backbone = ResNetV1e(cfg)
        self.neck = PAFPN(cfg)
        self.head = SCRFDHead(cfg)

    def forward(self, x: torch.Tensor) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        """x: [B, H, W, 3] normalized ((rgb - 127.5) / 128). Per stride (8,
        16, 32): (scores [B, h, w, 2], bbox [B, h, w, 8], kps [B, h, w, 20]),
        distances in stride units, like the ONNX model."""
        x = x.permute(0, 3, 1, 2).to(self.backbone.stem1.weight.dtype)
        return [self.head(m) for m in self.neck(self.backbone(x))]


def init_scrfd(seed: int = 0, cfg: SCRFDConfig = None, device=None) -> SCRFD:
    """A seeded SCRFD in eval mode: flax's initial laws
    (`models/flax_init.py`), drawn from a torch seed (JAX's `init_scrfd`
    draws from a PRNGKey: other numbers)."""
    return seeded(SCRFD(cfg or SCRFDConfig.scrfd_10g()), seed, device)


# ------------------------------------------------------------- host decode

def distance2bbox(centers: np.ndarray, dist: np.ndarray) -> np.ndarray:
    """(l, t, r, b) stride-scaled distances -> x1y1x2y2."""
    return np.stack([centers[:, 0] - dist[:, 0], centers[:, 1] - dist[:, 1],
                     centers[:, 0] + dist[:, 2], centers[:, 1] + dist[:, 3]], axis=-1)


def distance2kps(centers: np.ndarray, dist: np.ndarray) -> np.ndarray:
    """[N, 10] offsets -> [N, 5, 2] keypoints."""
    return dist.reshape(-1, NUM_KPS, 2) + centers[:, None, :]


def decode_scrfd(outputs, score_thresh: float = 0.5, nms_thresh: float = 0.4) -> List[tuple]:
    """Per-stride head outputs (numpy NHWC, batch 1) -> detections
    [(bbox[4], kps[5, 2], score)]."""
    boxes_all, kps_all, scores_all = [], [], []
    for stride, (score, bbox, kps) in zip(STRIDES, outputs):
        score = np.asarray(score)
        s = score[0].reshape(-1)  # [h*w*2]
        h, w = score.shape[1:3]
        b = np.asarray(bbox)[0].reshape(h * w, NUM_ANCHORS, 4) * stride
        k = np.asarray(kps)[0].reshape(h * w, NUM_ANCHORS, NUM_KPS * 2) * stride
        yy, xx = np.mgrid[:h, :w]
        centers = np.stack([xx.ravel(), yy.ravel()], axis=-1) * stride
        centers = np.repeat(centers, NUM_ANCHORS, axis=0).astype(np.float32)
        keep = np.nonzero(s >= score_thresh)[0]
        if len(keep) == 0:
            continue
        boxes_all.append(distance2bbox(centers[keep], b.reshape(-1, 4)[keep]))
        kps_all.append(distance2kps(centers[keep], k.reshape(-1, NUM_KPS * 2)[keep]))
        scores_all.append(s[keep])
    if not boxes_all:
        return []
    boxes = np.concatenate(boxes_all)
    kps = np.concatenate(kps_all)
    scores = np.concatenate(scores_all)
    return [(boxes[i], kps[i], float(scores[i])) for i in nms(boxes, scores, nms_thresh)]


def letterbox_resize(image: np.ndarray, nh: int, nw: int,
                     resample: str = "bicubic") -> np.ndarray:
    """`image` at nh x nw: a copy at its own size, else Pillow's default
    (bicubic) resize by `data/resample.py`, or with resample="index" the
    integer-index sampling of JAX's branch without PIL."""
    H, W = image.shape[:2]
    if (nh, nw) == (H, W):
        return image.copy()
    if resample == "index":
        yi = (np.arange(nh) * H / nh).astype(int)
        xi = (np.arange(nw) * W / nw).astype(int)
        return image[yi][:, xi]
    if resample != "bicubic":
        raise ValueError(f"resample {resample!r}: bicubic or index")
    return resize(image.astype(np.uint8), (nw, nh), "bicubic")


class SCRFDDetector:
    """`detect_fn` of `face_app.py`: letterbox to `input_size`, the network
    on its module's device, host decode, boxes and keypoints in the
    original frame."""

    def __init__(self, model: SCRFD, input_size: Tuple[int, int] = (640, 640),
                 score_thresh: float = 0.5, nms_thresh: float = 0.4,
                 resample: str = "bicubic"):
        self.model = model.eval().requires_grad_(False)
        self.input_size = input_size
        self.score_thresh = score_thresh
        self.nms_thresh = nms_thresh
        self.resample = resample  # letterbox_resize's

    def prepare(self, image: np.ndarray) -> Tuple[np.ndarray, float]:
        """(normalized [ih, iw, 3] fp32 canvas, scale)."""
        H, W = image.shape[:2]
        ih, iw = self.input_size
        scale = min(ih / H, iw / W)
        nh, nw = int(round(H * scale)), int(round(W * scale))
        canvas = np.zeros((ih, iw, 3), np.float32)
        canvas[:nh, :nw] = letterbox_resize(image, nh, nw, self.resample)
        return (canvas - 127.5) / 128.0, scale

    @torch.inference_mode()
    def heads(self, x: np.ndarray):
        """Per-stride (score, bbox, kps) numpy NHWC of one prepared canvas."""
        dev = self.model.backbone.stem1.weight.device
        outs = self.model(torch.from_numpy(x[None]).to(dev))
        return [tuple(t.float().cpu().numpy() for t in o) for o in outs]

    def __call__(self, image: np.ndarray) -> List[tuple]:
        x, scale = self.prepare(image)
        dets = decode_scrfd(self.heads(x), self.score_thresh, self.nms_thresh)
        return [(box / scale, kp / scale, sc) for box, kp, sc in dets]
