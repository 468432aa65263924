"""RetinaFace (MobileNetV1-0.25) face detector (counterpart of
`adaface_tpu/models/retinaface.py`).

The network (biubug6/Pytorch_RetinaFace layout) runs NCHW inside, with
real `nn.BatchNorm2d` running statistics (eps 1e-5) in eval mode; it takes
and gives NHWC at its interface, as the JAX module does. Submodules carry
the flax tree's names (`stage1_0.conv`, `ssh1.conv5x5_1.bn`, `class_head_0`),
so `interop/from_jax.retinaface_state_dict_from_jax` is a rename.

- `ConvBN`: leaky ReLU 0.1 where `c_out <= 64`, else ReLU; `ConvDW` is
  always leaky 0.1. `SSH` concatenates its three non-ReLU branches, then
  applies one ReLU.
- The FPN's upsamples are `jax.image.resize(..., "nearest")`, whose
  half-pixel centres are torch's `nearest-exact`, not `nearest`.
- Anchor priors, box and landmark decoding (variances 0.1, 0.2) and greedy
  NMS run in numpy on the host, in JAX's order (`argsort()[::-1]`, keep
  IoU `<=` the threshold).
- `RetinaFaceDetector` has the `detect_fn` contract of `face_app.py`: an
  integer-index resize to `input_size` square minus the RGB means (no
  PIL), softmax column 1 as the score, a strict `>` threshold.
- `map_retinaface_torch_params` maps a `mobilenet0.25_Final.pth` state
  dict (read by `interop/torch_pickle.load_torch_checkpoint`) onto this
  module's names.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from adaface_tpu_torch.models.flax_init import seeded

MIN_SIZES = ((16, 32), (64, 128), (256, 512))
STRIDES = (8, 16, 32)
VARIANCES = (0.1, 0.2)
# RGB means in RGB order (the torch original subtracts BGR (104, 117, 123))
RGB_MEAN = (123.0, 117.0, 104.0)
BN_EPS = 1e-5


def _leaky(c_out: int) -> float:
    return 0.1 if c_out <= 64 else 0.0


class ConvBN(nn.Module):
    def __init__(self, c_in: int, c_out: int, stride: int = 1, kernel: int = 3,
                 relu: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, kernel, stride, kernel // 2, bias=False)
        self.bn = nn.BatchNorm2d(c_out, eps=BN_EPS)
        self.slope = _leaky(c_out) if relu else None

    def forward(self, x):
        x = self.bn(self.conv(x))
        if self.slope is None:
            return x
        return F.leaky_relu(x, self.slope) if self.slope else F.relu(x)


class ConvDW(nn.Module):
    """Depthwise-separable block (MobileNetV1)."""

    def __init__(self, c_in: int, c_out: int, stride: int = 1):
        super().__init__()
        self.dw_conv = nn.Conv2d(c_in, c_in, 3, stride, 1, groups=c_in, bias=False)
        self.dw_bn = nn.BatchNorm2d(c_in, eps=BN_EPS)
        self.pw_conv = nn.Conv2d(c_in, c_out, 1, bias=False)
        self.pw_bn = nn.BatchNorm2d(c_out, eps=BN_EPS)

    def forward(self, x):
        x = F.leaky_relu(self.dw_bn(self.dw_conv(x)), 0.1)
        return F.leaky_relu(self.pw_bn(self.pw_conv(x)), 0.1)


class SSH(nn.Module):
    """Context module: 3x3 + 5x5 + 7x7 receptive branches -> concat -> ReLU."""

    def __init__(self, c_in: int, c_out: int = 64):
        super().__init__()
        half, quarter = c_out // 2, c_out // 4
        self.conv3x3 = ConvBN(c_in, half, relu=False)
        self.conv5x5_1 = ConvBN(c_in, quarter)
        self.conv5x5_2 = ConvBN(quarter, quarter, relu=False)
        self.conv7x7_2 = ConvBN(quarter, quarter)
        self.conv7x7_3 = ConvBN(quarter, quarter, relu=False)

    def forward(self, x):
        c5_1 = self.conv5x5_1(x)
        c7 = self.conv7x7_3(self.conv7x7_2(c5_1))
        return F.relu(torch.cat([self.conv3x3(x), self.conv5x5_2(c5_1), c7], dim=1))


# (name, c_out, stride) of the MobileNetV1-0.25 backbone after stage1_0
_BACKBONE = ([("stage1_1", 16, 1), ("stage1_2", 32, 2), ("stage1_3", 32, 1),
              ("stage1_4", 64, 2), ("stage1_5", 64, 1), ("stage2_0", 128, 2)]
             + [(f"stage2_{i}", 128, 1) for i in range(1, 6)]
             + [("stage3_0", 256, 2), ("stage3_1", 256, 1)])


class RetinaFace(nn.Module):
    def __init__(self, out_ch: int = 64, num_anchors: int = 2):
        super().__init__()
        self.num_anchors = num_anchors
        self.stage1_0 = ConvBN(3, 8, 2)
        c = 8
        for name, c_out, stride in _BACKBONE:
            self.add_module(name, ConvDW(c, c_out, stride))
            c = c_out
        for i, c_in in ((1, 64), (2, 128), (3, 256)):
            self.add_module(f"fpn_output{i}", ConvBN(c_in, out_ch, kernel=1))
        self.fpn_merge2 = ConvBN(out_ch, out_ch)
        self.fpn_merge1 = ConvBN(out_ch, out_ch)
        for i in range(3):
            self.add_module(f"ssh{i + 1}", SSH(out_ch, out_ch))
            self.add_module(f"class_head_{i}", nn.Conv2d(out_ch, num_anchors * 2, 1))
            self.add_module(f"bbox_head_{i}", nn.Conv2d(out_ch, num_anchors * 4, 1))
            self.add_module(f"landmark_head_{i}", nn.Conv2d(out_ch, num_anchors * 10, 1))

    def forward(self, x: torch.Tensor):
        """[B, H, W, 3] (RGB minus `RGB_MEAN`) -> per level (cls [B, Ni, 2],
        bbox [B, Ni, 4], ldm [B, Ni, 10]) for strides 8, 16, 32."""
        h = self.stage1_0(x.permute(0, 3, 1, 2).to(self.stage1_0.conv.weight.dtype))
        levels = {"stage1_5": None, "stage2_5": None, "stage3_1": None}
        for name, _, _ in _BACKBONE:
            h = getattr(self, name)(h)
            if name in levels:
                levels[name] = h
        c1, c2, c3 = levels.values()
        p3 = self.fpn_output3(c3)
        p2 = self.fpn_output2(c2)
        p1 = self.fpn_output1(c1)
        p2 = self.fpn_merge2(p2 + F.interpolate(p3, size=p2.shape[2:], mode="nearest-exact"))
        p1 = self.fpn_merge1(p1 + F.interpolate(p2, size=p1.shape[2:], mode="nearest-exact"))
        outs = []
        for i, p in enumerate((p1, p2, p3)):
            f = getattr(self, f"ssh{i + 1}")(p)
            outs.append(tuple(
                getattr(self, f"{name}_{i}")(f).permute(0, 2, 3, 1).reshape(f.shape[0], -1, n)
                for name, n in (("class_head", 2), ("bbox_head", 4), ("landmark_head", 10))))
        return outs


def init_retinaface(seed: int = 0, device=None) -> RetinaFace:
    """A random detector from a torch seed with flax's initial laws
    (`models/flax_init.py`; the JAX scripts draw theirs from PRNGKey(0):
    same laws, other numbers)."""
    return seeded(RetinaFace(), seed, device)


# ---------------------------------------------------------------- decoding

def make_priors(height: int, width: int) -> np.ndarray:
    """[N, 4] (cx, cy, w, h) normalized anchor boxes."""
    priors = []
    for s, sizes in zip(STRIDES, MIN_SIZES):
        fh, fw = int(np.ceil(height / s)), int(np.ceil(width / s))
        for y in range(fh):
            for x in range(fw):
                for m in sizes:
                    priors.append([(x + 0.5) * s / width, (y + 0.5) * s / height,
                                   m / width, m / height])
    return np.asarray(priors, np.float32)


def decode_boxes(loc: np.ndarray, priors: np.ndarray) -> np.ndarray:
    """SSD decode with variances (0.1, 0.2) -> [N, 4] xyxy normalized."""
    cxcy = priors[:, :2] + loc[:, :2] * VARIANCES[0] * priors[:, 2:]
    wh = priors[:, 2:] * np.exp(loc[:, 2:] * VARIANCES[1])
    return np.concatenate([cxcy - wh / 2, cxcy + wh / 2], axis=1)


def decode_landmarks(ldm: np.ndarray, priors: np.ndarray) -> np.ndarray:
    """[N, 10] -> [N, 5, 2] normalized landmark points."""
    pts = ldm.reshape(-1, 5, 2)
    return priors[:, None, :2] + pts * VARIANCES[0] * priors[:, None, 2:]


def nms(boxes: np.ndarray, scores: np.ndarray, thresh: float = 0.4) -> List[int]:
    """Greedy NMS: indices kept, best score first (ties in
    `argsort()[::-1]`'s order); a box goes where its IoU with a kept one
    exceeds `thresh`."""
    order = scores.argsort()[::-1]
    keep = []
    while order.size:
        i = order[0]
        keep.append(int(i))
        if order.size == 1:
            break
        rest = order[1:]
        xx1 = np.maximum(boxes[i, 0], boxes[rest, 0])
        yy1 = np.maximum(boxes[i, 1], boxes[rest, 1])
        xx2 = np.minimum(boxes[i, 2], boxes[rest, 2])
        yy2 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0)
        a = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        b = (boxes[rest, 2] - boxes[rest, 0]) * (boxes[rest, 3] - boxes[rest, 1])
        iou = inter / (a + b - inter + 1e-12)
        order = rest[iou <= thresh]
    return keep


class RetinaFaceDetector:
    """image -> [(bbox[4], landmarks[5, 2], score)], the network on its
    module's device, decode and NMS on the host."""

    def __init__(self, model: RetinaFace, input_size: int = 320,
                 score_thresh: float = 0.5, nms_thresh: float = 0.4):
        self.model = model.eval().requires_grad_(False)
        self.size = input_size
        self.score_thresh = score_thresh
        self.nms_thresh = nms_thresh
        self.priors = make_priors(input_size, input_size)

    def prepare(self, image: np.ndarray) -> np.ndarray:
        """[size, size, 3] fp32 network input: integer-index resize, minus
        the RGB means."""
        h, w = image.shape[:2]
        ri = (np.arange(self.size) * (h / self.size)).astype(np.int64)
        ci = (np.arange(self.size) * (w / self.size)).astype(np.int64)
        return (image[ri][:, ci].astype(np.float32) - np.asarray(RGB_MEAN)).astype(np.float32)

    @torch.inference_mode()
    def heads(self, image: np.ndarray):
        """(softmaxed cls [N, 2], bbox [N, 4], ldm [N, 10]) of one image, numpy."""
        dev = self.model.stage1_0.conv.weight.device
        outs = self.model(torch.from_numpy(self.prepare(image)[None]).to(dev))
        cls = torch.cat([torch.softmax(o[0].float(), -1) for o in outs], 1)
        box = torch.cat([o[1].float() for o in outs], 1)
        ldm = torch.cat([o[2].float() for o in outs], 1)
        return cls[0].cpu().numpy(), box[0].cpu().numpy(), ldm[0].cpu().numpy()

    def decode(self, image_shape, cls, box, ldm) -> List[tuple]:
        h, w = image_shape[:2]
        scores = cls[:, 1]
        sel = scores > self.score_thresh
        if not sel.any():
            return []
        boxes = decode_boxes(box[sel], self.priors[sel])
        lms = decode_landmarks(ldm[sel], self.priors[sel])
        sc = scores[sel]
        scale = np.asarray([w, h, w, h], np.float32)
        return [(boxes[i] * scale, lms[i] * np.asarray([w, h], np.float32), float(sc[i]))
                for i in nms(boxes, sc, self.nms_thresh)]

    def __call__(self, image: np.ndarray) -> List[tuple]:
        return self.decode(image.shape, *self.heads(image))


def biubug6_names() -> List[Tuple[str, str]]:
    """(this module's name, the biubug6 file's name) of every tensor of a
    `mobilenet0.25_Final.pth`, BatchNorms' `num_batches_tracked` included."""
    pairs: List[Tuple[str, str]] = []

    def conv(ours, theirs, bias=False):
        pairs.extend((f"{ours}.{k}", f"{theirs}.{k}") for k in ("weight", "bias")[:1 + bias])

    def bn(ours, theirs):
        pairs.extend((f"{ours}.{k}", f"{theirs}.{k}") for k in (
            "weight", "bias", "running_mean", "running_var", "num_batches_tracked"))

    def conv_bn(ours, theirs):
        conv(ours + ".conv", theirs + ".0")
        bn(ours + ".bn", theirs + ".1")

    conv_bn("stage1_0", "body.stage1.0")
    for name, _, _ in _BACKBONE:
        theirs = f"body.stage{name[5]}.{name[7]}"
        conv(name + ".dw_conv", theirs + ".0")
        bn(name + ".dw_bn", theirs + ".1")
        conv(name + ".pw_conv", theirs + ".3")
        bn(name + ".pw_bn", theirs + ".4")
    for name in ("output1", "output2", "output3", "merge1", "merge2"):
        conv_bn(f"fpn_{name}", f"fpn.{name}")
    for i in range(1, 4):
        for ours, theirs in (("conv3x3", "conv3X3"), ("conv5x5_1", "conv5X5_1"),
                             ("conv5x5_2", "conv5X5_2"), ("conv7x7_2", "conv7X7_2"),
                             ("conv7x7_3", "conv7x7_3")):
            conv_bn(f"ssh{i}.{ours}", f"ssh{i}.{theirs}")
    for i in range(3):
        for ours, theirs in (("class_head", "ClassHead"), ("bbox_head", "BboxHead"),
                             ("landmark_head", "LandmarkHead")):
            conv(f"{ours}_{i}", f"{theirs}.{i}.conv1x1", bias=True)
    return pairs


def map_retinaface_torch_params(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A biubug6/Pytorch_RetinaFace `mobilenet0.25_Final.pth` state dict ->
    this module's state dict (what `load_state_dict(strict=True)` takes).
    The file's `num_batches_tracked` is kept where it has one, else 0."""
    out: Dict[str, torch.Tensor] = {}
    for ours, theirs in biubug6_names():
        if theirs.endswith("num_batches_tracked") and theirs not in sd:
            out[ours] = torch.tensor(0, dtype=torch.long)
        else:
            out[ours] = torch.as_tensor(np.asarray(sd[theirs]))
    return out
