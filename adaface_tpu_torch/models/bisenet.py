"""BiSeNet face-parsing network (19 classes), counterpart of
`adaface_tpu/models/bisenet.py`.

BiSeNet V1 with a ResNet-18 context path, as the face-parsing.PyTorch repo
builds it; inference only, every BatchNorm folded into the conv before it by
`interop/bisenet.py`, so each ConvBNReLU is a biased conv and a ReLU. NCHW
inside, NHWC at the interface; submodules carry the flax tree's names.

- ResNet-18 trunk -> feat8 / feat16 / feat32; its max pool pads with -inf;
- context path: a global-average context conv and two attention refinement
  modules (ARM), with top-down upsamples as `jax.image.resize(...,
  "nearest")` (half-pixel centres: torch's `nearest-exact`; the source
  repo's `nearest` agrees only at exact 2x ratios) and 3x3 heads;
- feature fusion module (FFM) of feat8 and the refined feat16;
- 3x3 + 1x1 head -> logits, upsampled to the input by bilinear with
  `align_corners=True`.

`preprocess` (ImageNet normalization of uint8 pixels) and `parsing_to_mask`
(non-background -> 255, and the count of classes present, the background
included) are the mask generator's.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from adaface_tpu_torch.models.flax_init import seeded

N_PARSING_CLASSES = 19
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, k // 2)


def max_pool_3x3s2(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 max pool, one pixel of -inf padding a side."""
    return F.max_pool2d(x, 3, 2, 1)


def resize_nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """`jax.image.resize(..., "nearest")`: half-pixel centres."""
    return F.interpolate(x, size=(h, w), mode="nearest-exact")


def resize_bilinear_ac(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=True)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, features, 3, stride)
        self.conv2 = _conv(features, features, 3)
        self.downsample = (_conv(cin, features, 1, stride)
                           if stride != 1 or cin != features else None)

    def forward(self, x):
        h = self.conv2(F.relu(self.conv1(x)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + h)


class ResNet18(nn.Module):
    """(feat8, feat16, feat32): strides 8, 16, 32."""

    def __init__(self):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, 2)
        cin = 64
        for layer, width in ((1, 64), (2, 128), (3, 256), (4, 512)):
            for blk in (0, 1):
                stride = 2 if (blk == 0 and layer > 1) else 1
                self.add_module(f"layer{layer}_{blk}", BasicBlock(cin, width, stride))
                cin = width

    def forward(self, x):
        h = max_pool_3x3s2(F.relu(self.conv1(x)))
        feats = []
        for layer in (1, 2, 3, 4):
            for blk in (0, 1):
                h = getattr(self, f"layer{layer}_{blk}")(h)
            feats.append(h)
        return tuple(feats[1:])


class ARM(nn.Module):
    """Attention refinement: a 3x3 conv, then a global channel gate."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv = _conv(cin, features, 3)
        self.conv_atten = _conv(features, features, 1)

    def forward(self, x):
        feat = F.relu(self.conv(x))
        return feat * torch.sigmoid(self.conv_atten(feat.mean(dim=(2, 3), keepdim=True)))


class FFM(nn.Module):
    """Feature fusion: a 1x1 fuse and a squeeze-excite residual gate."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.convblk = _conv(cin, features, 1)
        self.conv1 = _conv(features, features // 4, 1)
        self.conv2 = _conv(features // 4, features, 1)

    def forward(self, sp, cp):
        feat = F.relu(self.convblk(torch.cat([sp, cp], dim=1)))
        a = torch.sigmoid(self.conv2(F.relu(self.conv1(feat.mean(dim=(2, 3), keepdim=True)))))
        return feat * a + feat


class Head(nn.Module):
    """BiSeNetOutput: a 3x3 conv head and the 1x1 classifier."""

    def __init__(self, cin: int, mid: int, n_classes: int = N_PARSING_CLASSES):
        super().__init__()
        self.conv = _conv(cin, mid, 3)
        self.conv_out = _conv(mid, n_classes, 1)

    def forward(self, x):
        return self.conv_out(F.relu(self.conv(x)))


class BiSeNet(nn.Module):
    def __init__(self, n_classes: int = N_PARSING_CLASSES):
        super().__init__()
        self.resnet = ResNet18()
        self.conv_avg = _conv(512, 128, 1)
        self.arm32 = ARM(512, 128)
        self.conv_head32 = _conv(128, 128, 3)
        self.arm16 = ARM(256, 128)
        self.conv_head16 = _conv(128, 128, 3)
        self.ffm = FFM(256, 256)
        self.conv_out = Head(256, 256, n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, H, W, 3] ImageNet-normalized -> [B, H, W, classes] logits
        (the main head only)."""
        H, W = x.shape[1:3]
        x = x.permute(0, 3, 1, 2).to(self.conv_avg.weight.dtype)
        feat8, feat16, feat32 = self.resnet(x)
        avg = F.relu(self.conv_avg(feat32.mean(dim=(2, 3), keepdim=True)))
        f32 = resize_nearest(self.arm32(feat32) + avg, *feat16.shape[2:])
        f32 = F.relu(self.conv_head32(f32))
        f16 = resize_nearest(self.arm16(feat16) + f32, *feat8.shape[2:])
        f16 = F.relu(self.conv_head16(f16))
        out = self.conv_out(self.ffm(feat8, f16))
        return resize_bilinear_ac(out, H, W).permute(0, 2, 3, 1)


def init_bisenet(seed: int = 0, device=None) -> BiSeNet:
    """A random parser from a torch seed, flax's initial laws (the JAX
    script draws its smoke weights from PRNGKey(0))."""
    return seeded(BiSeNet(), seed, device)


def preprocess(images_uint8: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] uint8 -> ImageNet-normalized fp32."""
    x = images_uint8.float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return (x - mean) / std


def parsing_to_mask(parsing: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """argmax parsing [B, H, W] -> (mask uint8 [B, H, W]: 255 where the class
    is not the background, parts [B]: the classes present, 0 included)."""
    mask = (parsing != 0).to(torch.uint8) * 255
    b = parsing.shape[0]
    present = torch.zeros(b, N_PARSING_CLASSES, dtype=torch.int32, device=parsing.device)
    present.scatter_(1, parsing.reshape(b, -1).long(), 1)
    return mask, present.sum(dim=-1, dtype=torch.int32)
