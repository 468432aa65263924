"""ArcFace face recognizer (IResNet) and its face alignment (counterpart of
`adaface_tpu/models/arcface.py`).

IResNet in insightface's layout, NCHW:
  conv3x3(64) -> BN -> PReLU
  4 stages of IBasicBlocks, channels (64, 128, 256, 512),
  depths iresnet50 (3, 4, 14, 3), iresnet100 (3, 13, 30, 3)
  IBasicBlock: BN -> conv3x3 -> BN -> PReLU -> conv3x3(stride) -> BN,
               + shortcut (1x1 conv + BN where stride or channels change)
  head: BN -> flatten (C, H, W) -> FC(512) -> BN
BatchNorm runs in inference form with eps 1e-5; PReLU is per channel.

Input: 112x112 RGB, `(x - 127.5) / 127.5`; output: the 512-d embedding
(callers L2-normalize it). `map_arcface_onnx_params` maps an insightface
ONNX export (`interop/onnx_weights.py`) by walking its Conv /
BatchNormalization / PRelu / Gemm nodes in graph order. The export flattens
NCHW features, so its Gemm weight takes the features in C, H, W order; this
module flattens the same way and loads the weight as it is. (The JAX
package's IResNet flattens NHWC features and its map does not permute the
Gemm weight, so real weights there give other embeddings; the port follows
the file. `interop/from_jax.py` permutes a JAX tree's fc rows so that both
packages compute the same thing on the same params.)

The convolutions and the head are plain PyTorch, as XLA ran them: no
module here is a TPU kernel. Alignment (`estimate_norm`, the 5-point
Umeyama fit to `ARCFACE_DST`) runs on the host; the bilinear warp has a host
form (`warp_affine`, numpy) and a batched tensor form (`warp_affine_torch`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from adaface_tpu_torch.ops.basic import resize_aa


@dataclasses.dataclass(frozen=True)
class IResNetConfig:
    depths: Tuple[int, ...] = (3, 13, 30, 3)  # iresnet100
    channels: Tuple[int, ...] = (64, 128, 256, 512)
    emb_dim: int = 512
    input_size: int = 112
    bn_eps: float = 1e-5

    @classmethod
    def iresnet100(cls) -> "IResNetConfig":
        return cls()

    @classmethod
    def iresnet50(cls) -> "IResNetConfig":
        return cls(depths=(3, 4, 14, 3))

    @classmethod
    def tiny(cls, **kw) -> "IResNetConfig":
        d = dict(depths=(1, 1, 1, 1), channels=(8, 8, 16, 16), emb_dim=32, input_size=16)
        d.update(kw)
        return cls(**d)

    @property
    def grid(self) -> int:
        """Side of the last stage's feature map (each stage halves it)."""
        size = self.input_size
        for _ in self.depths:
            size = (size + 1) // 2
        return size


class BN(nn.Module):
    """Inference BatchNorm over dim 1 (running stats are parameters of the
    frozen recognizer): x * inv + (bias - mean * inv), inv = weight /
    sqrt(var + eps)."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.mean = nn.Parameter(torch.zeros(c))
        self.var = nn.Parameter(torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.weight * torch.rsqrt(self.var + self.eps)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return x * inv.view(shape) + (self.bias - self.mean * inv).view(shape)


class PReLU(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((c,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.alpha.view(1, -1, 1, 1) * x)


def _conv(cin: int, cout: int, k: int, stride: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class IBasicBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int, eps: float):
        super().__init__()
        self.bn1 = BN(in_ch, eps)
        self.conv1 = _conv(in_ch, out_ch, 3, 1)
        self.bn2 = BN(out_ch, eps)
        self.prelu = PReLU(out_ch)
        self.conv2 = _conv(out_ch, out_ch, 3, stride)
        self.bn3 = BN(out_ch, eps)
        self.has_downsample = stride != 1 or in_ch != out_ch
        if self.has_downsample:
            self.downsample_conv = _conv(in_ch, out_ch, 1, stride)
            self.downsample_bn = BN(out_ch, eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn3(self.conv2(self.prelu(self.bn2(self.conv1(self.bn1(x))))))
        if self.has_downsample:
            x = self.downsample_bn(self.downsample_conv(x))
        return y + x


class IResNet(nn.Module):
    def __init__(self, cfg: IResNetConfig = IResNetConfig()):
        super().__init__()
        self.cfg = c = cfg
        self.conv1 = _conv(3, c.channels[0], 3, 1)
        self.bn1 = BN(c.channels[0], c.bn_eps)
        self.prelu1 = PReLU(c.channels[0])
        in_ch = c.channels[0]
        for si, (depth, ch) in enumerate(zip(c.depths, c.channels)):
            for bi in range(depth):
                self.add_module(f"layer{si + 1}_{bi}",
                                IBasicBlock(in_ch, ch, 2 if bi == 0 else 1, c.bn_eps))
                in_ch = ch
        self.bn2 = BN(in_ch, c.bn_eps)
        self.fc = nn.Linear(in_ch * c.grid * c.grid, c.emb_dim)
        self.features = BN(c.emb_dim, c.bn_eps)

    def blocks(self):
        for si, depth in enumerate(self.cfg.depths):
            for bi in range(depth):
                yield getattr(self, f"layer{si + 1}_{bi}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, 3, S, S] ArcFace-normalized NCHW -> [B, emb_dim]."""
        x = self.prelu1(self.bn1(self.conv1(x.to(self.conv1.weight.dtype))))
        for blk in self.blocks():
            x = blk(x)
        x = self.bn2(x)
        return self.features(self.fc(x.flatten(1)))


def init_iresnet_(model: IResNet, generator: torch.Generator) -> IResNet:
    """A random recognizer from `generator`: identity BatchNorms, PReLU
    slopes 0.25, conv and fc weights normal with std 1/sqrt(fan_in), fc
    bias 0 (the distributions of flax's initializers)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator,
                                           device=m.weight.device) / fan_in ** 0.5)
                if m.bias is not None:
                    m.bias.zero_()
    return model


def preprocess_faces(images: torch.Tensor, size: int = 112) -> torch.Tensor:
    """[B, H, W, 3] uint8 or float RGB -> ArcFace-normalized NCHW fp32
    [B, 3, S, S]: `jax.image.resize`'s bilinear (antialiased when it
    shrinks) where the size differs, then (x - 127.5) / 127.5."""
    x = torch.as_tensor(images).float().permute(0, 3, 1, 2)
    if x.shape[2] != size or x.shape[3] != size:
        x = resize_aa(x, size, size)
    return (x - 127.5) / 127.5


def map_arcface_onnx_params(weights: Dict[str, np.ndarray], nodes: Sequence[dict],
                            cfg: IResNetConfig = IResNetConfig()) -> Dict[str, torch.Tensor]:
    """ONNX initializers and node list (`load_onnx_weights(with_graph=True)`)
    -> the `IResNet` state dict. Conv / BatchNormalization / PRelu nodes are
    taken in graph order, which in insightface exports is the forward order
    above; conv weights are OIHW in both; the Gemm weight [out, in] is the
    fc weight as it is, its inputs in the export's C, H, W order."""
    convs = iter([n for n in nodes if n["op_type"] == "Conv"])
    bns = iter([n for n in nodes if n["op_type"] == "BatchNormalization"])
    prelus = iter([n for n in nodes if n["op_type"] == "PRelu"])
    gemms = [n for n in nodes if n["op_type"] == "Gemm"]
    t = lambda a: torch.from_numpy(np.array(a, np.float32))
    sd: Dict[str, torch.Tensor] = {}

    def conv(name):
        sd[f"{name}.weight"] = t(weights[next(convs)["input"][1]])

    def bn(name):
        n = next(bns)
        for k, leaf in zip((1, 2, 3, 4), ("weight", "bias", "mean", "var")):
            sd[f"{name}.{leaf}"] = t(weights[n["input"][k]])

    def prelu(name):
        sd[f"{name}.alpha"] = t(weights[next(prelus)["input"][1]].reshape(-1))

    conv("conv1")
    bn("bn1")
    prelu("prelu1")
    for si, depth in enumerate(cfg.depths):
        for bi in range(depth):
            p = f"layer{si + 1}_{bi}"
            bn(f"{p}.bn1")
            conv(f"{p}.conv1")
            bn(f"{p}.bn2")
            prelu(f"{p}.prelu")
            conv(f"{p}.conv2")
            bn(f"{p}.bn3")
            if bi == 0:  # the stride-2 first block always has a downsample
                conv(f"{p}.downsample_conv")
                bn(f"{p}.downsample_bn")
    bn("bn2")
    g = gemms[0]
    w = t(weights[g["input"][1]])
    sd["fc.weight"] = w
    sd["fc.bias"] = (t(weights[g["input"][2]]) if len(g["input"]) > 2
                     else torch.zeros(w.shape[0]))
    bn("features")
    return sd


# ------------------------------------------------------------------ align

# insightface `arcface_dst`: the canonical 5-point template of a 112x112 crop
ARCFACE_DST = np.array(
    [[38.2946, 51.6963], [73.5318, 51.5014], [56.0252, 71.7366],
     [41.5493, 92.3655], [70.7299, 92.2041]], dtype=np.float32)


def estimate_norm(landmarks: np.ndarray, size: int = 112) -> np.ndarray:
    """Umeyama similarity transform from 5 detected landmarks to the ArcFace
    template scaled to `size` (insightface `face_align.estimate_norm`): a
    2x3 float32 affine matrix."""
    src = np.asarray(landmarks, np.float32)
    dst = ARCFACE_DST * (size / 112.0)
    src_mean = src.mean(0)
    dst_mean = dst.mean(0)
    src_c = src - src_mean
    dst_c = dst - dst_mean
    cov = dst_c.T @ src_c / src.shape[0]
    u, s, vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(u @ vt))
    diag = np.diag([1.0, d])
    var_src = (src_c ** 2).sum() / src.shape[0]
    scale = np.trace(np.diag(s) @ diag) / var_src
    R = u @ diag @ vt
    M = np.zeros((2, 3), np.float32)
    M[:2, :2] = scale * R
    M[:, 2] = dst_mean - scale * R @ src_mean
    return M


def warp_affine(image: np.ndarray, M: np.ndarray, size: int = 112) -> np.ndarray:
    """Host bilinear affine crop with a zero border (`cv2.warpAffine`'s
    INTER_LINEAR, borderValue 0); integer images round back to their dtype."""
    A = np.vstack([M, [0, 0, 1]]).astype(np.float32)
    Ainv = np.linalg.inv(A)
    ys, xs = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    ones = np.ones_like(xs)
    pts = np.stack([xs, ys, ones], axis=-1).reshape(-1, 3).astype(np.float32)
    pts = pts @ Ainv.T
    sx, sy = pts[:, 0], pts[:, 1]
    h, w = image.shape[:2]
    img = image.astype(np.float32)
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    fx = (sx - x0)[:, None]
    fy = (sy - y0)[:, None]

    def tap(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        vals = img[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)]
        return np.where(valid[:, None], vals, 0.0)

    top = tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx
    bot = tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx
    out = (top * (1 - fy) + bot * fy).reshape(size, size, -1)
    if np.issubdtype(image.dtype, np.integer):
        info = np.iinfo(image.dtype)
        out = np.clip(np.rint(out), info.min, info.max).astype(image.dtype)
    return out


def warp_affine_torch(image: torch.Tensor, Ms: torch.Tensor, size: int = 112) -> torch.Tensor:
    """Batched bilinear affine crops with a zero border, on the image's
    device. image [H, W, C] integer or float; Ms [N, 2, 3] forward
    (source -> crop) transforms from `estimate_norm`. Returns [N, size, size,
    C] fp32; integer images round back half to even, as `jnp.round` does,
    then clip to the dtype's range (the values stay fp32)."""
    h, w = image.shape[0], image.shape[1]
    dev = image.device
    img = image.float().reshape(h * w, -1)
    Ms = torch.as_tensor(Ms, dtype=torch.float32, device=dev)
    a, b_, tx = Ms[:, 0, 0], Ms[:, 0, 1], Ms[:, 0, 2]
    c_, d_, ty = Ms[:, 1, 0], Ms[:, 1, 1], Ms[:, 1, 2]
    det = a * d_ - b_ * c_
    r = torch.arange(size, dtype=torch.float32, device=dev)
    ys, xs = torch.meshgrid(r, r, indexing="ij")
    dx = xs.reshape(-1)[None, :] - tx[:, None]  # [N, P]
    dy = ys.reshape(-1)[None, :] - ty[:, None]
    sx = (d_[:, None] * dx - b_[:, None] * dy) / det[:, None]
    sy = (-c_[:, None] * dx + a[:, None] * dy) / det[:, None]
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]

    def tap(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
        return torch.where(valid[..., None], img[idx], 0.0)

    top = tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx
    bot = tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx
    out = top * (1 - fy) + bot * fy
    if not image.dtype.is_floating_point:
        info = torch.iinfo(image.dtype)
        out = torch.clamp(torch.round(out), info.min, info.max)
    return out.reshape(Ms.shape[0], size, size, -1)
