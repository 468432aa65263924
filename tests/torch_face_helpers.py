"""Shared fixtures of the face-tool parity tests (`test_torch_detectors.py`,
`test_torch_bisenet.py`, `test_torch_face_tools.py`): seeded port modules
moved off flax's identity initial values, their flax trees for the JAX
modules, a synthetic biubug6 `mobilenet0.25_Final.pth` and a synthetic
face-parsing `79999_iter.pth`, and PNG folders."""

import os

import numpy as np
import torch
import torch.nn as nn

from adaface_tpu_torch.data import png
from adaface_tpu_torch.models.arcface import BN

from test_bisenet import synth_state_dict


def perturb_(module: nn.Module, seed: int, bias_std: float = 0.1) -> nn.Module:
    """Normalization statistics and affines and conv biases drawn from
    `seed` (means and shifts N(0, 0.1), variances U(0.5, 1.5), scales
    U(0.8, 1.2)), so that no layer is the identity flax initializes."""
    g = torch.Generator().manual_seed(seed)
    u = lambda t, lo, hi: t.copy_(lo + (hi - lo) * torch.rand(t.shape, generator=g))
    n = lambda t, s: t.copy_(s * torch.randn(t.shape, generator=g))
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.BatchNorm2d, BN)):
                mean, var = ((m.running_mean, m.running_var) if isinstance(m, nn.BatchNorm2d)
                             else (m.mean, m.var))
                n(mean, 0.1), u(var, 0.5, 1.5), u(m.weight, 0.8, 1.2), n(m.bias, 0.1)
            elif isinstance(m, nn.GroupNorm):
                u(m.weight, 0.8, 1.2), n(m.bias, 0.1)
            elif isinstance(m, nn.Conv2d) and m.bias is not None:
                n(m.bias, bias_std)
    return module.eval()


def flax_tree(module: nn.Module):
    """(params, batch_stats) of a port module in the flax layout: conv
    `kernel` HWIO and `bias`; BatchNorm / GroupNorm `scale` and `bias`;
    BatchNorm2d's running statistics as `batch_stats` `mean` / `var`, the
    recognizer-style `BN`'s as parameters."""
    params, stats = {}, {}

    def node(tree, name):
        for part in name.split(".") if name else ():
            tree = tree.setdefault(part, {})
        return tree

    a = lambda t: np.ascontiguousarray(t.detach().float().numpy())
    for name, m in module.named_modules():
        if isinstance(m, nn.Conv2d):
            d = node(params, name)
            d["kernel"] = a(m.weight.permute(2, 3, 1, 0))
            if m.bias is not None:
                d["bias"] = a(m.bias)
        elif isinstance(m, (nn.BatchNorm2d, nn.GroupNorm, BN)):
            d = node(params, name)
            d["scale"], d["bias"] = a(m.weight), a(m.bias)
            if isinstance(m, nn.BatchNorm2d):
                s = node(stats, name)
                s["mean"], s["var"] = a(m.running_mean), a(m.running_var)
            elif isinstance(m, BN):
                d["mean"], d["var"] = a(m.mean), a(m.var)
    return params, stats


def rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


BIUBUG6_BLOCKS = ([("body.stage1.0", 3, 8, "conv_bn")]
                  + [(f"body.stage1.{i}", ci, co, "dw") for i, (ci, co) in
                     enumerate([(8, 16), (16, 32), (32, 32), (32, 64), (64, 64)], 1)]
                  + [("body.stage2.0", 64, 128, "dw")]
                  + [(f"body.stage2.{i}", 128, 128, "dw") for i in range(1, 6)]
                  + [("body.stage3.0", 128, 256, "dw"), ("body.stage3.1", 256, 256, "dw")])


def biubug6_state_dict(seed: int, cls_bias=(0.0, 0.0)) -> dict:
    """A synthetic `mobilenet0.25_Final.pth` state dict (biubug6 names,
    torch layouts, num_batches_tracked included). `cls_bias` is added to
    the class heads' (background, face) logits of both anchors."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(name, cout, cin, k, std=None):
        std = std or (1.0 / (cin * k * k)) ** 0.5
        sd[name + ".weight"] = torch.tensor(rng.standard_normal((cout, cin, k, k)) * std,
                                            dtype=torch.float32)

    def bn(name, c):
        sd[name + ".weight"] = torch.tensor(rng.uniform(0.8, 1.2, c), dtype=torch.float32)
        sd[name + ".bias"] = torch.tensor(rng.normal(0, 0.1, c), dtype=torch.float32)
        sd[name + ".running_mean"] = torch.tensor(rng.normal(0, 0.1, c), dtype=torch.float32)
        sd[name + ".running_var"] = torch.tensor(rng.uniform(0.5, 1.5, c), dtype=torch.float32)
        sd[name + ".num_batches_tracked"] = torch.tensor(1000)

    for name, ci, co, kind in BIUBUG6_BLOCKS:
        if kind == "conv_bn":
            conv(name + ".0", co, ci, 3), bn(name + ".1", co)
        else:
            conv(name + ".0", ci, 1, 3), bn(name + ".1", ci)
            conv(name + ".3", co, ci, 1), bn(name + ".4", co)
    for name, ci in (("output1", 64), ("output2", 128), ("output3", 256)):
        conv(f"fpn.{name}.0", 64, ci, 1), bn(f"fpn.{name}.1", 64)
    for name in ("merge1", "merge2"):
        conv(f"fpn.{name}.0", 64, 64, 3), bn(f"fpn.{name}.1", 64)
    for i in range(1, 4):
        for br, co, ci in (("conv3X3", 32, 64), ("conv5X5_1", 16, 64), ("conv5X5_2", 16, 16),
                           ("conv7X7_2", 16, 16), ("conv7x7_3", 16, 16)):
            conv(f"ssh{i}.{br}.0", co, ci, 3), bn(f"ssh{i}.{br}.1", co)
    for i in range(3):
        for head, n in (("ClassHead", 4), ("BboxHead", 8), ("LandmarkHead", 20)):
            conv(f"{head}.{i}.conv1x1", n, 64, 1)
            b = rng.normal(0, 0.1, n)
            if head == "ClassHead":
                b += np.tile(cls_bias, 2)
            sd[f"{head}.{i}.conv1x1.bias"] = torch.tensor(b, dtype=torch.float32)
    return sd


def face_parsing_state_dict(seed: int, class_bias=None) -> dict:
    """`test_bisenet.synth_state_dict` as torch tensors; `class_bias` [19]
    is added to the main classifier's bias."""
    sd = {k: torch.tensor(v) for k, v in synth_state_dict(seed).items()}
    sd["conv_out.conv_out.bias"] = torch.tensor(
        np.zeros(19) if class_bias is None else np.asarray(class_bias), dtype=torch.float32)
    return sd


def write_pngs(folder, shapes, seed, dark=()):
    """One seeded RGB PNG of each (h, w) in `shapes` as `<i>.png`; indices
    in `dark` hold pixel values below 16."""
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i, (h, w) in enumerate(shapes):
        img = rng.integers(0, 16 if i in dark else 256, (h, w, 3), dtype=np.uint8)
        # a smooth bright blob over the noise, so that images differ in layout
        yy, xx = np.mgrid[0:h, 0:w]
        cy, cx = rng.uniform(0.3, 0.7) * h, rng.uniform(0.3, 0.7) * w
        blob = np.exp(-(((yy - cy) / (0.25 * h)) ** 2 + ((xx - cx) / (0.2 * w)) ** 2))
        if i not in dark:
            img = np.clip(img * 0.4 + 150 * blob[..., None], 0, 255).astype(np.uint8)
        png.write(os.path.join(folder, f"{i}.png"), img)
    return folder


def write_blocky_pngs(folder, shapes, seed):
    """One seeded RGB PNG of each (h, w) in `shapes` as `<i>.png`: a 4x4
    grid of random colours, which a 16-pixel recognizer still tells apart."""
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i, (h, w) in enumerate(shapes):
        cells = rng.integers(0, 256, (4, 4, 3))
        img = cells[np.arange(h) * 4 // h][:, np.arange(w) * 4 // w].astype(np.uint8)
        png.write(os.path.join(folder, f"{i}.png"), img)
    return folder
