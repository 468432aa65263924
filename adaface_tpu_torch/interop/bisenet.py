"""BiSeNet face-parsing checkpoint import, BatchNorm folded (counterpart of
`adaface_tpu/interop/bisenet.py`).

Maps the face-parsing.PyTorch `79999_iter.pth` state dict onto
`models/bisenet.BiSeNet`. Every BatchNorm folds into the conv before it, in
numpy fp32 with eps 1e-5, as the JAX package folds it, so the port's weights
are JAX's bit for bit:

    scale = gamma / sqrt(running_var + eps)
    weight' = weight * scale   (output-channel axis)
    bias'   = (bias - running_mean) * scale + beta

The training-only aux heads (`conv_out16`, `conv_out32`) are consumed and
dropped; with `strict` a key left unread (other than `num_batches_tracked`)
raises. `load_bisenet` reads the .pth through the restricted unpickler
(`interop/torch_pickle.py`).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from adaface_tpu_torch.models.bisenet import BiSeNet

BN_EPS = 1e-5


class _Tracker(dict):
    """A dict that records the keys read (and the keys found by `in`)."""

    def __init__(self, d):
        super().__init__(d)
        self.read = set()

    def __getitem__(self, k):
        self.read.add(k)
        return super().__getitem__(k)

    def __contains__(self, k):
        has = super().__contains__(k)
        if has:
            self.read.add(k)
        return has


def _fold(flat: Mapping, conv_key: str, bn_key) -> Dict[str, np.ndarray]:
    """{"weight" OIHW, "bias"} of a conv with its BatchNorm folded in."""
    w = np.asarray(flat[conv_key + ".weight"], np.float32)
    b = (np.asarray(flat[conv_key + ".bias"], np.float32) if conv_key + ".bias" in flat
         else np.zeros(w.shape[0], np.float32))
    if bn_key is None:
        return {"weight": w, "bias": b}
    gamma = np.asarray(flat[bn_key + ".weight"], np.float32)
    beta = np.asarray(flat[bn_key + ".bias"], np.float32)
    mean = np.asarray(flat[bn_key + ".running_mean"], np.float32)
    var = np.asarray(flat[bn_key + ".running_var"], np.float32)
    scale = gamma / np.sqrt(var + BN_EPS)
    return {"weight": w * scale[:, None, None, None], "bias": (b - mean) * scale + beta}


def map_bisenet_params(sd: Mapping, strict: bool = True) -> Dict[str, torch.Tensor]:
    """A face-parsing state dict -> `BiSeNet`'s state dict (BN folded)."""
    flat = _Tracker({k: np.asarray(v) for k, v in sd.items()})
    out: Dict[str, torch.Tensor] = {}

    def put(ours, folded):
        for k, a in folded.items():
            out[f"{ours}.{k}"] = torch.from_numpy(np.ascontiguousarray(a))

    def cbr(ours, prefix):  # a ConvBNReLU module
        put(ours, _fold(flat, prefix + ".conv", prefix + ".bn"))

    put("resnet.conv1", _fold(flat, "cp.resnet.conv1", "cp.resnet.bn1"))
    for layer in (1, 2, 3, 4):
        for blk in (0, 1):
            pre, ours = f"cp.resnet.layer{layer}.{blk}", f"resnet.layer{layer}_{blk}"
            put(ours + ".conv1", _fold(flat, pre + ".conv1", pre + ".bn1"))
            put(ours + ".conv2", _fold(flat, pre + ".conv2", pre + ".bn2"))
            if pre + ".downsample.0.weight" in flat:
                put(ours + ".downsample", _fold(flat, pre + ".downsample.0",
                                                pre + ".downsample.1"))
    for arm in ("arm16", "arm32"):
        cbr(f"{arm}.conv", f"cp.{arm}.conv")
        put(f"{arm}.conv_atten", _fold(flat, f"cp.{arm}.conv_atten", f"cp.{arm}.bn_atten"))
    for name in ("conv_avg", "conv_head16", "conv_head32"):
        cbr(name, f"cp.{name}")
    cbr("ffm.convblk", "ffm.convblk")
    put("ffm.conv1", _fold(flat, "ffm.conv1", None))
    put("ffm.conv2", _fold(flat, "ffm.conv2", None))
    cbr("conv_out.conv", "conv_out.conv")
    put("conv_out.conv_out", _fold(flat, "conv_out.conv_out", None))
    # the training-only aux heads: consumed, dropped
    for aux in ("conv_out16", "conv_out32"):
        if aux + ".conv.conv.weight" in flat:
            _fold(flat, aux + ".conv.conv", aux + ".conv.bn")
            _fold(flat, aux + ".conv_out", None)
    if strict:
        left = {k for k in flat if k not in flat.read and "num_batches_tracked" not in k}
        if left:
            raise ValueError(f"bisenet import: {len(left)} unconsumed keys, e.g. "
                             f"{sorted(left)[:8]}")
    return out


def load_bisenet(path: str, device=None) -> BiSeNet:
    """A face-parsing .pth -> `BiSeNet` with its weights, eval mode, on
    `device` (the CPU by default)."""
    from adaface_tpu_torch.interop.torch_pickle import load_torch_checkpoint

    sd = load_torch_checkpoint(path)
    sd = sd.get("state_dict", sd) if isinstance(sd, dict) else sd
    model = BiSeNet()
    model.load_state_dict(map_bisenet_params({k: np.asarray(v) for k, v in sd.items()}),
                          strict=True)
    return model.to(device).eval()
