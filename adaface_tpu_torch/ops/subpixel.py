"""Nearest-2x upsample followed by a 3x3 'SAME' conv, NHWC in and out.

Counterpart of `adaface_tpu/ops/subpixel.py:upsample2x_conv`, which folds the
same function into four 2x2 phase convolutions for the TPU. Here it is the
plain composition, as its `nearest_upsample2x_conv_reference` spells it out;
the weight is a torch conv weight [C', C, 3, 3].
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def upsample2x_conv(x: torch.Tensor, weight: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    up = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
    return F.conv2d(up, weight, bias, padding=1).permute(0, 2, 3, 1)
