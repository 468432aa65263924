"""Nearest-2x upsample followed by a 3x3 'SAME' conv, NHWC in and out.

`upsample2x_conv` is `adaface_tpu/ops/subpixel.py:upsample2x_conv`, the
function JAX's UNet and VAE `Upsample` compute by default
(`ADAFACE_SUBPIXEL_UP` unset): for output phase (di, dj) the three taps
along each axis fall on two source pixels, so the 3x3 kernel folds into four
2x2 phase kernels

  rows(d=0) = (W[0], W[1]+W[2])        rows(d=1) = (W[0]+W[1], W[2])

(rows first, then the same along the columns), summed in the weight's
dtype: in bf16 the folded taps are rounded to bf16, which is why this is not
the naive function in bf16. JAX runs each phase as a 2x2 conv of the
original tensor with asymmetric padding and interleaves the phases; here the
four 2x2 kernels sit in zero-framed 3x3 kernels at their offsets, stacked
phase by phase as 4 C' output channels, so one 3x3 conv of the original
tensor gives the same sums (the zero taps add nothing) in one conv launch,
with no upsampled tensor in memory; one copy interleaves the phases. The bias is added after, in the output
dtype, as JAX adds it. Where the weight takes no gradient (frozen, or no
grad mode), its folded kernels are kept between calls until the weight
changes (`_folded`): folding a C1280 weight costs more than the conv at 8x8.

`nearest_upsample2x_conv_reference` is the naive composition (nearest
upsample, then the 3x3 conv with its bias), what JAX computes under
`ADAFACE_SUBPIXEL_UP=0`; `upsample_conv` picks one by that knob, read at
call time. The weight is a torch conv weight [C', C, 3, 3].
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from adaface_tpu_torch import knobs


def _phase_taps(w: torch.Tensor, d: int, axis: int) -> torch.Tensor:
    """The two taps of phase d along `axis` (2: rows, 3: columns) of a
    [C', C, kh, kw] weight: (W0, W1 + W2) for d = 0, (W0 + W1, W2) for d = 1."""
    w0, w1, w2 = w.unbind(axis)
    return torch.stack((w0, w1 + w2) if d == 0 else (w0 + w1, w2), dim=axis)


def phase_kernels(weight: torch.Tensor) -> torch.Tensor:
    """[C', C, 3, 3] -> [4 C', C, 3, 3]: the folded 2x2 kernels of phases
    (di, dj) = (0, 0), (0, 1), (1, 0), (1, 1), C' output channels each, each
    zero-framed in 3x3 at rows di..di+1 and columns dj..dj+1, summed in the
    weight's dtype."""
    rows = [_phase_taps(weight, di, 2) for di in (0, 1)]
    # F.pad's order: left, right, top, bottom
    return torch.cat([F.pad(_phase_taps(rows[di], dj, 3), (dj, 1 - dj, di, 1 - di))
                      for di in (0, 1) for dj in (0, 1)])


def _folded(weight: torch.Tensor) -> torch.Tensor:
    """`phase_kernels(weight)`, kept on the weight (as (version counter,
    data pointer, kernels)) while it is unchanged where no gradient flows to
    it; made outside inference mode, so that a kernel folded while serving
    can be saved for a training step's backward. Channels-last like the
    weight where it is (the card's models), so the conv takes it as is. A
    weight made in inference mode has no version counter: folded each call."""
    if weight.is_inference() or (torch.is_grad_enabled() and weight.requires_grad):
        return phase_kernels(weight)
    key = (weight._version, weight.data_ptr())
    hit = getattr(weight, "_phase_kernels", None)
    if hit is None or hit[:2] != key:
        with torch.inference_mode(False), torch.no_grad():
            k = phase_kernels(weight)
            if not weight.is_contiguous() and weight.is_contiguous(
                    memory_format=torch.channels_last):
                k = k.contiguous(memory_format=torch.channels_last)
            hit = key + (k,)
        weight._phase_kernels = hit
    return hit[2]


def upsample2x_conv(x: torch.Tensor, weight: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """JAX's phase-folded nearest-2x upsample + 3x3 conv of NHWC `x`: the
    taps folded in the weight's dtype (the module's, as JAX casts the kernel
    to the compute dtype before folding), the conv in x's dtype."""
    b, h, w, _ = x.shape
    k = _folded(weight).to(x.dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), k, padding=1).permute(0, 2, 3, 1)
    # [B, H, W, (di, dj, C')] -> [B, (H, di), (W, dj), C']
    y = y.unflatten(3, (2, 2, -1)).permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, -1)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def nearest_upsample2x_conv_reference(x: torch.Tensor, weight: torch.Tensor,
                                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The naive path (JAX's under `ADAFACE_SUBPIXEL_UP=0`): nearest 2x, then
    the 3x3 'SAME' conv with its bias."""
    up = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
    return F.conv2d(up, weight, bias, padding=1).permute(0, 2, 3, 1)


def upsample_conv(x: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The UNet's and the VAE's `Upsample`: the naive path under
    `ADAFACE_SUBPIXEL_UP=0`, else the phase fold (JAX's dispatch)."""
    if knobs.get("ADAFACE_SUBPIXEL_UP") == "0":
        return nearest_upsample2x_conv_reference(x, weight, bias)
    return upsample2x_conv(x, weight, bias)
