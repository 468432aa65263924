"""Host-side compositional x_start initialization (the port's numpy copy of
`adaface_tpu/training/x_init.py`): a fresh compositional-distillation
iteration starts from the training image's foreground scaled down onto a
noise background, with an annealed share of the foreground replaced by
noise. Numpy on the host, before the batch goes to the card, drawing from
the trainer's RNG in the JAX package's order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from adaface_tpu_torch.training.iter_plan import anneal_value


def rand_annealed(rng: np.random.Generator, training_percent: float, final_percent: float,
                  mean_range: Tuple[float, float],
                  fluct_range: Tuple[float, float] = (0.8, 1.2),
                  legal_range: Tuple[float, float] = (0.0, 1.0)) -> float:
    """A uniform draw around an annealed mean, clipped to `legal_range`."""
    mean = anneal_value(training_percent, final_percent, mean_range)
    lb = max(mean * fluct_range[0], legal_range[0])
    ub = min(mean * fluct_range[1], legal_range[1])
    return float(rng.uniform(lb, ub))


def _resize_bilinear_nhwc(x: np.ndarray, oh: int, ow: int,
                          scale: Optional[float] = None) -> np.ndarray:
    """[B, H, W, C] -> [B, oh, ow, C] bilinear with torch F.interpolate
    (align_corners=False) semantics: src = (dst + 0.5) * in/out - 0.5,
    clamped. With `scale` (a resize by scale factor), the coordinates map
    by the exact factor, not the realized oh/h ratio, as torch does."""
    b, h, w, c = x.shape
    inv_h = (1.0 / scale) if scale else (h / oh)
    inv_w = (1.0 / scale) if scale else (w / ow)
    ys = np.clip((np.arange(oh) + 0.5) * inv_h - 0.5, 0, h - 1)
    xs = np.clip((np.arange(ow) + 0.5) * inv_w - 0.5, 0, w - 1)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0).astype(x.dtype)[None, :, None, None]
    wx = (xs - x0).astype(x.dtype)[None, None, :, None]
    top = x[:, y0][:, :, x0] * (1 - wx) + x[:, y0][:, :, x1] * wx
    bot = x[:, y1][:, :, x0] * (1 - wx) + x[:, y1][:, :, x1] * wx
    return top * (1 - wy) + bot * wy


def init_x_with_fg_from_training_image(
        rng: np.random.Generator, x_start: np.ndarray, fg_mask: np.ndarray,
        training_percent: float, base_scale_range: Tuple[float, float] = (0.7, 1.0),
        fg_noise_anneal_mean_range: Tuple[float, float] = (0.1, 0.4)
) -> Tuple[np.ndarray, np.ndarray]:
    """Fg-initialized compositional x_start from [B, h, w, 4] latents and
    their [B, h, w, 1] fg mask (zeroed for instances without a real mask):

    1. the background becomes unit gaussian noise;
    2. the fg content and its mask are bilinearly scaled down by a random
       factor, more when the fg covers over 10% of the image
       ((0.1 / share)^0.35 more), and centered on a zero canvas;
    3. any nonzero pixel of the scaled mask is foreground; an annealed
       share of the content (mean 0.1 -> 0.4 over training) is noise.

    Returns (x_start, scaled fg mask), numpy fp32."""
    x_start = np.asarray(x_start, np.float32)
    fgm = (np.asarray(fg_mask, np.float32) > 1e-6).astype(np.float32)
    b, h, w, _ = x_start.shape
    x_orig = np.where(fgm > 0, x_start, rng.standard_normal(x_start.shape).astype(np.float32))
    fg_pct = float(fgm.sum()) / fgm.size
    lb, ub = base_scale_range
    if fg_pct > 0.1:
        extra = (0.1 / fg_pct) ** 0.35
        scale = rng.uniform(lb * extra, max(0.5, ub * extra))
    else:
        scale = rng.uniform(lb, ub)
    sh, sw = max(int(h * scale), 1), max(int(w * scale), 1)
    packed = np.concatenate([x_orig, fgm], axis=-1)
    scaled = _resize_bilinear_nhwc(packed, sh, sw, scale=scale)
    ph1, pw1 = (h - sh) // 2, (w - sw) // 2
    padded = np.zeros((b, h, w, packed.shape[-1]), np.float32)
    padded[:, ph1:ph1 + sh, pw1:pw1 + sw] = scaled
    x_scaled, fgm_scaled = padded[..., :4], (padded[..., 4:] > 0).astype(np.float32)
    x_new = np.where(fgm_scaled > 0, x_scaled,
                     rng.standard_normal(x_start.shape).astype(np.float32))
    amt = rand_annealed(rng, training_percent, 1.0, fg_noise_anneal_mean_range)
    x_new = (rng.standard_normal(x_start.shape).astype(np.float32) * amt
             + x_new * (1.0 - amt))
    return x_new, fgm_scaled
