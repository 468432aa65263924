"""Training-time sample grids (the port's copy of
`adaface_tpu/training/image_logger.py`): every N steps render inputs or
samples of the current subject prompts and write a grid under
`<logdir>/images/`. Distillation candidates can be marked with border
colors (teachable, unteachable, best candidate).

Grids are PNG files written with the port's own codec (`data/png.py`): the
JAX logger writes `<stem>.jpg` through PIL, the port `<stem>.png`.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from adaface_tpu_torch.data import png

# border colors: 0 none, 1 red (unteachable), 2 green (teachable), 3 purple
# (best candidate)
BORDER_COLORS = {0: None, 1: (255, 0, 0), 2: (0, 200, 0), 3: (160, 32, 240)}


def add_border(img: np.ndarray, color, width: int = 4) -> np.ndarray:
    if color is None:
        return img
    out = img.copy()
    out[:width] = color
    out[-width:] = color
    out[:, :width] = color
    out[:, -width:] = color
    return out


def make_grid(images: Sequence[np.ndarray], ncol: int = 4,
              colors: Optional[Sequence[int]] = None) -> np.ndarray:
    """[N] of [H, W, 3] u8 -> grid u8, row-major, zero-padded tail."""
    images = list(images)
    if colors is not None:
        images = [add_border(im, BORDER_COLORS.get(c)) for im, c in zip(images, colors)]
    h, w = images[0].shape[:2]
    nrow = (len(images) + ncol - 1) // ncol
    grid = np.zeros((nrow * h, ncol * w, 3), np.uint8)
    for i, im in enumerate(images):
        r, c = divmod(i, ncol)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = im
    return grid


class ImageLogger:
    def __init__(self, logdir: str, every_steps: int = 500, num_samples: int = 4,
                 sample_steps: int = 20, size: int = 512):
        self.dir = os.path.join(logdir, "images")
        os.makedirs(self.dir, exist_ok=True)
        self.every_steps = every_steps
        self.num_samples = num_samples
        self.sample_steps = sample_steps
        self.size = size

    def should_log(self, global_step: int) -> bool:
        return self.every_steps > 0 and global_step % self.every_steps == 0

    def log_inputs(self, global_step: int, images_u8: np.ndarray) -> str:
        return self._save(f"inputs_gs-{global_step:06}.png", make_grid(list(images_u8)))

    def log_samples(self, global_step: int, pipeline, prompt: str, seed: int = 0,
                    tag: str = "samples"):
        """`num_samples` images of `prompt` from `pipeline.generate`
        (`sample_steps` DDIM steps), saved as one grid; returns them."""
        imgs = pipeline.generate([prompt] * self.num_samples, num_steps=self.sample_steps,
                                 height=self.size, width=self.size, seed=seed)
        self._save(f"{tag}_gs-{global_step:06}.png", make_grid(list(imgs)))
        return imgs

    def log_candidates(self, global_step: int, images_u8: np.ndarray,
                       colors: Sequence[int]) -> str:
        """Teacher-filter candidate grid with verdict borders."""
        return self._save(f"candidates_gs-{global_step:06}.png",
                          make_grid(list(images_u8), colors=colors))

    def _save(self, name: str, grid: np.ndarray) -> str:
        path = os.path.join(self.dir, name)
        png.write(path, grid)
        return path
