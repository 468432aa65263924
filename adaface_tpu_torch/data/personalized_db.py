"""DreamBooth datasets: subject images and class regularization images (the
port's own copy of `adaface_tpu/data/personalized_db.py`).

Two plain image folders: the subject's photos, captioned "a photo of a
<placeholder> <class>", and pre-generated class images, captioned "a photo
of a <class>", drawn as (train, reg) pairs. The draws from the dataset's
numpy RNG are the JAX dataset's, in its order: the subject index, the reg
index, then a flip for each image. PNGs load through `data/png.py`, JPEGs
through `data/jpeg.py`, other formats through PIL.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from adaface_tpu_torch.data.personalized import IMG_EXTS, _nearest_resize
from adaface_tpu_torch.data.png import load_image


class DreamBoothDataset:
    def __init__(self, subject_folder: str, reg_folder: str, placeholder: str = "z",
                 class_word: str = "person", size: int = 512, flip_p: float = 0.5,
                 seed: Optional[int] = None):
        self.size = size
        self.flip_p = flip_p
        self.rng = np.random.default_rng(seed)
        scan = lambda d: [os.path.join(d, f) for f in sorted(os.listdir(d))
                          if f.lower().endswith(IMG_EXTS)
                          and not f.lower().endswith("_mask.png")]
        self.subject_paths = scan(subject_folder)
        self.reg_paths = scan(reg_folder)
        self.train_caption = f"a photo of a {placeholder} {class_word}"
        self.reg_caption = f"a photo of a {class_word}"

    def _load(self, path: str) -> np.ndarray:
        img = _nearest_resize(load_image(path, "RGB"), self.size)
        if self.rng.random() < self.flip_p:
            img = img[:, ::-1]
        return (img / 127.5 - 1.0).astype(np.float32)

    def draw_pair(self) -> Tuple[Dict, Dict]:
        """One (train example, reg example) pair."""
        sp = self.subject_paths[int(self.rng.integers(len(self.subject_paths)))]
        rp = self.reg_paths[int(self.rng.integers(len(self.reg_paths)))]
        return ({"image": self._load(sp), "caption": self.train_caption},
                {"image": self._load(rp), "caption": self.reg_caption})
