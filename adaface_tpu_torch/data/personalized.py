"""Subject-image dataset with fg masks, augmentation and delta prompts (the
port's own copy of `adaface_tpu/data/personalized.py`, numpy only, the same
behavior and the same order of draws from the dataset's numpy RNG):

- folder scan: per-subject subfolders, `*_mask.png` fg-mask pairing,
  `.txt` caption files, `metainfo.json` person_type cache;
- loading: RGB (PIL, imported when an image is read), NEAREST resize with
  the mask stacked as a 4th channel so one resample moves both;
- augmentation: random horizontal flip, random uniform scale in
  [0.7, 1.0] about the center (zero-padded), then a random roll within the
  empty margins (margin 12) producing `aug_mask`;
- prompts: a Textual-Inversion template + the 4-type delta prompts
  (subj/cls x single/comp) with bg-suffix and "face portrait" (fp)
  variants, multi-vector ", " padding;
- `SubjectSampler`: weighted random subject choice (weight proportional to
  image count, optional skip-non-faces).

The C++ prefetching loader (`native_stream`) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

from adaface_tpu_torch.data.compositions import sample_compositions

# Standard Textual-Inversion prompt templates (Gal et al.); the reference
# triples them with rendering/illustration/depiction variants (`:24-107`).
_SUBJECTS = ["photo of a {}", "rendering of a {}", "illustration of a {}",
             "depiction of a {}"]
_FLAVORS = ["a {}", "a cropped {}", "the {}", "a close-up {}", "a bright {}",
            "a dark {}", "a good {}"]
_ADJS = ["{}", "clean {}", "dirty {}", "cool {}", "nice {}", "small {}",
         "large {}", "weird {}", "my {}", "one {}"]

IMAGENET_TEMPLATES_SMALL = sorted({
    flavor.format(subj.format(adj.format("{}")))
    for subj in _SUBJECTS for flavor in _FLAVORS for adj in _ADJS
} | {"a rendition of a {}", "a rendition of the {}", "the photo of a {}"})

# Textual-Inversion style-learning bank (`ldm/data/personalized_style.py:
# 10-30`): same distribution of painting/rendering flavors
_STYLE_FLAVORS = ("a painting", "a rendering", "a cropped painting",
                  "the painting", "a clean painting", "a dirty painting",
                  "a dark painting", "a picture", "a cool painting",
                  "a close-up painting", "a bright painting",
                  "a good painting", "a rendition", "a nice painting",
                  "a small painting", "a weird painting", "a large painting")
STYLE_TEMPLATES_SMALL = sorted(
    f + " in the style of {}" for f in _STYLE_FLAVORS)

IMG_EXTS = (".jpg", ".jpeg", ".png", ".webp", ".bmp")


@dataclasses.dataclass
class SubjectSpec:
    """Static per-subject metadata (from evaluation/info-*.sh files or
    explicit construction)."""

    name: str
    folder: str
    subject_string: str = "z"
    background_string: Optional[str] = "y"
    cls_delta_string: str = "person"
    cls_bg_delta_string: Optional[str] = "unknown"
    broad_class: int = 1  # 0 object, 1 human/animal, 2 cartoon
    is_animal: bool = True
    is_face: bool = True


@dataclasses.dataclass
class ImageRecord:
    path: str
    mask_path: Optional[str]
    caption: Optional[str]
    subject_idx: int


def _nearest_resize(arr: np.ndarray, size: int) -> np.ndarray:
    h, w = arr.shape[:2]
    ri = (np.arange(size) * (h / size)).astype(np.int64)
    ci = (np.arange(size) * (w / size)).astype(np.int64)
    return arr[ri][:, ci]


def scale_about_center(img: np.ndarray, scale: float) -> np.ndarray:
    """Zero-padded uniform downscale about the image center (the
    torchvision `RandomAffine(scale=(0.7, 1.0))` equivalent, NEAREST)."""
    h, w = img.shape[:2]
    nh, nw = max(1, int(round(h * scale))), max(1, int(round(w * scale)))
    small = _nearest_resize(img, nh) if h == w else img[
        (np.arange(nh) * (h / nh)).astype(np.int64)][:,
        (np.arange(nw) * (w / nw)).astype(np.int64)]
    out = np.zeros_like(img)
    top, left = (h - nh) // 2, (w - nw) // 2
    out[top:top + nh, left:left + nw] = small
    return out


def empty_margin_shift(stack: np.ndarray, aug_channel: int,
                       rng: np.random.Generator, margin: int = 12) -> np.ndarray:
    """Random roll within the zero margins of the aug-mask channel,
    keeping >= `margin` empty lines per side (`personalized.py:636-676`)."""
    m = stack[..., aug_channel]
    rows = m.sum(axis=1)
    cols = m.sum(axis=0)
    top0 = int((np.cumsum(rows) == 0).sum())
    bottom0 = int((np.cumsum(rows[::-1]) == 0).sum())
    left0 = int((np.cumsum(cols) == 0).sum())
    right0 = int((np.cumsum(cols[::-1]) == 0).sum())
    dy = dx = 0
    if top0 + bottom0 > 2 * margin:
        dy = int(rng.integers(0, top0 + bottom0 - 2 * margin + 1))
        if dy > bottom0 - margin:
            dy = -(dy - bottom0 + margin)
    if left0 + right0 > 2 * margin:
        dx = int(rng.integers(0, left0 + right0 - 2 * margin + 1))
        if dx > right0 - margin:
            dx = -(dx - right0 + margin)
    return np.roll(stack, (dy, dx), axis=(0, 1))


class PersonalizedDataset:
    """Map-style dataset; `__getitem__` accepts an int index or a
    `(subject_idx, True)` pair to draw a random image of that subject
    (`personalized.py:509-543`)."""

    def __init__(
        self,
        subjects: Sequence[SubjectSpec],
        size: int = 512,
        repeats: int = 1,
        flip_p: float = 0.5,
        scale_range: Optional[tuple] = (0.7, 1.0),
        num_vectors_per_subj_token: int = 9,
        num_vectors_per_bg_token: int = 4,
        num_compositions_per_image: int = 1,
        common_placeholder_prefix: Optional[str] = None,
        template_set: str = "object",  # 'object' | 'style' (TI style bank)
        seed: Optional[int] = None,
    ):
        self.subjects = list(subjects)
        self.size = size
        self.flip_p = flip_p
        self.scale_range = scale_range
        self.num_vectors_per_subj_token = num_vectors_per_subj_token
        self.num_vectors_per_bg_token = num_vectors_per_bg_token
        self.num_compositions_per_image = num_compositions_per_image
        # comma-separated prefixes; one is sampled per example and prepended
        # to the subject AND class strings (`--common_placeholder_prefix`,
        # `personalized.py:412-415,895-898`; used for cartoon subjects)
        self.common_placeholder_prefixes = (
            re.split(r"\s*,\s*", common_placeholder_prefix)
            if common_placeholder_prefix else None)
        if template_set not in ("object", "style"):
            raise ValueError(f"template_set {template_set!r}")
        self.templates = (STYLE_TEMPLATES_SMALL if template_set == "style"
                          else IMAGENET_TEMPLATES_SMALL)
        self.rng = np.random.default_rng(seed)

        self.records: List[ImageRecord] = []
        self.subject_records: List[List[int]] = [[] for _ in self.subjects]
        for si, spec in enumerate(self.subjects):
            for fname in sorted(os.listdir(spec.folder)):
                low = fname.lower()
                if not low.endswith(IMG_EXTS) or low.endswith("_mask.png"):
                    continue
                path = os.path.join(spec.folder, fname)
                stem = os.path.splitext(path)[0]
                mask_path = stem + "_mask.png"
                if not os.path.exists(mask_path):
                    mask_path = None
                cap_path = stem + ".txt"
                caption = None
                if os.path.exists(cap_path):
                    with open(cap_path) as f:
                        caption = f.read().strip()
                self.subject_records[si].append(len(self.records))
                self.records.append(ImageRecord(path, mask_path, caption, si))
            # metainfo.json person_type cache (`personalized.py:285-330`)
            meta = os.path.join(spec.folder, "metainfo.json")
            if os.path.exists(meta):
                try:
                    with open(meta) as f:
                        info = json.load(f)
                    if "person_type" in info:
                        spec.cls_delta_string = info["person_type"]
                except (json.JSONDecodeError, OSError):
                    pass
        self._repeats = max(1, repeats)

    def __len__(self) -> int:
        return len(self.records) * self._repeats

    def num_images(self, subject_idx: int) -> int:
        return len(self.subject_records[subject_idx])

    # -------------------------------------------------------------- loading
    def _load(self, rec: ImageRecord):
        from PIL import Image

        image = np.asarray(Image.open(rec.path).convert("RGB"), np.uint8)
        if rec.mask_path:
            mask = np.asarray(Image.open(rec.mask_path).convert("L"), np.uint8)
            has_fg_mask = True
        else:
            mask = np.full(image.shape[:2], 255, np.uint8)
            has_fg_mask = False
        return image, mask, has_fg_mask

    def __getitem__(self, index) -> Dict:
        if isinstance(index, tuple):
            subject_idx, _ = index
            choices = self.subject_records[subject_idx]
            rec = self.records[choices[int(self.rng.integers(len(choices)))]]
        else:
            rec = self.records[index % len(self.records)]
        image, fg_mask, has_fg_mask = self._load(rec)

        # single NEAREST resample of image+mask stack (`:574-600`)
        stack = np.concatenate([image, fg_mask[..., None]], axis=-1)
        stack = _nearest_resize(stack, self.size)

        if self.rng.random() < self.flip_p:
            stack = stack[:, ::-1]

        aug_mask = np.ones(stack.shape[:2], np.uint8)
        if self.scale_range is not None and self.rng.random() < 1.0:
            scale = float(self.rng.uniform(*self.scale_range))
            ext = np.concatenate([stack, aug_mask[..., None]], axis=-1)
            ext = scale_about_center(ext, scale)
            ext = empty_margin_shift(ext, aug_channel=4, rng=self.rng)
            stack, aug_mask = ext[..., :4], ext[..., 4]

        image = stack[..., :3]
        fg_mask = (stack[..., 3] / 255).astype(np.uint8)

        example: Dict = {
            "image_path": rec.path,
            "has_fg_mask": has_fg_mask,
            "fg_mask": fg_mask,
            "aug_mask": aug_mask.astype(np.uint8),
            "image_unnorm": image,
            "image": (image / 127.5 - 1.0).astype(np.float32),
        }
        self.generate_prompts(example, rec.subject_idx)
        if rec.caption:
            example["caption"] = rec.caption
        return example

    # -------------------------------------------------------------- prompts
    def generate_prompts(self, example: Dict, subject_idx: int):
        """The 4-type delta-prompt battery (`generate_prompts:869-990`)."""
        spec = self.subjects[subject_idx]
        rng = self.rng
        example["subject_name"] = spec.name

        pad = lambda s, k: s + ", " * (k - 1) if k > 1 else s
        subject_string = pad(spec.subject_string, self.num_vectors_per_subj_token)
        cls_delta_string = pad(spec.cls_delta_string, self.num_vectors_per_subj_token)
        background_string = (pad(spec.background_string, self.num_vectors_per_bg_token)
                             if spec.background_string else None)
        cls_bg_delta = (pad(spec.cls_bg_delta_string, self.num_vectors_per_bg_token)
                        if spec.cls_bg_delta_string and spec.background_string else None)
        if self.common_placeholder_prefixes is not None:
            prefix = self.common_placeholder_prefixes[
                int(rng.integers(len(self.common_placeholder_prefixes)))]
            subject_string = prefix + " " + subject_string
            cls_delta_string = prefix + " " + cls_delta_string

        template = self.templates[int(rng.integers(len(self.templates)))]

        bg_suffix = f" with background {background_string}" if background_string else ""
        cls_bg_suffix = f" with background {cls_bg_delta}" if cls_bg_delta else ""

        subj_type = "animal" if spec.is_animal else "object"
        comps = sample_compositions(self.num_compositions_per_image, subj_type,
                                    is_training=True, rng=rng)
        subj_comp = "|".join(template + " " + c for c in comps)
        cls_comp = "|".join(template + " " + c for c in comps)

        example["caption"] = template.format(subject_string)
        example["caption_bg"] = template.format(subject_string + bg_suffix)
        example["subj_prompt_single"] = template.format(subject_string)
        example["cls_prompt_single"] = template.format(cls_delta_string)
        example["subj_prompt_comp"] = subj_comp.format(
            *[subject_string] * len(comps))
        example["cls_prompt_comp"] = cls_comp.format(
            *[cls_delta_string] * len(comps))

        if bg_suffix:
            example["subj_prompt_single_bg"] = template.format(subject_string + bg_suffix)
            example["cls_prompt_single_bg"] = template.format(cls_delta_string + cls_bg_suffix)
            example["subj_prompt_comp_bg"] = subj_comp.format(
                *[subject_string + bg_suffix] * len(comps))
            example["cls_prompt_comp_bg"] = cls_comp.format(
                *[cls_delta_string + cls_bg_suffix] * len(comps))

        # "face portrait" trick for humans/animals (`:917-922,967-990`)
        if spec.broad_class == 1:
            fp = "a face portrait of a {}"
            fp_comp = "|".join(fp + " " + c for c in comps)
            example["subj_prompt_single_fp"] = fp.format(subject_string)
            example["cls_prompt_single_fp"] = fp.format(cls_delta_string)
            example["subj_prompt_comp_fp"] = fp_comp.format(
                *[subject_string] * len(comps))
            example["cls_prompt_comp_fp"] = fp_comp.format(
                *[cls_delta_string] * len(comps))
            if bg_suffix:
                example["subj_prompt_single_fp_bg"] = fp.format(subject_string + bg_suffix)
                example["cls_prompt_single_fp_bg"] = fp.format(cls_delta_string + cls_bg_suffix)
                example["subj_prompt_comp_fp_bg"] = fp_comp.format(
                    *[subject_string + bg_suffix] * len(comps))
                example["cls_prompt_comp_fp_bg"] = fp_comp.format(
                    *[cls_delta_string + cls_bg_suffix] * len(comps))


class SubjectSampler:
    """Weighted random subject index stream (weight = image count), with
    optional skip-non-faces (`personalized.py:1003-1041`)."""

    def __init__(self, dataset: PersonalizedDataset, skip_non_faces: bool = True,
                 seed: Optional[int] = None):
        self.dataset = dataset
        self.rng = np.random.default_rng(seed)
        weights = []
        for i, spec in enumerate(dataset.subjects):
            n = dataset.num_images(i)
            if skip_non_faces and not spec.is_face:
                n = 0
            weights.append(n)
        w = np.asarray(weights, np.float64)
        if w.sum() == 0:
            w = np.ones_like(w)
        self.probs = w / w.sum()

    def sample(self) -> int:
        return int(self.rng.choice(len(self.probs), p=self.probs))

    def __iter__(self):
        while True:
            yield self.sample()


def collate_examples(examples: Sequence[Dict]) -> Dict:
    """Stack array fields, list the rest — the Lightning default-collate
    behavior the trainer relies on."""
    out: Dict = {}
    for key in examples[0]:
        vals = [e[key] for e in examples]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        else:
            out[key] = vals
    return out
