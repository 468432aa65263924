"""Background-compositing stream over LAION-style tar shards (the port's own
copy of `adaface_tpu/data/wds.py`).

Tar shards are streamed with the stdlib `tarfile`, yielding (image,
metadata) pairs from `.jpg/.png` members paired with `.json` (or `.txt`)
captions, looping over the shards forever. PNG members decode through
`data/png.py`, JPEG members through `data/jpeg.py` (each member once;
nothing is kept), other formats through PIL.

Filters (`BackgroundCompositor.next_background`):
- prompts shorter than 5 chars;
- prompts containing the subject/background placeholder tokens;
- prompts matching the human/animal pattern (no people in backgrounds);
- bad aspect (w/h >= 1.34 or < 0.75) and too-small sources
  (target/short-edge ratio >= 1.3).

Compositing: un-pad the stored image back to its content box, resize and
crop it to `size`, then paste the subject's fg pixels over it; caption
suffix ", in front of " + the bg prompt, and the class variant.
"""

from __future__ import annotations

import json
import re
import tarfile
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from adaface_tpu_torch.data.png import load_image

# human/animal keyword filter (`personalized.py` human_animal_pat)
HUMAN_ANIMAL_PAT = re.compile(
    r"\b(man|men|woman|women|person|people|human|male|female|boy|boys|girl|"
    r"girls|baby|babies|child|children|kid|kids|adult|lady|ladies|guy|guys|"
    r"face|head|portrait|bride|groom|dancer|player|model|singer|actor|"
    r"actress|dog|cat|bird|horse|animal)\b")


def stream_tar_shards(shard_paths: Sequence[str]) -> Iterator[Tuple[np.ndarray, Dict]]:
    """Yield (RGB uint8 image, metadata dict with 'caption', 'width',
    'height', 'original_width', 'original_height') forever."""
    while True:
        for shard in shard_paths:
            with tarfile.open(shard) as tf:
                pending: Dict[str, Dict] = {}
                for member in tf:
                    if not member.isfile():
                        continue
                    stem, _, ext = member.name.rpartition(".")
                    data = tf.extractfile(member).read()
                    entry = pending.setdefault(stem, {})
                    if ext.lower() in ("jpg", "jpeg", "png", "webp"):
                        entry["image"] = data
                    elif ext.lower() == "json":
                        try:
                            entry["meta"] = json.loads(data)
                        except json.JSONDecodeError:
                            entry["meta"] = {}
                    elif ext.lower() == "txt":
                        entry.setdefault("meta", {})["caption"] = \
                            data.decode("utf-8", "replace").strip()
                    if "image" in entry and "meta" in entry:
                        del pending[stem]
                        try:
                            img = load_image(entry["image"], "RGB")
                        except Exception:
                            continue
                        meta = dict(entry["meta"])
                        meta.setdefault("caption", "")
                        meta.setdefault("width", img.shape[1])
                        meta.setdefault("height", img.shape[0])
                        meta.setdefault("original_width", meta["width"])
                        meta.setdefault("original_height", meta["height"])
                        yield img, meta


def _resize_and_crop(img: np.ndarray, size: int) -> np.ndarray:
    """Resize shorter edge to `size` (nearest) then center crop."""
    h, w = img.shape[:2]
    scale = size / min(h, w)
    nh, nw = max(size, int(round(h * scale))), max(size, int(round(w * scale)))
    ri = (np.arange(nh) * (h / nh)).astype(np.int64)
    ci = (np.arange(nw) * (w / nw)).astype(np.int64)
    big = img[ri][:, ci]
    top, left = (nh - size) // 2, (nw - size) // 2
    return big[top:top + size, left:left + size]


def repl_bg_as_wbg(prompt: str, background_string: Optional[str],
                   wds_background_string: Optional[str]) -> str:
    """Replace the singleton background placeholder with the dedicated wds
    background placeholder (`repl_bg_as_wbg`, `personalized.py:982-990`):
    wds backgrounds are out-of-domain for the per-subject 'y' embedder, so
    they get their own token (reference default 'w'). No-op when either
    string is unset."""
    if not background_string or not wds_background_string:
        return prompt
    return re.sub(rf"\b{re.escape(background_string)}\b",
                  wds_background_string, prompt)


class BackgroundCompositor:
    """Draw filtered background images and composite subject foregrounds."""

    def __init__(self, shard_paths: Sequence[str], size: int = 512,
                 forbidden_strings: Sequence[str] = ("z", "y", "w"),
                 max_tries: int = 100):
        self.size = size
        self.stream = stream_tar_shards(shard_paths)
        self.forbidden = [re.compile(rf"(?<![a-z]){re.escape(s)}(?![a-z])")
                          for s in forbidden_strings]
        self.max_tries = max_tries

    def next_background(self) -> Optional[Tuple[np.ndarray, str]]:
        """The filter loop (`personalized.py:728-768`). Returns
        (bg image [size,size,3] u8, bg prompt) or None after max_tries."""
        for _ in range(self.max_tries):
            img, meta = next(self.stream)
            prompt = str(meta.get("caption", "")).lower()
            if len(prompt.strip()) < 5:
                continue
            if any(p.search(prompt) for p in self.forbidden):
                continue
            if HUMAN_ANIMAL_PAT.search(prompt):
                continue
            w = meta.get("width") or img.shape[1]
            h = meta.get("height") or img.shape[0]
            hw_ratio = w / max(h, 1)
            if hw_ratio >= 1.34 or hw_ratio < 0.75:
                continue
            oh = meta.get("original_height") or h
            ow = meta.get("original_width") or w
            if max(self.size / oh, self.size / ow) >= 1.3:
                continue
            # un-pad the stored image back to its content box (`:773-791`)
            scale = min(self.size / oh, self.size / ow)
            bg_h, bg_w = int(oh * scale), int(ow * scale)
            top = max((img.shape[0] - bg_h) // 2, 0)
            left = max((img.shape[1] - bg_w) // 2, 0)
            nopad = img[top:top + bg_h, left:left + bg_w]
            return _resize_and_crop(nopad, self.size), prompt
        return None

    def composite(self, example: Dict, cls_delta_string: str,
                  background_string: str = None,
                  wds_background_string: str = None) -> Dict:
        """Fill the `wds_*` example keys (`personalized.py:800-824`):
        subject fg pasted over a background, caption suffixes, bg-only
        image. The `_bg` caption variants swap the ordinary background
        placeholder for the dedicated wds one (`repl_bg_as_wbg`,
        `personalized.py:982-990`; reference default 'w') so the wds
        backgrounds train their own embedder. Mutates and returns
        `example`."""
        bg = self.next_background()
        if bg is None:
            example.update({
                "wds_comp_extra": "", "wds_cls_comp_extra": "",
                "wds_caption": example["caption"],
                "wds_caption_bg": example.get("caption_bg", example["caption"]),
                "wds_image": example["image"],
                "wds_aug_mask": example["aug_mask"],
                "has_wds_comp": False,
            })
            return example
        bg_img, bg_prompt = bg
        fg_mask = example["fg_mask"]
        image_u8 = example["image_unnorm"]
        wds_image = np.where(fg_mask[:, :, None] > 0, image_u8, bg_img)
        extra = ", in front of " + bg_prompt
        cls_extra = " " + cls_delta_string + extra
        cap_bg = repl_bg_as_wbg(
            example.get("caption_bg", example["caption"]),
            background_string, wds_background_string)
        example.update({
            "wds_comp_extra": extra,
            "wds_cls_comp_extra": cls_extra,
            "wds_caption": example["caption"] + extra,
            "wds_cls_caption": example["caption"] + cls_extra,
            "wds_caption_bg": cap_bg + extra,
            "wds_cls_caption_bg": cap_bg + cls_extra,
            "wds_image": (wds_image / 127.5 - 1.0).astype(np.float32),
            "wds_image_bgonly": (bg_img / 127.5 - 1.0).astype(np.float32),
            "wds_aug_mask": example["aug_mask"],
            "has_wds_comp": True,
        })
        return example
