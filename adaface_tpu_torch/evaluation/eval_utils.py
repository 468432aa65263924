"""Evaluation utilities: folder comparison, face similarity, subject files
(counterpart of `adaface_tpu/evaluation/eval_utils.py`, the reference's
`evaluation/eval_utils.py`):

- `compare_folders` (`:44-86`): load a generated-samples dir and a
  ground-truth dir, compute CLIP-I / CLIP-T / DINO.
- face similarity (`:88-331`): the reference runs deepface or insightface
  ONNX sessions; here the embedder is an injected callable (the port's
  `FaceApp.embed_image`, or any [H,W,3]->[512] function) and the mean-similarity /
  fast-pairwise logic is preserved (`calc_faces_mean_similarity:220`,
  `compare_face_folders_fast:264`).
- `parse_subject_file` (`:411-469`): fish-shell `set -g var value...`
  subject info files (evaluation/info-*.sh), including `$var` indirection,
  typed fields and the sel_set 1-offset.
- `parse_range_str` (`:480-499`).

Images load through `data/png.load_image`: PNGs by the port's own codec
(the card's machine has no PIL), other formats through PIL.
"""

from __future__ import annotations

import os
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from adaface_tpu_torch.data import png

IMG_EXTS = (".jpg", ".jpeg", ".png", ".webp", ".bmp")


def list_image_files(folder: str) -> List[str]:
    """Image files, skipping `*_mask.png` companions (`personalized.py`)
    and `grid*` mosaics (txt2img's grid artifact must not be scored as a
    sample — the reference scores per-prompt indiv_subdirs that never
    contain the grid)."""
    out = []
    for name in sorted(os.listdir(folder)):
        low = name.lower()
        if (low.endswith(IMG_EXTS) and not low.endswith("_mask.png")
                and not low.startswith("grid")):
            out.append(os.path.join(folder, name))
    return out


def load_image_folder(folder: str, size: int = 256,
                      max_images: Optional[int] = None) -> np.ndarray:
    """[N, size, size, 3] uint8 (center crop + nearest resize, matching the
    PersonalizedBase@256 loading in `compare_folders`, `eval_utils.py:48-64`)."""
    paths = list_image_files(folder)
    if max_images:
        paths = paths[:max_images]
    imgs = []
    for p in paths:
        im = png.load_image(p, "RGB")
        h, w = im.shape[:2]
        s = min(h, w)
        im = im[(h - s) // 2:(h - s) // 2 + s, (w - s) // 2:(w - s) // 2 + s]
        ri = (np.arange(size) * (s / size)).astype(np.int64)
        imgs.append(im[ri][:, ri])
    return np.stack(imgs)


def compare_folders(clip_scorer, dino_scorer, gen_dir: str, gt_dir: str,
                    prompt: str, num_samples: int = -1,
                    gt_self_compare: bool = False) -> Tuple[float, float, float]:
    """(CLIP-I, CLIP-T, DINO) between a generated dir and ground truth
    (`eval_utils.py:44-86`). `gt_self_compare` scores gt against itself —
    the upper-bound self-consistency check (`:48-51`)."""
    gt = load_image_folder(gt_dir)
    gen = gt if gt_self_compare else load_image_folder(
        gen_dir, max_images=None if num_samples < 0 else num_samples)
    sim_i, sim_t = clip_scorer.evaluate(gen, gt, prompt)
    sim_dino = dino_scorer.image_pairwise_similarity(gt, gen)
    return float(sim_i), float(sim_t), float(sim_dino)


# ---------------------------------------------------------------- face sim

def embed_folder_faces(face_embed_fn: Callable[[np.ndarray], Optional[np.ndarray]],
                       folder: str, max_images: Optional[int] = None):
    """[N, 512] embeddings of the largest face per image + no-face count
    (`insightface_embed_folder`, `eval_utils.py:155-218`)."""
    paths = list_image_files(folder)
    if max_images:
        paths = paths[:max_images]
    embs, no_face = [], 0
    for p in paths:
        im = png.load_image(p, "RGB")
        e = face_embed_fn(im)
        if e is None:
            no_face += 1
        else:
            embs.append(np.asarray(e, np.float32))
    return (np.stack(embs) if embs else None), no_face


def calc_faces_mean_similarity(embs1: np.ndarray, embs2: np.ndarray) -> float:
    """Mean pairwise cosine similarity (`eval_utils.py:220-246`)."""
    a = embs1 / np.linalg.norm(embs1, axis=-1, keepdims=True)
    b = embs2 / np.linalg.norm(embs2, axis=-1, keepdims=True)
    return float((a @ b.T).mean())


def compare_face_folders(face_embed_fn, folder1: str, folder2: str,
                         max_images: Optional[int] = None):
    """(mean face sim, no-face counts) — `compare_face_folders_fast`
    (`eval_utils.py:264-331`)."""
    e1, nf1 = embed_folder_faces(face_embed_fn, folder1, max_images)
    e2, nf2 = embed_folder_faces(face_embed_fn, folder2, max_images)
    if e1 is None or e2 is None:
        return 0.0, nf1, nf2
    return calc_faces_mean_similarity(e1, e2), nf1, nf2


# ------------------------------------------------------------ subject files

def _split_string(s: str) -> List[str]:
    """Fish-style word split honoring quotes (`eval_utils.py:395-409`)."""
    return [p.strip('"').strip("'") for p in re.findall(r'"[^"]*"|\'[^\']*\'|\S+', s)]


def parse_subject_file(path: str) -> Tuple[Dict, Dict]:
    """Parse a fish-syntax info file of `set -g name value...` lines
    (`eval_utils.py:411-469`). Returns (subj_info, subj2attr)."""
    subj_info: Dict[str, list] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            mat = re.search(r"^set -g ([a-zA-Z_]+)\s+(\S.*)", line)
            if mat is None:
                continue
            var_name, raw = mat.group(1), mat.group(2)
            substrings = _split_string(raw)
            if re.match("broad_classes|are_faces|maxiters", var_name):
                values = [int(s) for s in substrings]
            elif var_name == "all_init_word_weights":
                values = [[float(x) for x in _split_string(w)] for w in substrings]
            elif var_name == "sel_set":
                values = [int(s) - 1 for s in substrings]
            else:
                values = substrings
            if len(values) == 1 and isinstance(values[0], str) and values[0].startswith("$"):
                values = subj_info[values[0][1:]]
            subj_info[var_name] = values

    for var_name in ("subjects", "class_names", "cls_delta_strings", "data_folder"):
        if var_name not in subj_info:
            raise ValueError(f"{var_name} not defined in {path}")

    if "broad_classes" not in subj_info:
        subj_info["broad_classes"] = [1] * len(subj_info["subjects"])
    if "sel_set" not in subj_info:
        subj_info["sel_set"] = list(range(len(subj_info["subjects"])))

    subj2attr: Dict[str, Dict] = {}
    for var_name in ("class_names", "cls_delta_strings", "all_init_word_weights",
                     "bg_init_strings", "broad_classes", "are_faces"):
        if var_name in subj_info:
            vals = subj_info[var_name]
            if len(vals) != len(subj_info["subjects"]):
                raise ValueError(
                    f"{var_name} has {len(vals)} values for "
                    f"{len(subj_info['subjects'])} subjects in {path}")
            subj2attr[var_name] = dict(zip(subj_info["subjects"], vals))
    return subj_info, subj2attr


def parse_range_str(range_str: Optional[str], fix_1_offset: bool = True) -> Optional[List[int]]:
    """'3-7,8,10' -> indices; inclusive ranges, optional 1-offset fix
    (`eval_utils.py:480-499`)."""
    if range_str is None:
        return None
    offset = 1 if fix_1_offset else 0
    out: List[int] = []
    for part in range_str.split(","):
        if "-" in part:
            a, b = (int(x) - offset for x in part.split("-"))
            out.extend(range(a, b + 1))
        else:
            out.append(int(part) - offset)
    return out


def find_first_match(lst: Sequence[str], search_term: str, extra_sig: str = ""):
    for item in lst:
        if search_term in item and re.search(extra_sig, item):
            return item
    return None
