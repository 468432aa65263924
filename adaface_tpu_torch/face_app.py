"""Face analysis, the insightface `FaceAnalysis` equivalent (counterpart of
`adaface_tpu/face_app.py` and of `default_face_app` in
`scripts/filter_faces.py`).

- Detection stays on the host behind an injected `detect_fn(rgb_image) ->
  [(bbox[4], landmarks[5, 2], score), ...]`. `full_image_detector` is the
  no-weights detector: the whole frame as one face with the template
  landmarks, right for the pre-cropped subject photos the datasets ship.
- Alignment, crop, normalization and the IResNet forward run on the
  recognizer's device: the 5-point transforms from `estimate_norm` (host),
  then `warp_affine_torch` over all faces of an image at once.
- `Face.normed_embedding` and the biggest-face choice of `embed_image` are
  the reference's call sites (sorted by bbox area, the largest wins).

The JAX package pads the canvas to a multiple of 256 and the face count to a
power of two, only to bound its compiles; the port does neither. The warp
reads zero outside the image, so the embeddings are the same.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, List, Optional

import numpy as np
import torch

from adaface_tpu_torch.device import resolve_device
from adaface_tpu_torch.models.arcface import (
    ARCFACE_DST,
    IResNet,
    IResNetConfig,
    estimate_norm,
    init_iresnet_,
    map_arcface_onnx_params,
    preprocess_faces,
    warp_affine_torch,
)


@dataclasses.dataclass
class Face:
    bbox: np.ndarray  # [4] x1 y1 x2 y2
    landmarks: np.ndarray  # [5, 2]
    det_score: float
    embedding: Optional[np.ndarray] = None  # [emb_dim]

    @property
    def normed_embedding(self) -> np.ndarray:
        e = self.embedding
        return e / (np.linalg.norm(e) + 1e-12)

    @property
    def area(self) -> float:
        x1, y1, x2, y2 = self.bbox
        return float((x2 - x1) * (y2 - y1))


def full_image_detector(image: np.ndarray) -> List[tuple]:
    """The whole frame as one face, the ArcFace landmark template scaled to
    the frame."""
    h, w = image.shape[:2]
    bbox = np.array([0, 0, w, h], np.float32)
    lm = ARCFACE_DST * np.array([w / 112.0, h / 112.0], np.float32)
    return [(bbox, lm, 1.0)]


class FaceApp:
    """`FaceAnalysis`-shaped: host detection, recognition on the
    recognizer's device."""

    def __init__(self, recognizer: IResNet,
                 detect_fn: Callable = full_image_detector):
        self.recognizer = recognizer.eval().requires_grad_(False)
        self.detect_fn = detect_fn

    @property
    def crop_size(self) -> int:
        return self.recognizer.cfg.input_size

    @property
    def device(self) -> torch.device:
        return self.recognizer.fc.weight.device

    @torch.inference_mode()
    def get(self, image: np.ndarray) -> List[Face]:
        """RGB [H, W, 3] -> its faces with embeddings (the detector's order).
        Raises ValueError where landmarks give a non-finite or singular
        alignment transform."""
        dets = self.detect_fn(image)
        if not dets:
            return []
        size = self.crop_size
        faces = [Face(np.asarray(bbox, np.float32), np.asarray(lm, np.float32), float(score))
                 for bbox, lm, score in dets]
        Ms = np.stack([estimate_norm(f.landmarks, size) for f in faces])
        det = Ms[:, 0, 0] * Ms[:, 1, 1] - Ms[:, 0, 1] * Ms[:, 1, 0]
        if not np.isfinite(Ms).all() or (np.abs(det) < 1e-12).any():
            # coincident landmarks give a non-finite fit, collapsed ones a
            # singular transform that the warp would divide by
            raise ValueError("degenerate face landmarks: singular or "
                             "non-finite alignment transform")
        img = torch.from_numpy(np.ascontiguousarray(image)).to(self.device)
        crops = warp_affine_torch(img, torch.from_numpy(Ms), size)
        embs = self.recognizer(preprocess_faces(crops, size)).float().cpu().numpy()
        for f, e in zip(faces, embs):
            f.embedding = e
        return faces

    def embed_image(self, image: np.ndarray) -> Optional[np.ndarray]:
        """The biggest face's normed embedding, or None without a face (the
        `face_embed_fn` of `ZeroShotFeatureExtractor` and face-sim scoring)."""
        faces = self.get(image)
        if not faces:
            return None
        return max(faces, key=lambda f: f.area).normed_embedding


def default_face_app(device=None) -> FaceApp:
    """IResNet-100 from the ONNX file `ARCFACE_ONNX` names, when it exists;
    else the tiny random recognizer (seed 0) with a note. On `device` (the
    CUDA card unless `device="cpu"`), fp32."""
    from adaface_tpu_torch.interop.onnx_weights import load_onnx_weights
    from adaface_tpu_torch.pipeline import build_loaded

    dev = resolve_device(device)
    onnx_path = os.environ.get("ARCFACE_ONNX")
    if onnx_path and os.path.exists(onnx_path):
        weights, nodes = load_onnx_weights(onnx_path, with_graph=True)
        cfg = IResNetConfig.iresnet100()
        return FaceApp(build_loaded(lambda: IResNet(cfg),
                                    map_arcface_onnx_params(weights, nodes, cfg), dev))
    print("NOTE: no ARCFACE_ONNX weights; random recognizer (smoke mode)")
    model = IResNet(IResNetConfig.tiny()).to(dev)
    return FaceApp(init_iresnet_(model, torch.Generator(device=dev).manual_seed(0)))
