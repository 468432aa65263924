"""Reading and writing weight files without the `safetensors` package
(counterpart of `load_safetensors` / `save_safetensors` /
`load_torch_checkpoint` in `adaface_tpu/interop/torch_pickle.py`).

- safetensors: an 8-byte little-endian header length, a JSON header (name ->
  dtype, shape, byte range; an optional `__metadata__`), then the raw
  little-endian slabs. F32, F16 and BF16 load as tensors of that dtype (the
  JAX reader widens BF16 to F32; `torch.float32` here is one `.float()`
  away), the integer and bool tags as theirs.
- `.bin` / `.pt`: `torch.load(weights_only=True)`, which refuses pickled
  code.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict

import torch

_TAGS = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
         "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
         "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}
_NAMES = {v: k for k, v in _TAGS.items()}


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """name -> CPU tensor of a `.safetensors` file."""
    out = {}
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
        base = 8 + hlen
        for name, meta in header.items():
            if name == "__metadata__":
                continue
            if meta["dtype"] not in _TAGS:
                raise ValueError(f"{path}: {name} has unsupported dtype {meta['dtype']}")
            start, end = meta["data_offsets"]
            f.seek(base + start)
            raw = bytearray(f.read(end - start))
            if len(raw) != end - start:
                raise ValueError(f"{path}: {name} is truncated")
            t = torch.frombuffer(raw, dtype=_TAGS[meta["dtype"]]) if raw else \
                torch.empty(0, dtype=_TAGS[meta["dtype"]])
            out[name] = t.reshape(meta["shape"])
    return out


def save_safetensors(tensors: Dict[str, torch.Tensor], path: str) -> None:
    """Write `tensors` (any device) as a `.safetensors` file, slabs in the
    dict's order."""
    header: Dict = {}
    blobs, off = [], 0
    for name, t in tensors.items():
        t = t.detach().cpu().contiguous()
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: unsupported dtype {t.dtype}")
        # bytes through a same-width integer view: numpy has no bfloat16
        width = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
        raw = (t.view(width) if t.dtype != torch.bool else t.to(torch.uint8)).numpy()
        raw = raw.astype(raw.dtype.newbyteorder("<"), copy=False).tobytes()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    hdr = json.dumps(header, separators=(",", ":")).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hdr)))
        f.write(hdr)
        for raw in blobs:
            f.write(raw)


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """A flat name -> tensor dict from a `.safetensors` file or a torch
    `.bin` / `.pt` file (loaded with `weights_only=True`)."""
    if path.endswith(".safetensors"):
        return load_safetensors(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v for k, v in sd.items() if torch.is_tensor(v)}


def find_weights_file(path: str, names) -> str:
    """`path` itself, or the first of `names` inside the directory `path`."""
    if not os.path.isdir(path):
        return path
    for name in names:
        cand = os.path.join(path, name)
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(f"none of {list(names)} under {path}")

