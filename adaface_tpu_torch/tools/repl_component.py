"""Splice another text encoder or VAE into an SD checkpoint's weights
(counterpart of `scripts/repl_component.py`, the reference's
`repl_textencoder.py` / `repl_vae.py`):

    python -m adaface_tpu_torch.tools.repl_component --base sd-v1-5.ckpt \\
        --vae vae-ft-mse.ckpt --out bundle.npz

It reads an SD v1.x `.ckpt` or `.safetensors` through the port's maps
(`interop/{sd_unet,sd_vae,hf_clip}.py`; no pickled code runs), replaces the
CLIP text tower (`--textencoder`: an SD checkpoint, whose
`cond_stage_model.` prefix is detected, or an HF `text_model.` state dict)
and/or the VAE (`--vae`: an SD checkpoint's `first_stage_model.` or a bare
VAE state dict), and writes one `.npz` of fp32 arrays named `unet.<key>`,
`vae.<key>`, `clip.<key>` by the port's own state-dict keys (JAX writes its
flax paths under `unet/`, `vae/`, `clip/`). Nothing in either package loads
such a bundle yet. Host only: no card is used.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional, Sequence

import numpy as np
import torch

CLIP_SD_PREFIX = "cond_stage_model.transformer.text_model."


def replace_components(base: str, textencoder: Optional[str] = None,
                       vae: Optional[str] = None) -> Dict[str, Dict[str, torch.Tensor]]:
    """{"unet", "vae", "clip"} -> the port's state dict of each, from `base`
    (SD v1.5's configs, a 12-layer text tower) with the text tower and / or
    the VAE taken from other files."""
    from adaface_tpu_torch.interop.hf_clip import map_clip_text_state_dict
    from adaface_tpu_torch.interop.sd_unet import map_unet_state_dict
    from adaface_tpu_torch.interop.sd_vae import map_vae_state_dict
    from adaface_tpu_torch.interop.torch_pickle import load_sd_state_dict
    from adaface_tpu_torch.models.unet import UNetConfig
    from adaface_tpu_torch.models.vae import VAEConfig

    vae_cfg = VAEConfig.sd_v1()
    base_sd = load_sd_state_dict(base)
    parts = {"unet": map_unet_state_dict(base_sd, UNetConfig.sd_v1()),
             "vae": map_vae_state_dict(base_sd, vae_cfg),
             "clip": map_clip_text_state_dict(base_sd, prefix=CLIP_SD_PREFIX)}
    if textencoder:
        src = load_sd_state_dict(textencoder)
        prefix = (CLIP_SD_PREFIX if any(k.startswith("cond_stage_model.") for k in src)
                  else "text_model.")
        parts["clip"] = map_clip_text_state_dict(src, prefix=prefix)
        print(f"replaced text encoder from {textencoder}")
    if vae:
        src = load_sd_state_dict(vae)
        prefix = ("first_stage_model." if any(k.startswith("first_stage_model.") for k in src)
                  else "")
        parts["vae"] = map_vae_state_dict(src, vae_cfg, prefix=prefix)
        print(f"replaced VAE from {vae}")
    return parts


def bundle_arrays(parts) -> Dict[str, np.ndarray]:
    """`<part>.<key>` -> fp32 array (bf16 read as fp32, as JAX reads it)."""
    out = {}
    for name, sd in parts.items():
        for k, v in sd.items():
            v = v.detach().cpu()
            out[f"{name}.{k}"] = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--base", required=True, help="SD v1.x .ckpt or .safetensors")
    p.add_argument("--textencoder", default=None, help="ckpt to take the text encoder from")
    p.add_argument("--vae", default=None, help="ckpt to take the VAE from")
    p.add_argument("--out", required=True, help="output .npz bundle")
    opt = p.parse_args(argv)
    arrays = bundle_arrays(replace_components(opt.base, opt.textencoder, opt.vae))
    np.savez(opt.out, **arrays)
    print(f"wrote {len(arrays)} arrays -> {opt.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
