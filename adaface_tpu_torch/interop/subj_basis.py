"""A pickled reference `SubjBasisGenerator` -> the port's generator
(counterpart of `adaface_tpu/interop/subj_basis.py`).

A reference zero-shot `embeddings.pt` pickles live modules under
`string_to_subj_basis_generator_dict`; `interop.torch_pickle` reads each as
a `TorchObjectStub` tree. `map_subj_basis_generator` turns one into (the
port's state dict, `SubjBasisGeneratorMeta`), `build_generator_from_meta`
makes the matching `SubjBasisGenerator`, and `export_subj_basis_generator`
writes a port state dict back in the reference's names.

Reference names (`ldm/modules/subj_basis_generator.py:369-470`) -> port names:

  fg: pos_embs, pos_embs_ln                  -> the same (neither is read; the
                                                port's fg generator has no pos_embs_ln,
                                                so loading leaves it out)
      obj_proj_in.0 (Linear) / .2 (LayerNorm) -> obj_proj_dense / obj_proj_ln
      prompt2token_proj.text_model.*         -> prompt2token_proj.* (`interop.hf_clip`);
                                                k/v rows a multiple m of the width
                                                are an MKV extension by m
      hidden_state_layer_weights [3, 1]      -> the same (a legacy [3, 768] is
                                                averaged to [3, 1], as the reference's
                                                load repair does)
  bg: bg_proj_in.0 / .1                      -> bg_proj_dense / bg_proj_ln
      latent_queries, latent_queries_ln      -> the same
      prompt_translator.to_{q,k,v}.0 / .1    -> prompt_translator.to_{q,k,v}_dense / _ln

A bg translator with an output projection (`prompt_translator.to_out`) maps
to `prompt_translator.to_out` / `to_out_ln`, which no generator of either
package runs: `build_generator_from_meta` refuses it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from adaface_tpu_torch.interop.hf_clip import hf_clip_text_state_dict, map_clip_text_state_dict
from adaface_tpu_torch.interop.torch_pickle import TorchObjectStub, walk_stub_tree
from adaface_tpu_torch.models.clip_text import CLIPTextConfig

PROJ_PREFIX = "prompt2token_proj.text_model."


@dataclasses.dataclass
class SubjBasisGeneratorMeta:
    """Constructor facts recovered from the pickled module."""

    placeholder_is_bg: bool
    output_dim: int
    num_out_layers: int
    num_out_embs_per_layer: int
    num_heads: int = 6
    image_embedding_dim: Optional[int] = None  # bg only
    bg_num_id_vecs: Optional[int] = None  # bg only
    dino_embedding_dim: Optional[int] = None  # fg only
    kv_multipliers: Optional[tuple] = None  # fg prompt2token_proj extension
    num_proj_layers: Optional[int] = None  # fg prompt2token_proj depth
    prompt_translator_has_to_out: bool = False  # bg only
    hidden_state_weights_were_per_feature: bool = False
    # the pickled HF config of prompt2token_proj (hidden_size, heads, ...)
    proj_config: Optional[dict] = None
    fg_num_id_vecs: int = 77  # fg pos_embs rows (never read)


# tensors of a reference fg generator that the port's fg generator does not hold
FG_UNREAD = ("pos_embs_ln.",)


def _ln(flat, dst: str, src: str) -> Dict[str, torch.Tensor]:
    return {dst + ".weight": flat[src + ".weight"], dst + ".bias": flat[src + ".bias"]}


def _opt_ln(flat, dst: str, src: str) -> Dict[str, torch.Tensor]:
    return _ln(flat, dst, src) if src + ".weight" in flat else {}


def map_subj_basis_generator(stub_or_flat: Any) -> Tuple[Dict[str, torch.Tensor],
                                                         SubjBasisGeneratorMeta]:
    """A pickled generator (stub, or an already flat state dict) -> (port
    state dict of CPU tensors, meta)."""
    attrs: Dict[str, Any] = {}
    if isinstance(stub_or_flat, TorchObjectStub):
        attrs = stub_or_flat.__dict__
        flat = walk_stub_tree(stub_or_flat)
    else:
        flat = dict(stub_or_flat)
    flat = {k: torch.as_tensor(v) for k, v in flat.items()}
    is_bg = bool(attrs.get("placeholder_is_bg", "bg_proj_in.0.weight" in flat))
    return _map_bg(flat, attrs) if is_bg else _map_fg(flat, attrs)


def _extract_hf_config(attrs) -> Optional[dict]:
    """The numeric fields of the pickled HF config of `prompt2token_proj`."""
    proj = (attrs.get("_modules") or {}).get("prompt2token_proj")
    cfg = proj.__dict__.get("config") if isinstance(proj, TorchObjectStub) else None
    if cfg is None:
        return None
    d = cfg.__dict__ if isinstance(cfg, TorchObjectStub) else cfg
    keys = ("hidden_size", "num_hidden_layers", "num_attention_heads", "intermediate_size",
            "vocab_size", "max_position_embeddings", "layer_norm_eps")
    return {k: d[k] for k in keys
            if k in d and isinstance(d[k], (int, float)) and not isinstance(d[k], bool)}


def _map_fg(flat, attrs) -> Tuple[Dict[str, torch.Tensor], SubjBasisGeneratorMeta]:
    D = int(flat["pos_embs"].shape[-1])
    layer_ids = sorted({int(k.split("encoder.layers.")[1].split(".")[0])
                        for k in flat if k.startswith(PROJ_PREFIX + "encoder.layers.")})
    hidden = int(flat[PROJ_PREFIX + "embeddings.token_embedding.weight"].shape[1])
    sd = {"pos_embs": flat["pos_embs"], **_opt_ln(flat, "pos_embs_ln", "pos_embs_ln")}
    proj = map_clip_text_state_dict(flat, num_layers=len(layer_ids), prefix=PROJ_PREFIX)
    sd.update({"prompt2token_proj." + k: v for k, v in proj.items()})
    dino_dim = None
    if "obj_proj_in.0.weight" in flat:
        w = flat["obj_proj_in.0.weight"]  # [16*D, dino]
        dino_dim = int(w.shape[1])
        sd["obj_proj_dense.weight"] = w
        sd.update(_ln(flat, "obj_proj_ln", "obj_proj_in.2"))
    hslw = flat["hidden_state_layer_weights"]
    per_feature = hslw.dim() == 2 and hslw.shape[1] > 1
    if per_feature:  # legacy [3, 768] -> [3, 1]
        hslw = hslw.float().mean(dim=1, keepdim=True).to(hslw.dtype)
    sd["hidden_state_layer_weights"] = hslw.reshape(-1, 1)

    mults = []
    for i in layer_ids:
        rows = int(flat[f"{PROJ_PREFIX}encoder.layers.{i}.self_attn.k_proj.weight"].shape[0])
        m, rem = divmod(rows, hidden)
        if rem:
            raise ValueError(f"layer {i} k_proj out dim {rows} is not a multiple of "
                             f"hidden {hidden}")
        mults.append(m)
    meta = SubjBasisGeneratorMeta(
        placeholder_is_bg=False, output_dim=D,
        num_out_layers=int(attrs.get("num_out_layers", 16)),
        num_out_embs_per_layer=int(attrs.get("num_out_embs_per_layer", 16)),
        dino_embedding_dim=dino_dim,
        kv_multipliers=tuple(mults) if any(m != 1 for m in mults) else None,
        num_proj_layers=len(layer_ids), hidden_state_weights_were_per_feature=per_feature,
        proj_config=_extract_hf_config(attrs), fg_num_id_vecs=int(flat["pos_embs"].shape[1]))
    return sd, meta


def _map_bg(flat, attrs) -> Tuple[Dict[str, torch.Tensor], SubjBasisGeneratorMeta]:
    D = int(flat["pos_embs"].shape[-1])
    bg_w = flat["bg_proj_in.0.weight"]  # [D, D_img]
    sd = {"pos_embs": flat["pos_embs"], **_ln(flat, "pos_embs_ln", "pos_embs_ln"),
          "bg_proj_dense.weight": bg_w, **_ln(flat, "bg_proj_ln", "bg_proj_in.1"),
          "latent_queries": flat["latent_queries"],
          **_ln(flat, "latent_queries_ln", "latent_queries_ln")}
    for name in ("to_q", "to_k", "to_v"):
        sd[f"prompt_translator.{name}_dense.weight"] = flat[f"prompt_translator.{name}.0.weight"]
        sd.update(_ln(flat, f"prompt_translator.{name}_ln", f"prompt_translator.{name}.1"))
    has_to_out = "prompt_translator.to_out.0.weight" in flat
    if has_to_out:
        sd["prompt_translator.to_out.weight"] = flat["prompt_translator.to_out.0.weight"]
        sd.update(_ln(flat, "prompt_translator.to_out_ln", "prompt_translator.to_out.2"))
    n_latents = int(flat["latent_queries"].shape[1])
    num_out_layers = int(attrs.get("num_out_layers", 16))
    meta = SubjBasisGeneratorMeta(
        placeholder_is_bg=True, output_dim=D, num_out_layers=num_out_layers,
        num_out_embs_per_layer=int(attrs.get("num_out_embs_per_layer",
                                             n_latents // num_out_layers)),
        image_embedding_dim=int(bg_w.shape[1]), bg_num_id_vecs=int(flat["pos_embs"].shape[1]),
        prompt_translator_has_to_out=has_to_out)
    return sd, meta


def proj_config_from_meta(meta: SubjBasisGeneratorMeta) -> CLIPTextConfig:
    """The fg generator's `prompt2token_proj` config: the pickled HF config's
    widths (ViT-L/14's where it has none), the checkpoint's depth and MKV
    multipliers."""
    hf = meta.proj_config or {}
    return CLIPTextConfig.vit_l_14(
        kv_multipliers=meta.kv_multipliers,
        num_layers=meta.num_proj_layers or hf.get("num_hidden_layers", 12),
        hidden_size=hf.get("hidden_size", 768), num_heads=hf.get("num_attention_heads", 12),
        intermediate_size=hf.get("intermediate_size", 3072),
        vocab_size=hf.get("vocab_size", 49408))


def build_generator_from_meta(meta: SubjBasisGeneratorMeta, pad_token_id: Optional[int] = None):
    """The port's `SubjBasisGenerator` matching `meta` (on the meta device;
    `to_empty` and `load_state_dict` fill it). `pad_token_id` defaults to
    the projection vocabulary's last id (CLIP's pad == eos)."""
    from adaface_tpu_torch.personalization.subj_basis_generator import SubjBasisGenerator

    with torch.device("meta"):
        if meta.placeholder_is_bg:
            if meta.prompt_translator_has_to_out:
                raise ValueError("the bg generator's prompt_translator has an output "
                                 "projection (to_out), which the generator does not run")
            return SubjBasisGenerator(
                placeholder_is_bg=True, num_out_layers=meta.num_out_layers,
                num_out_embs_per_layer=meta.num_out_embs_per_layer,
                output_dim=meta.output_dim,
                image_embedding_dim=meta.image_embedding_dim or 1280,
                bg_num_id_vecs=meta.bg_num_id_vecs or 257, num_heads=meta.num_heads)
        proj_cfg = proj_config_from_meta(meta)
        return SubjBasisGenerator(
            placeholder_is_bg=False, num_out_layers=meta.num_out_layers,
            num_out_embs_per_layer=meta.num_out_embs_per_layer, output_dim=meta.output_dim,
            dino_embedding_dim=meta.dino_embedding_dim or 384,
            fg_num_id_vecs=meta.fg_num_id_vecs, proj_cfg=proj_cfg,
            pad_token_id=proj_cfg.vocab_size - 1 if pad_token_id is None else pad_token_id)


def load_generator(sd: Dict[str, torch.Tensor], meta: SubjBasisGeneratorMeta,
                   device=None, pad_token_id: Optional[int] = None):
    """`build_generator_from_meta` filled with `sd` (fp32, on `device`). A
    state dict without the fg object branch (a face-only checkpoint) leaves
    that branch zero."""
    from adaface_tpu_torch.personalization.subj_basis_generator import OBJECT_BRANCH

    gen = build_generator_from_meta(meta, pad_token_id).to_empty(device=device or "cpu")
    with torch.no_grad():
        for p in gen.parameters():
            p.zero_()
    if not meta.placeholder_is_bg:
        sd = {k: v for k, v in sd.items() if not k.startswith(FG_UNREAD)}
    missing, unexpected = gen.load_state_dict({k: v.float() for k, v in sd.items()},
                                              strict=False)
    missing = [k for k in missing if not k.startswith(OBJECT_BRANCH)]
    if missing or unexpected:
        raise ValueError(f"generator state dict mismatch: missing {missing}, "
                         f"unexpected {unexpected}")
    return gen.float().eval()


def export_subj_basis_generator(sd: Dict[str, torch.Tensor],
                                placeholder_is_bg: bool) -> Dict[str, torch.Tensor]:
    """A port generator's state dict in the reference's names (the inverse
    of `map_subj_basis_generator`)."""
    out: Dict[str, torch.Tensor] = {"pos_embs": sd["pos_embs"],
                                    **_opt_ln(sd, "pos_embs_ln", "pos_embs_ln")}
    if placeholder_is_bg:
        out["bg_proj_in.0.weight"] = sd["bg_proj_dense.weight"]
        out.update(_ln(sd, "bg_proj_in.1", "bg_proj_ln"))
        out["latent_queries"] = sd["latent_queries"]
        out.update(_ln(sd, "latent_queries_ln", "latent_queries_ln"))
        for name in ("to_q", "to_k", "to_v"):
            out[f"prompt_translator.{name}.0.weight"] = sd[f"prompt_translator.{name}_dense.weight"]
            out.update(_ln(sd, f"prompt_translator.{name}.1", f"prompt_translator.{name}_ln"))
        if "prompt_translator.to_out.weight" in sd:
            out["prompt_translator.to_out.0.weight"] = sd["prompt_translator.to_out.weight"]
            out.update(_ln(sd, "prompt_translator.to_out.2", "prompt_translator.to_out_ln"))
        return out
    out["hidden_state_layer_weights"] = sd["hidden_state_layer_weights"]
    if "obj_proj_dense.weight" in sd:
        out["obj_proj_in.0.weight"] = sd["obj_proj_dense.weight"]
        out.update(_ln(sd, "obj_proj_in.2", "obj_proj_ln"))
    proj = {k[len("prompt2token_proj."):]: v for k, v in sd.items()
            if k.startswith("prompt2token_proj.")}
    n_layers = len({k.split(".")[0] for k in proj if k.startswith("layers_")})
    out.update(hf_clip_text_state_dict(proj, n_layers, prefix=PROJ_PREFIX))
    return out
