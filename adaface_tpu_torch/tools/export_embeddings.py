"""Export subject embeddings to the reference's `.pt` format (counterpart of
`scripts/export_embeddings.py`):

    python -m adaface_tpu_torch.tools.export_embeddings embeddings_gs-4500.npz --out ref.pt
    python -m adaface_tpu_torch.tools.export_embeddings subj_basis_gs-9.pt --zs --out zs.pt

- static: a native `.npz` to the plain-tensor variant of the reference's
  `embeddings_gs-*.pt`: `string_to_token`, `string_to_static_embedder` (a
  ParameterDict of each placeholder's computed [16, K, D] embeddings, not
  its embedder's parameters), `token2num_vectors`, `background_strings`,
  `use_conv_attn_kernel_size` (None at 0 or below) and
  `emb_global_scale_scores` in placeholder order.
- `--zs`: the port's zero-shot checkpoint (`subj_basis_<tag>.pt`,
  `training/zs_trainer.py`) to state dicts in the reference's names under
  `string_to_subj_basis_generator_state_dicts` (`interop/subj_basis.py`),
  with `placeholder_strings`, `background_strings` (the generators with a
  `bg_proj_dense`), `global_step` and `do_zero_shot`. JAX's `--zs` reads
  its own `subj_basis_*.pkl`; the output layout is the same.

Host only: no card is used.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import torch


def export(npz_path: str, out_path: str) -> dict:
    from adaface_tpu_torch.personalization.embedding_manager import EmbeddingManager
    from adaface_tpu_torch.personalization.static_embedding import compute_static_embedding

    mgr = EmbeddingManager.load_native(npz_path)
    string_to_token, string_to_emb, token2num_vectors, bg_strings = {}, {}, {}, []
    for s, info in mgr.placeholders.items():
        string_to_token[s] = torch.tensor(info.token_id)
        emb = compute_static_embedding(mgr.embedders[s]).detach().cpu()
        string_to_emb[s] = torch.nn.Parameter(emb, requires_grad=False)
        token2num_vectors[s] = info.num_vectors
        if info.is_background:
            bg_strings.append(s)
    ckpt = {
        "string_to_token": string_to_token,
        "string_to_static_embedder": torch.nn.ParameterDict(string_to_emb),
        "token2num_vectors": token2num_vectors,
        "background_strings": bg_strings,
        "use_conv_attn_kernel_size": (mgr.use_conv_attn_kernel_size
                                      if mgr.use_conv_attn_kernel_size > 0 else None),
        "emb_global_scale_scores": torch.tensor(
            [mgr.emb_global_scale_scores.get(s, 0.0) for s in mgr.placeholders]),
    }
    torch.save(ckpt, out_path)
    print(f"exported {len(string_to_token)} placeholders -> {out_path}")
    return ckpt


def export_zs(ckpt_path: str, out_path: str) -> dict:
    """The generators of a `ZeroShotTrainer.save_checkpoint` file (the
    port's own `torch.save` of state dicts, read with `weights_only`) in the
    reference's names."""
    from adaface_tpu_torch.interop.subj_basis import export_subj_basis_generator

    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    gens = ckpt["generators"]
    state_dicts = {}
    for name, sd in gens.items():
        is_bg = "bg_proj_dense.weight" in sd
        state_dicts[name] = {k: v.detach().cpu().clone() for k, v in
                             export_subj_basis_generator(sd, placeholder_is_bg=is_bg).items()}
    out = {
        "string_to_subj_basis_generator_state_dicts": state_dicts,
        "placeholder_strings": list(gens),
        "background_strings": [n for n, sd in gens.items() if "bg_proj_dense.weight" in sd],
        "global_step": int(ckpt.get("global_step", 0)),
        "do_zero_shot": True,
    }
    torch.save(out, out_path)
    print(f"exported {len(state_dicts)} subj-basis generators -> {out_path}")
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("input")
    p.add_argument("--out", required=True)
    p.add_argument("--zs", action="store_true",
                   help="input is a ZeroShotTrainer subj_basis_*.pt")
    a = p.parse_args(argv)
    (export_zs if a.zs else export)(a.input, a.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
