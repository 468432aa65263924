"""Zero-shot stack sanity harness (counterpart of `scripts/zero_shot_test.py`):

    python -m adaface_tpu_torch.tools.zero_shot_test --ref_images a.png b.png \\
        --ckpt sd-v1-5.ckpt [--apply_arc2face_embs | --apply_arc2face_inverse_embs]

It runs the zero-shot conditioning path alone: reference images -> masked
CLIP features and face identity -> the Arc2Face forward -> a
`SubjBasisGenerator` -> personalised generation, and prints the tensors'
statistics at each stage (the clip features' std, the id embedding's norm,
the context's std). Three arms: the personalised prompt (the default; the
prompt's subject gets "a <cls_delta>" inserted before it and is padded to
16 vectors), the raw Arc2Face forward embeddings as the context
(`--apply_arc2face_embs`), or the CLIP-encoded Arc2Face inverse embeddings
(`--apply_arc2face_inverse_embs`, which needs a 77-token variant).

The vision tower (ViT-L/14; `--tiny`: a 48-wide one), the Arc2Face text
encoder (ViT-L/14 text; `--tiny`: two layers) and the fg generator (K 16)
have seeded weights (`pipeline.build_random`'s law, seeds 3, 4, 5, as JAX
draws them from PRNGKey(3/4/5): same roles, other numbers), drawn on the
CPU and then moved, so that every device gets the same numbers. The
backbone is `txt2img.build_pipeline`'s (`--ckpt`, else random). Faces come
from `face_app.default_face_app` (the IResNet-100 of `ARCFACE_ONNX`, else a
random recognizer). Reference images load through `data/png.py` (PIL only
for other formats); samples are written as `<out>/{i:05}.png` (JAX writes
JPEGs). It runs on the CUDA card; `--device cpu` (or `main(...,
device="cpu")`) runs it on the CPU. `build_models` and `run` are split so
that callers can hand in weights of their own.
"""

from __future__ import annotations

import argparse
import os
import re
import sys
from typing import Optional, Sequence

import torch


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ref_images", nargs="+", required=True)
    p.add_argument("--subject_string", default="z")
    p.add_argument("--prompt", default=None,
                   help="custom prompt holding the subject string (cls-delta insertion and "
                        "vector padding applied)")
    p.add_argument("--zs_cls_delta_string", default="person")
    p.add_argument("--zs_extra_words_scale", type=float, default=0.5)
    p.add_argument("--zs_out_id_embs_scale", type=float, default=1.0)
    p.add_argument("--apply_arc2face_embs", action="store_true",
                   help="condition on the raw Arc2Face forward embeddings")
    p.add_argument("--apply_arc2face_inverse_embs", action="store_true",
                   help="condition on the CLIP-encoded inverse embeddings")
    p.add_argument("--zs_arc2face_inverse_prompt_embs_inf_type", default="full_half_pad",
                   choices=["full_zeroed_extra", "full", "full_half_pad", "full_pad",
                            "b_core_e"])
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--n_samples", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--embedding_paths", nargs="*", default=[])
    p.add_argument("--num_vectors_per_subj_token", type=int, default=16)
    p.add_argument("--out", dest="outdir", default="outputs/zero_shot")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card)")
    return p.parse_args(argv)


def model_builds(opt, tok, D: int) -> dict:
    """name -> constructor of the vision tower, the Arc2Face encoder and the
    fg generator at the options' widths."""
    from adaface_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
    from adaface_tpu_torch.models.clip_vision import CLIPVisionConfig, CLIPVisionEncoder
    from adaface_tpu_torch.personalization.embedding_manager import NUM_CA_LAYERS
    from adaface_tpu_torch.personalization.subj_basis_generator import SubjBasisGenerator

    vis_cfg = CLIPVisionConfig.tiny(hidden_size=48) if opt.tiny else CLIPVisionConfig.vit_l_14()
    txt_cfg = (CLIPTextConfig.tiny(vocab_size=tok.vocab_size, hidden_size=D, num_layers=2,
                                   max_position_embeddings=77)
               if opt.tiny else CLIPTextConfig.vit_l_14())
    return {
        "vision": lambda: CLIPVisionEncoder(vis_cfg),
        "arc2face": lambda: CLIPTextEncoder(txt_cfg),
        "generator": lambda: SubjBasisGenerator(
            placeholder_is_bg=False, num_out_layers=NUM_CA_LAYERS, num_out_embs_per_layer=16,
            output_dim=D, proj_cfg=txt_cfg, pad_token_id=tok.eos_id,
            zs_extra_words_scale=opt.zs_extra_words_scale),
    }


def build_models(opt, device=None, pipeline=None) -> dict:
    """The harness's models: `pipe` and `tok` (`txt2img.build_pipeline`, or
    `pipeline` = (pipe, tok) when given), and the seeded `vision`,
    `arc2face` and `generator` (seeds 3, 4, 5 drawn on the CPU, in fp32),
    on the pipeline's device."""
    from adaface_tpu_torch.pipeline import build_random
    from adaface_tpu_torch.txt2img import build_pipeline

    pipe, tok = pipeline if pipeline is not None else build_pipeline(opt, device)
    builds = model_builds(opt, tok, pipe.clip.cfg.hidden_size)
    models = {name: build_random(builds[name], seed, "cpu").to(pipe.device)
              for name, seed in (("vision", 3), ("arc2face", 4), ("generator", 5))}
    return dict(pipe=pipe, tok=tok, **models)


def zero_shot_prompt(opt) -> str:
    """The arms' prompt: `--prompt` with "a <cls_delta>" inserted before the
    subject and the subject padded to 16 vectors, or the default
    "a photo of a z , , ... person"."""
    from adaface_tpu_torch.txt2img import pad_placeholders

    if not opt.prompt:
        return f"a photo of a {opt.subject_string} " + ", " * 15 + opt.zs_cls_delta_string
    prompt = opt.prompt
    if opt.zs_cls_delta_string:
        prompt = re.sub(" " + re.escape(opt.subject_string) + r"(, )*",
                        " a " + opt.zs_cls_delta_string + r"\g<0> ", prompt)
    return pad_placeholders(prompt, opt.subject_string, 16)


def run(opt, models: dict, face_embed_fn) -> dict:
    """The harness on `models` (`build_models`'s) with faces from
    `face_embed_fn` (image -> normed embedding or None). Prints the stages'
    statistics and writes the samples; returns the statistics (`clip_std`,
    `id_norm`, `faceless`, `context_std`, `context_shape`) and `images`."""
    import numpy as np

    from adaface_tpu_torch.data import png
    from adaface_tpu_torch.personalization.arc2face import (
        FORWARD_TEMPLATE, INVERSE_TEMPLATE, forward_face_embs, make_template_ids)
    from adaface_tpu_torch.personalization.zero_shot import ZeroShotFeatureExtractor

    pipe, tok = models["pipe"], models["tok"]
    ex = ZeroShotFeatureExtractor(models["vision"], face_embed_fn=face_embed_fn)
    imgs = [png.load_image(p, "RGB") for p in opt.ref_images]
    with torch.inference_mode():
        feats = ex.encode(imgs, None, is_face=True, calc_avg=True)
    clip = feats.clip_features.float()
    ids = feats.id_embs.float()
    stats = dict(clip_std=float(clip.std(correction=0)), id_norm=float(torch.linalg.norm(ids)),
                 faceless=feats.faceless_img_count)
    print(f"clip features: {tuple(clip.shape)} std={stats['clip_std']:.4f}; "
          f"id emb: {tuple(ids.shape)} norm={stats['id_norm']:.4f}; "
          f"faceless={feats.faceless_img_count}", flush=True)

    inv_ids = make_template_ids(tok, INVERSE_TEMPLATE)
    fwd_ids = make_template_ids(tok, FORWARD_TEMPLATE)
    id_token = int(tok.encode("id")[0])
    mgr = pipe.embedding_manager
    mgr.add_zero_shot_placeholder(opt.subject_string, tok.add_placeholder(opt.subject_string),
                                  models["generator"], num_vectors=16)
    mgr.arc2face_encoder = models["arc2face"]
    pipe.set_zero_shot_features(feats, fwd_ids, inv_ids, id_token,
                                out_id_embs_scale=opt.zs_out_id_embs_scale,
                                inf_emb_type=opt.zs_arc2face_inverse_prompt_embs_inf_type)
    prompt = zero_shot_prompt(opt)

    context = None
    with torch.inference_mode():
        if opt.apply_arc2face_embs:
            # the raw Arc2Face forward embeddings drive the UNet, one context
            # for all 16 cross-attention layers
            shown, _ = forward_face_embs(models["arc2face"], feats.id_embs, fwd_ids, id_token)
            context, what = shown[None, :1], "arc2face forward context"
        elif opt.apply_arc2face_inverse_embs:
            _, inv = mgr.compute_zero_shot_embeddings(
                feats, inv_ids, forward_template_ids=fwd_ids, arcface_token_id=id_token,
                out_id_embs_scale=opt.zs_out_id_embs_scale,
                inf_emb_type=opt.zs_arc2face_inverse_prompt_embs_inf_type)
            if inv.shape[1] != 77:
                raise SystemExit(
                    f"--apply_arc2face_inverse_embs needs a full-width inverse context (77 "
                    f"tokens); inf type {opt.zs_arc2face_inverse_prompt_embs_inf_type!r} "
                    f"produced {inv.shape[1]} rows: use a full* variant")
            shown, context, what = inv, inv[None, :1], "arc2face inverse context"
        else:
            shown, what = pipe.encode_prompts([prompt]), "personalized context"
        shown = shown.float()
    stats["context_std"] = float(shown.std(correction=0))
    stats["context_shape"] = tuple(shown.shape)
    print(f"{what}: {stats['context_shape']} std={stats['context_std']:.4f}", flush=True)
    out = pipe.generate([prompt] * opt.n_samples, num_steps=opt.steps, height=opt.size,
                        width=opt.size, seed=opt.seed, context=context)
    os.makedirs(opt.outdir, exist_ok=True)
    for i, im in enumerate(out):
        png.write(os.path.join(opt.outdir, f"{i:05}.png"), im)
    print(f"wrote {len(out)} zero-shot samples to {opt.outdir}", flush=True)
    stats["images"] = np.asarray(out)
    return stats


def main(argv: Optional[Sequence[str]] = None, *, device=None) -> int:
    """Run the harness. `argv` defaults to the command line; `device`
    overrides `--device`."""
    from adaface_tpu_torch.face_app import default_face_app

    opt = parse_args(argv)
    models = build_models(opt, device if device is not None else opt.device)
    run(opt, models, default_face_app(models["pipe"].device).embed_image)
    return 0


if __name__ == "__main__":
    sys.exit(main())
