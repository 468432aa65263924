"""Subject-driven text-to-image CLI of the port (counterpart of
`scripts/txt2img.py`):

    python -m adaface_tpu_torch.txt2img --ckpt sd-v1-5.ckpt \\
        --embedding_paths embeddings_gs-4500.pt --prompt "a z person" --bf16

It loads an SD v1.x checkpoint (`--ckpt`, a `.ckpt` or `.safetensors`; random
weights without it, tiny ones with `--tiny`), the subject embeddings of
`--embedding_paths` (the port's `.npz` or a reference `.pt`, static or
zero-shot; a checkpoint's conv-attention kernel size turns conv attention
on), pads the subject token to its K vectors, samples with DDIM (annealed
CFG) or PLMS, and writes one PNG a sample and a grid. Without embeddings a
fresh K-vector placeholder is registered so that subject prompts still
tokenize. The tokenizer is CLIP's BPE when `CLIP_VOCAB_JSON` and
`CLIP_MERGES_TXT` name its files, else the hash tokenizer.

It runs on the CUDA card; `--device cpu` (or `main(..., device="cpu")`)
runs it on the CPU. Images are PNGs written by the port's own codec
(`data/png.py`), where the JAX script writes JPEGs through PIL. With
`--tiny` a `--ckpt` is read at the tiny widths (the JAX script reads it at
SD v1.5's).

`--compare_with <folder>` scores each output folder against the reference
images (`evaluation/eval_utils.compare_folders`: CLIP-I and CLIP-T with the
ViT-B/32 scorer of `CLIP_SCORER_PT`, DINO with the ViT-S/16 of
`DINO_VITS16_PT`; random tiny towers without them), takes the means and
appends a row to `<out>/scores.csv`: prompt, CLIP-I, CLIP-T, DINO.
`--calc_face_sim` adds the face similarity (the first face of each image,
embedded by a tiny random recognizer as in the JAX script), the count of
generated images without a face and their share. `--use_first_gt_img_as_init`
starts from the `--compare_with` images' latents.

`--num_devices N` / `--tp T` serve over a dp x tp mesh (JAX's rules: `-1`
is every card, `--tp T` alone means a T-device tp-only mesh, N must be a
multiple of T): N ranks, one card each (gloo ranks on the CPU under
`--device cpu`), started here unless the process is already a rank of a
group; more ranks than cards exit naming the card count. Each request's
batch is split over dp (`pipeline.use_mesh`), the UNet over tp; rank 0
alone writes the PNGs, the grid and `scores.csv`, and `main` returns its
code.
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from adaface_tpu_torch.data import png
from adaface_tpu_torch.device import resolve_device
from adaface_tpu_torch.parallel import mesh as pmesh


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--prompt", type=str, default=None,
                   help="prompt; subject placeholders like 'z' are patched")
    p.add_argument("--from_file", type=str, default=None,
                   help="TSV prompt file: n_repeat, subdir, prompt[, ...]")
    p.add_argument("--ckpt", type=str, default=None, help="SD v1.x .ckpt or .safetensors")
    p.add_argument("--embedding_paths", nargs="*", default=[],
                   help=".npz (the port's) or .pt (reference) subject embeddings")
    p.add_argument("--subject_string", type=str, default="z")
    p.add_argument("--background_string", type=str, default="y")
    p.add_argument("--num_vectors_per_subj_token", type=int, default=9)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--n_samples", type=int, default=4)
    p.add_argument("--n_repeat", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scale", type=float, nargs="+", default=[10.0, 4.0],
                   help="CFG guidance; two values anneal max -> min (DDIM)")
    p.add_argument("--neg_prompt", type=str, default=None)
    p.add_argument("--sampler", choices=("ddim", "plms"), default="ddim")
    p.add_argument("--compel_cfg_weight_level", type=float, default=0.0,
                   help="scale the cond context's offset from the empty prompt's by "
                        "1.1**level")
    p.add_argument("--out", "--outdir", dest="outdir", type=str, default="outputs/txt2img")
    p.add_argument("--compare_with", type=str, default=None,
                   help="reference image folder: score the samples against it")
    p.add_argument("--class_prompt", type=str, default=None)
    p.add_argument("--calc_face_sim", action="store_true",
                   help="add face similarity to the --compare_with scores")
    p.add_argument("--skip_save", action="store_true", help="do not save individual samples")
    p.add_argument("--n_rows", type=int, default=0,
                   help="images per grid row (0 = one row per batch, first 4 batches)")
    p.add_argument("--use_first_gt_img_as_init", action="store_true",
                   help="start from the VAE latents of the --compare_with images")
    p.add_argument("--init_img_weight", type=float, default=0.1)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--num_devices", type=int, default=1,
                   help="ranks to serve on, one card each (-1 = all cards)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks of the UNet (alone: a tp-only mesh)")
    p.add_argument("--tiny", action="store_true", help="tiny models (CPU smoke mode)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card)")
    return p.parse_args(argv)


def serving_mesh_size(opt, device: torch.device):
    """(devices, tp) of `--num_devices` / `--tp` by the JAX script's rules:
    -1 is every card (1 on the CPU), `--tp T` alone means T devices, and the
    device count must be a multiple of tp. On CUDA more ranks than cards exit
    naming the card count."""
    nd, tp = getattr(opt, "num_devices", 1), getattr(opt, "tp", 1)
    if nd == -1:
        nd = torch.cuda.device_count() if device.type == "cuda" else 1
    if nd == 1 and tp > 1:
        nd = tp
    if tp < 1 or nd < 1 or nd % tp or nd < tp:
        raise SystemExit(f"--num_devices {nd} not divisible by --tp {tp}")
    if device.type == "cuda" and not pmesh.in_group() and nd > torch.cuda.device_count():
        raise SystemExit(f"--num_devices {nd}: this machine has {torch.cuda.device_count()} "
                         "CUDA device(s), one rank a card")
    return nd, tp


def _serve_rank(entry, args, kwargs):
    """One serving rank: `entry(*args, device=<the rank's device>, **kwargs)`."""
    return entry(*args, device=pmesh.rank_device(), **kwargs)


def run_ranks(entry, opt, device, args=(), kwargs=None):
    """Rank 0's result of `entry` started on the mesh's ranks when the
    options ask for more than one device and this process is not yet a rank,
    else None (run in this process)."""
    dev = resolve_device(device if device is not None else getattr(opt, "device", None))
    nd, _ = serving_mesh_size(opt, dev)
    if nd == 1 or pmesh.in_group():
        return None
    return pmesh.launch(_serve_rank, nd, (entry, args, kwargs or {}), device=dev.type)[0]


def tiny_configs(tok) -> dict:
    """The `--tiny` model configs (the JAX scripts')."""
    from adaface_tpu_torch.models.clip_text import CLIPTextConfig
    from adaface_tpu_torch.models.unet import UNetConfig
    from adaface_tpu_torch.models.vae import VAEConfig

    return dict(clip_cfg=CLIPTextConfig.tiny(vocab_size=tok.vocab_size,
                                             max_position_embeddings=77, num_extra_tokens=8),
                unet_cfg=UNetConfig(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                                    attention_levels=(0, 1), num_heads=4, context_dim=64,
                                    use_flash_attention=False),
                vae_cfg=VAEConfig.tiny())


def build_pipeline(opt, device=None):
    """(pipeline, tokenizer) of the options: backbone, subject embeddings,
    conv attention, placeholder. `device` defaults to `opt.device`, then the
    card."""
    from adaface_tpu_torch.data.tokenizer import CLIPBPETokenizer, HashTokenizer
    from adaface_tpu_torch.personalization.embedding_manager import EmbeddingManager
    from adaface_tpu_torch.pipeline import StableDiffusionPipeline

    dev = resolve_device(device if device is not None else getattr(opt, "device", None))
    nd, tp = serving_mesh_size(opt, dev)
    vocab, merges = os.environ.get("CLIP_VOCAB_JSON"), os.environ.get("CLIP_MERGES_TXT")
    tok = (CLIPBPETokenizer(vocab, merges) if vocab and merges and os.path.exists(vocab)
           else HashTokenizer())
    dtype = torch.bfloat16 if opt.bf16 else torch.float32
    kw = tiny_configs(tok) if opt.tiny else {}
    if opt.ckpt:
        pipe = StableDiffusionPipeline.from_sd_checkpoint(opt.ckpt, tok, dtype=dtype,
                                                          device=dev, **kw)
    else:
        print("NOTE: no --ckpt given; using random weights (smoke mode)")
        pipe = StableDiffusionPipeline.from_random(0, tok, dtype=dtype, device=dev, **kw)

    mgr = pipe.embedding_manager
    for path in opt.embedding_paths:
        if path.endswith(".npz"):
            loaded = EmbeddingManager.load_native(path, device=dev)
            for s, info in loaded.placeholders.items():
                info.token_id = tok.add_placeholder(s)
                mgr.placeholders[s] = info
                mgr.embedders[s] = loaded.embedders[s]
        else:
            mgr.load_reference_checkpoint(path, token_id_resolver=tok.add_placeholder,
                                          device=dev)
    if mgr.use_conv_attn_kernel_size > 1:
        pipe.set_conv_attn_kernel_size(mgr.use_conv_attn_kernel_size)
    if not opt.embedding_paths:
        mgr.add_placeholder(opt.subject_string, token_id=tok.add_placeholder(opt.subject_string),
                            num_vectors=opt.num_vectors_per_subj_token,
                            generator=torch.Generator(device=dev).manual_seed(7),
                            emb_dim=pipe.clip.cfg.hidden_size, device=dev)
    if nd > 1:
        mesh = pipe.use_mesh(nd, dp=nd // tp, tp=tp)
        if mesh.is_main:
            print(f"serving mesh: dp{mesh.dp} x tp{mesh.tp}")
    return pipe, tok


def pad_placeholders(prompt: str, subject_string: str, k: int) -> str:
    """'a z person' -> 'a z , , ... person': the subject token followed by
    k - 1 commas, its first occurrence only."""
    if k <= 1 or subject_string not in prompt.split():
        return prompt
    return prompt.replace(subject_string, subject_string + " ," * (k - 1), 1)


def nearest_indices(n_out: int, n_in: int) -> np.ndarray:
    """Nearest sampling of n_in pixels into n_out, as PIL's NEAREST and
    `jax.image.resize(..., "nearest")` take it: floor((i + 0.5) n_in / n_out),
    in float32 (JAX's arithmetic)."""
    idx = np.floor((np.arange(n_out, dtype=np.float32) + 0.5) * n_in / n_out)
    return np.minimum(idx.astype(np.int64), n_in - 1)


def load_resized(path: str, size: int, mode: str = "RGB") -> np.ndarray:
    """uint8 pixels of an image at size x size: PNGs and JPEGs through the
    port's decoders (`png.load_image`); an image of another size is resized
    with PIL's default filter (bicubic), as the JAX scripts do, by
    `data/resample.py`'s copy of it (bit for bit; no PIL)."""
    from adaface_tpu_torch.data.resample import resize

    img = png.load_image(path, mode)
    if img.shape[:2] != (size, size):
        img = resize(img, (size, size), "bicubic")
    return img


def _gt_init_code(opt, pipe) -> np.ndarray:
    """x_T base from the `--compare_with` images: per image its VAE latent
    (mean times the scale factor; where an `<image>_mask.png` sits beside it,
    noise from np.random.default_rng(seed) outside the mask), summed over
    the images / sqrt(N), [n_samples, h, w, 4] fp32."""
    from adaface_tpu_torch.models.vae import SD_VAE_SCALE_FACTOR

    paths = sorted(os.path.join(opt.compare_with, f) for f in os.listdir(opt.compare_with)
                   if f.lower().endswith((".jpg", ".jpeg", ".png")) and "_mask" not in f)
    if not paths:
        raise SystemExit(f"no images in {opt.compare_with}")
    f = 2 ** (len(pipe.vae.cfg.ch_mult) - 1)
    lh = lw = opt.size // f
    rng = np.random.default_rng(opt.seed)
    avg = np.zeros((opt.n_samples, lh, lw, 4), np.float32)
    for path in paths:
        x = (load_resized(path, opt.size).astype(np.float32) / 127.5 - 1.0)[None]
        with torch.inference_mode():
            mean, _ = pipe.vae.encode(torch.as_tensor(x, device=pipe.device))
        z = np.broadcast_to(mean.float().cpu().numpy() * SD_VAE_SCALE_FACTOR, avg.shape)
        mask_path = os.path.splitext(path)[0] + "_mask.png"
        if os.path.exists(mask_path):
            m = png.load_image(mask_path, "L")
            m = m[nearest_indices(lh, m.shape[0])][:, nearest_indices(lw, m.shape[1])]
            m = m.astype(np.float32)[None, :, :, None] / 255.0
            z = np.where(m > 0.5, z, rng.standard_normal(avg.shape))
        avg += z
    return (avg / np.sqrt(len(paths))).astype(np.float32)


def make_grid(all_imgs, n_rows: int) -> np.ndarray:
    """`n_rows` > 0: that many images a row (the last row padded black);
    else one row per batch of the first 4 batches."""
    if n_rows > 0:
        flat = [im for batch in all_imgs for im in batch]
        rows = [np.concatenate(flat[i:i + n_rows], axis=1) for i in range(0, len(flat), n_rows)]
        w = max(r.shape[1] for r in rows)
        rows = [np.pad(r, ((0, 0), (0, w - r.shape[1]), (0, 0))) for r in rows]
        return np.concatenate(rows, axis=0)
    return np.concatenate([np.concatenate(list(batch), axis=1) for batch in all_imgs[:4]],
                          axis=0)


def main(argv: Optional[Sequence[str]] = None, *, device=None) -> int:
    """Generate as the options say. `argv` defaults to the command line;
    `device` overrides `--device`. Over several devices rank 0 writes and
    its code comes back."""
    from adaface_tpu_torch.pipeline import DEFAULT_NEGATIVE_PROMPT

    opt = parse_args(argv)
    ranks = run_ranks(main, opt, device, (list(sys.argv[1:]) if argv is None else argv,))
    if ranks is not None:
        return ranks
    pipe, _ = build_pipeline(opt, device)
    writes = pmesh.is_main(pipe.mesh)
    neg = opt.neg_prompt if opt.neg_prompt is not None else DEFAULT_NEGATIVE_PROMPT
    guidance = tuple(opt.scale) if len(opt.scale) > 1 else opt.scale[0]
    gt_avg = None
    if opt.use_first_gt_img_as_init:
        if not opt.compare_with:
            raise SystemExit("--use_first_gt_img_as_init needs --compare_with")
        gt_avg = _gt_init_code(opt, pipe)

    jobs = []  # (subdir, prompt, n_repeat)
    if opt.from_file:
        with open(opt.from_file) as f:
            for row in csv.reader(f, delimiter="\t"):
                if row:
                    jobs.append((row[1], row[2], int(row[0])))
    else:
        if not opt.prompt:
            raise SystemExit("need --prompt or --from_file")
        jobs.append(("", opt.prompt, opt.n_repeat))

    def rep_x_T(rep):
        if gt_avg is None:
            return None
        w = opt.init_img_weight
        noise = np.random.default_rng(opt.seed + rep).standard_normal(
            gt_avg.shape).astype(np.float32)
        return gt_avg * w + noise * (1.0 - w)

    os.makedirs(opt.outdir, exist_ok=True)
    all_imgs = []
    for subdir, prompt, n_rep in jobs:
        k = max((i.num_vectors for i in pipe.embedding_manager.placeholders.values()), default=1)
        prompt = pad_placeholders(prompt, opt.subject_string, k)
        outd = os.path.join(opt.outdir, subdir) if subdir else opt.outdir
        if writes:
            os.makedirs(outd, exist_ok=True)
        idx = 0
        for rep in range(n_rep):
            imgs = pipe.generate([prompt] * opt.n_samples, negative_prompt=neg,
                                 num_steps=opt.steps, guidance_scale=guidance,
                                 height=opt.size, width=opt.size, seed=opt.seed + rep,
                                 sampler=opt.sampler,
                                 compel_cfg_weight_level=opt.compel_cfg_weight_level,
                                 x_T=rep_x_T(rep))
            if not opt.skip_save:
                for im in imgs:
                    if writes:
                        png.write(os.path.join(outd, f"{idx:05}.png"), im)
                    idx += 1
            all_imgs.append(imgs)
        if writes:
            print(f"wrote {idx} images to {outd} for prompt: {prompt!r}")
    if not writes:
        return 0
    png.write(os.path.join(opt.outdir, "grid.png"), make_grid(all_imgs, opt.n_rows))
    if opt.compare_with:
        opt.scores = evaluate(opt, jobs, pipe.device)
        print("scores:", opt.scores)
    return 0


def evaluate(opt, jobs, device) -> dict:
    """Score each job's output folder against `--compare_with` (CLIP-I,
    CLIP-T against `--class_prompt` or the job's prompt, DINO), take the
    means, and with `--calc_face_sim` the mean face similarity and the
    faceless generated images; append the row to `scores.csv`."""
    from adaface_tpu_torch.evaluation.eval_utils import (
        compare_face_folders, compare_folders, list_image_files)
    from adaface_tpu_torch.evaluation.scorers import init_evaluators

    scorer, dino = init_evaluators(device=device)
    dirs = [os.path.join(opt.outdir, subdir) if subdir else opt.outdir for subdir, _, _ in jobs]
    per_dir = [compare_folders(scorer, dino, d, opt.compare_with, opt.class_prompt or prompt)
               for d, (_, prompt, _) in zip(dirs, jobs)]
    ci, ct, dn = (float(np.mean([r[k] for r in per_dir])) for k in range(3))
    res = {"clip_i": ci, "clip_t": ct, "dino": dn}
    row = [opt.class_prompt or jobs[0][1], f"{ci:.4f}", f"{ct:.4f}", f"{dn:.4f}"]
    if opt.calc_face_sim:
        from adaface_tpu_torch.face_app import FaceApp
        from adaface_tpu_torch.models.arcface import IResNet, IResNetConfig, init_iresnet_

        rec = IResNet(IResNetConfig.tiny()).to(device)
        app = FaceApp(init_iresnet_(rec, torch.Generator(device=device).manual_seed(3)))
        embed = lambda im: (lambda fs: fs[0].normed_embedding if fs else None)(app.get(im))
        sims, nf_gen, n_gen = [], 0, 0
        for d in dirs:
            sim, nf_g, _ = compare_face_folders(embed, d, opt.compare_with)
            sims.append(sim)
            nf_gen += nf_g
            n_gen += len(list_image_files(d))
        sim = float(np.mean(sims)) if sims else 0.0
        rate = nf_gen / max(n_gen, 1)
        res.update({"face_sim": sim, "face_exceptions": nf_gen, "face_exception_rate": rate})
        row += [f"{sim:.4f}", str(nf_gen), f"{rate:.4f}"]
    with open(os.path.join(opt.outdir, "scores.csv"), "a") as f:
        csv.writer(f).writerow(row)
    return res


if __name__ == "__main__":
    sys.exit(main())
