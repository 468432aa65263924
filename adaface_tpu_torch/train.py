"""Subject personalization training CLI of the port (counterpart of the
per-subject path of `scripts/train.py`):

    python -m adaface_tpu_torch.train --base configs/finetune-ti.yaml \\
        --data_root <subject image folder> [--bf16] [a.b=c ...]

It builds the dataset and the backbone on the card (an SD v1.x checkpoint
with `--actual_resume`, `.ckpt` or `.safetensors`; else random weights at the
SD v1.5 widths, or `--tiny`; with `--tiny` a checkpoint is read at the tiny
widths), registers the subject (and background) placeholders
initialized from the CLIP token embeddings of their init words, applies the
YAML `model_options` to the UNet, and runs the port's `Trainer`
(iteration-plan machine, Prodigy or AdamW behind clipping and accumulation,
checkpoints every `ckpt_every_steps`, SIGUSR1 checkpoint, `--resume`,
`--perturb_ratio`), then saves the resumable state. `--arc2face_unet` (a
diffusers UNet file or directory) with `--arc2face_text_encoder` (an HF
CLIPTextModel file or directory) loads the Arc2Face teacher
(`training/arc2face_teacher.py`, on the card in the run's dtype; under
`--tiny` on the tiny UNet's config) and turns the plan's Arc2Face
iterations into distillation iterations. `--val_every N` (or the file's
`trainer.val_every_steps`) runs a validation pass every N steps. With
`data.wds_shards`, the trainer composites the subject over the shards'
backgrounds; when the bg placeholder, the webdataset bg placeholder
(`--wds_background_string`, default `w`) and shards are all set, that
placeholder is registered too (initialized like the bg one, from seed + 3).

`--dreambooth --reg_data_root <class images>` runs the DreamBooth baseline
(`configs/finetune-db.yaml`) instead of the trainer: one (subject, class)
image pair a step, subject recon plus `--db_reg_weight` x the class recon,
and `embeddings_last.npz` at the end. It reads the options as the JAX
script's DreamBooth loop does, which is a trap kept on purpose: the
optimizer is clip 0.5 then AdamW at `--lr` (the file's `learning_rate` is not
read, so `finetune-db.yaml` trains at the default 7e-4), `db_reg_weight`
comes from the flag (the file's `dreambooth.db_reg_weight` is never read),
and a step takes one pair whatever `batch_size` says; timesteps and noise
come from a numpy RNG seeded with `--seed`, one Dirichlet skip-weight draw a
step (under `--randomize_clip_skip_weights`) serves both halves.

Precedence is the JAX script's: an explicit `--flag` beats the config file,
which beats the argparse default. Its quirks are kept: only `--` flags count
as explicit (`-l dir` does not); `--lr` at its default value loses to the
file's `learning_rate`, which `float()` converts (YAML 1.1 reads `1e-4` as
a string); with the option at `prodigy`, even explicitly, the file's
`use_prodigy` decides; the file's `model.params.dtype: bfloat16` turns on
`--bf16`; other file values pass through as YAML gives them.

`--embedding_manager_ckpt` warm-starts the embedders from the port's `.npz`
or a reference `.pt` (`EmbeddingManager.load_reference_checkpoint`).

`--zeroshot` trains the zero-shot SubjBasisGenerators instead
(`training/zs_trainer.ZeroShotTrainer`) over the subjects: a fg generator (K
16, its prompt2token projection on the Arc2Face encoder's config) and a bg
generator per bg placeholder (the webdataset one too, when shards are set),
fed by the masked CLIP vision tower (`CLIP_VISION_PT`, an HF
CLIPVisionModel state dict at ViT-L/14; a tiny random tower without it or
under `--tiny`), the Arc2Face text encoder (`--arc2face_text_encoder`; tiny
random likewise) and the face embedder of `face_app.default_face_app()`
(`ARCFACE_ONNX`). The towers, the encoder and the generators stay fp32
whatever `--bf16` says. A reference `.pt` `--embedding_manager_ckpt` warm
starts the generators; `--resume` takes a `subj_basis_*.pt`;
`--arc2face_unet` adds the teacher; the run ends with
`subj_basis_last.pt`.

`--num_devices N` (N > 1; -1: every card, 1 on the CPU) trains
data-parallel on N ranks (`parallel/mesh.py`): started here (`launch`, one
card each, NCCL) unless the process is already a rank of a group (a
`torchrun` start); more ranks than cards exit naming the card count, as
JAX's `make_mesh` fails with fewer devices. `--device cpu --num_devices N`
runs N gloo ranks on the CPU. `batch_size` is per device; rank 0 writes
the logs and checkpoints; `main` returns rank 0's code. `--dreambooth`
runs one (train, reg) pair a rank. PNG images load through the port's own codec (`data/png.py`),
JPEGs through its own decoder (`data/jpeg.py`), other formats through PIL;
`main(dataset=...)` takes a dataset built otherwise.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from adaface_tpu_torch.config import apply_dotlist, load_config
from adaface_tpu_torch.data.personalized import PersonalizedDataset, SubjectSpec
from adaface_tpu_torch.data.tokenizer import HashTokenizer
from adaface_tpu_torch.device import resolve_device
from adaface_tpu_torch.parallel import mesh as pmesh
from adaface_tpu_torch.models.clip_text import CLIPTextConfig
from adaface_tpu_torch.models.unet import UNetConfig, UNetModel
from adaface_tpu_torch.models.vae import SD_VAE_SCALE_FACTOR, VAEConfig
from adaface_tpu_torch.ops.grad import perturb_params
from adaface_tpu_torch.personalization.embedding_manager import EmbeddingManager
from adaface_tpu_torch.personalization.static_embedding import embedder_leaves
from adaface_tpu_torch.pipeline import StableDiffusionPipeline
from adaface_tpu_torch.training.adamw import AdamW
from adaface_tpu_torch.training.arc2face_teacher import load_arc2face_teacher
from adaface_tpu_torch.training.iter_plan import IterPlanConfig
from adaface_tpu_torch.training.prodigy import AccumulatedClipped
from adaface_tpu_torch.training.train_step import (
    DreamBoothBatch,
    ReconBatch,
    make_dreambooth_train_step,
)
from adaface_tpu_torch.training.trainer import Trainer, TrainerConfig

# --matmul_prec: torch's names, and the JAX script's (which maps torch's
# to JAX precisions), to torch's
MATMUL_PRECISIONS = {"highest": "highest", "float32": "highest", "high": "high",
                     "tensorfloat32": "high", "medium": "medium", "bfloat16": "medium"}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--base", nargs="*", default=[], help="YAML config(s)")
    p.add_argument("--data_root", type=str, required=True,
                   help="subject image folder (one subject) or parent of "
                        "per-subject folders with --subjects")
    p.add_argument("--subjects", nargs="*", default=None)
    p.add_argument("--actual_resume", type=str, default=None,
                   help="SD v1.x backbone checkpoint (.ckpt or .safetensors)")
    p.add_argument("--subject_string", type=str, default="z")
    p.add_argument("--background_string", type=str, default="y")
    p.add_argument("--wds_background_string", type=str, default="w",
                   help="dedicated bg placeholder of webdataset composites (registered only "
                        "when webdataset shards are configured)")
    p.add_argument("--cls_delta_string", type=str, default="person")
    p.add_argument("--num_vectors_per_subj_token", type=int, default=9)
    p.add_argument("--num_vectors_per_bg_token", type=int, default=4)
    p.add_argument("--subj_init_word_weights", nargs="*", type=float, default=None,
                   help="per-token weights of the cls_delta_string init words")
    p.add_argument("--bg_init_string", type=str, default="unknown",
                   help="words initializing the background embedder")
    p.add_argument("--layerwise_lora_rank", type=int, default=10,
                   help="static embedder basis rank")
    p.add_argument("--clip_last_layers_skip_weights", nargs="+", type=float, default=None,
                   help="relative weights of CLIP's last hidden layers (default [1, 1])")
    p.add_argument("--randomize_clip_skip_weights", action="store_true",
                   help="resample the skip weights per iteration from Dirichlet(weights)")
    p.add_argument("--template_set", choices=("object", "style"), default="object",
                   help="training template bank")
    p.add_argument("--common_placeholder_prefix", type=str, default=None,
                   help="comma-separated prefixes sampled per example and prepended to "
                        "subject and class strings")
    p.add_argument("--matmul_prec", type=str, default=None,
                   help="fp32 matmul precision: highest/high/medium, or the JAX names "
                        "float32/tensorfloat32/bfloat16")
    p.add_argument("--embedding_manager_ckpt", type=str, default=None,
                   help="warm-start embedders from a native .npz or a reference .pt")
    p.add_argument("--max_steps", type=int, default=2000)
    p.add_argument("--batch_size", type=int, default=3)
    p.add_argument("--num_devices", type=int, default=1,
                   help="data-parallel ranks, one card each (gloo ranks on the CPU "
                        "under --device cpu); -1 = all cards")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (the default: the card) or cpu")
    p.add_argument("--accumulate_grad_batches", type=int, default=2)
    p.add_argument("--lr", type=float, default=7e-4)
    p.add_argument("--optimizer", choices=("prodigy", "adamw"), default="prodigy")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--logdir", "-l", type=str, default="logs/run")
    p.add_argument("--ckpt_every_steps", type=int, default=500)
    p.add_argument("--val_every", type=int, default=0,
                   help="a validation pass (val/ rows) every N steps; 0 disables")
    p.add_argument("--composition_regs_iter_gap", type=int, default=3)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--tiny", action="store_true", help="tiny random models")
    p.add_argument("--resume", "-r", type=str, default=None,
                   help="train_state.pt (the port's `Trainer.save_state`) to resume from")
    p.add_argument("--perturb_ratio", type=float, default=0.0,
                   help="multiplicative U(1-r, 1+r) embedder perturbation after resume")
    p.add_argument("--arc2face_unet", type=str, default=None,
                   help="Arc2Face teacher UNet (diffusers layout, file or directory)")
    p.add_argument("--arc2face_text_encoder", type=str, default=None,
                   help="Arc2Face text encoder (HF CLIPTextModel, file or directory)")
    p.add_argument("--zeroshot", action="store_true",
                   help="zero-shot generator training (ZeroShotTrainer)")
    p.add_argument("--dreambooth", action="store_true",
                   help="DreamBooth baseline: subject recon + class prior preservation")
    p.add_argument("--reg_data_root", type=str, default=None,
                   help="class regularization image folder (dreambooth)")
    p.add_argument("--db_reg_weight", type=float, default=1.0)
    p.add_argument("overrides", nargs="*", default=[], help="dotlist config overrides a.b=c")
    return p.parse_args(argv)


def num_ranks(num_devices: int, device: torch.device) -> int:
    """The data-parallel size `--num_devices` asks for: -1 is every card (1
    on the CPU). On CUDA more ranks than cards exit naming the card count."""
    n = num_devices
    if n == -1:
        n = torch.cuda.device_count() if device.type == "cuda" else 1
    if n < 1:
        raise SystemExit(f"--num_devices {num_devices}: at least 1 (or -1)")
    if device.type == "cuda" and not pmesh.in_group() and n > torch.cuda.device_count():
        raise SystemExit(f"--num_devices {n}: this machine has {torch.cuda.device_count()} "
                         "CUDA device(s), one rank a card")
    return n


def _rank_main(argv, dataset):
    """One rank of `--num_devices N`: `main` on the rank's device."""
    return main(argv, dataset=dataset, device=pmesh.rank_device())


def _rebuild_unet(unet: UNetModel, **options) -> UNetModel:
    """The UNet rebuilt with `options` replacing fields of its config, around
    the same weights."""
    w = unet.in_conv.weight
    with torch.device("meta"):
        new = UNetModel(dataclasses.replace(unet.cfg, **options))
    new = new.to_empty(device=w.device).to(w.dtype)
    new.load_state_dict(unet.state_dict(), strict=True)
    if w.device.type == "cuda":
        new = new.to(memory_format=torch.channels_last)
    return new.eval()


def main(argv: Optional[Sequence[str]] = None, *, dataset=None, device=None) -> int:
    """Train one subject. `argv` defaults to the command line; `dataset`
    replaces the one read from `--data_root`; `device` defaults to the
    card (pass "cpu" to run on the CPU)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    opt = parse_args(argv)
    dev = resolve_device(device if device is not None else opt.device)
    n_dev = num_ranks(opt.num_devices, dev)
    if n_dev > 1 and not pmesh.in_group():
        return pmesh.launch(_rank_main, n_dev, (argv, dataset), device=dev.type)[0]
    mesh = pmesh.make_mesh(n_dev) if n_dev > 1 else None
    if mesh is not None:
        dev = mesh.device
    cfg = load_config(*opt.base) if opt.base else {}
    cfg = apply_dotlist(cfg, opt.overrides)
    # precedence: explicit CLI flag > YAML config > argparse default; only
    # `--` flags count as explicit
    explicit = {a.split("=")[0].lstrip("-").replace("-", "_")
                for a in argv if a.startswith("--")}

    def cfg_opt(section: str, key: str, flag: Optional[str] = None):
        flag = flag or key
        if flag not in explicit and key in cfg.get(section, {}):
            setattr(opt, flag, cfg[section][key])

    for k in ("subject_string", "background_string", "num_vectors_per_subj_token",
              "num_vectors_per_bg_token"):
        cfg_opt("personalization", k)
    cfg_opt("data", "wds_background_string")
    cfg_opt("data", "size")
    for k in ("max_steps", "batch_size", "accumulate_grad_batches", "ckpt_every_steps"):
        cfg_opt("trainer", k)
    cfg_opt("iter_plan", "composition_regs_iter_gap")
    if "use_prodigy" in cfg.get("trainer", {}) and "optimizer" not in explicit:
        opt.optimizer = "prodigy" if cfg["trainer"]["use_prodigy"] else "adamw"
    if cfg.get("model", {}).get("params", {}).get("dtype") == "bfloat16" \
            and "bf16" not in explicit:
        opt.bf16 = True

    def dataclass_cfg(dc_cls, section: str, skip=()):
        """cfg[section]'s keys that are fields of dc_cls (lists as tuples)."""
        names = {f.name for f in dataclasses.fields(dc_cls)}
        return {k: (tuple(v) if isinstance(v, list) else v)
                for k, v in cfg.get(section, {}).items() if k in names and k not in skip}

    # dataset
    if dataset is None:
        names = opt.subjects or [os.path.basename(opt.data_root.rstrip("/"))]
        specs = [SubjectSpec(name=s,
                             folder=(os.path.join(opt.data_root, s) if opt.subjects
                                     else opt.data_root),
                             subject_string=opt.subject_string,
                             background_string=opt.background_string,
                             cls_delta_string=opt.cls_delta_string)
                 for s in names]
        dataset = PersonalizedDataset(
            specs, size=opt.size, num_vectors_per_subj_token=opt.num_vectors_per_subj_token,
            num_vectors_per_bg_token=opt.num_vectors_per_bg_token,
            common_placeholder_prefix=opt.common_placeholder_prefix,
            template_set=opt.template_set, seed=opt.seed)

    # backbone
    tok = HashTokenizer()
    dtype = torch.bfloat16 if opt.bf16 else torch.float32
    kw = {}
    if opt.tiny:
        kw = dict(clip_cfg=CLIPTextConfig.tiny(vocab_size=tok.vocab_size,
                                               max_position_embeddings=77,
                                               num_extra_tokens=8),
                  unet_cfg=UNetConfig(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                                      attention_levels=(0, 1), num_heads=4, context_dim=64,
                                      use_flash_attention=False),
                  vae_cfg=VAEConfig.tiny())
    if opt.actual_resume:
        pipe = StableDiffusionPipeline.from_sd_checkpoint(opt.actual_resume, tok, dtype=dtype,
                                                          device=dev, **kw)
        print(f"backbone loaded from {opt.actual_resume}", flush=True)
    else:
        print("NOTE: no --actual_resume checkpoint; random backbone (smoke mode)", flush=True)
        pipe = StableDiffusionPipeline.from_random(opt.seed, tok, dtype=dtype, device=dev, **kw)

    # model_options: UNetConfig fields from the YAML (use_remat, ...)
    mo = cfg.get("model_options", {})
    if mo:
        pipe.unet = _rebuild_unet(pipe.unet, **mo)

    if opt.matmul_prec:
        if opt.matmul_prec not in MATMUL_PRECISIONS:
            raise SystemExit(f"--matmul_prec {opt.matmul_prec!r}: one of "
                             f"{sorted(MATMUL_PRECISIONS)}")
        prec = MATMUL_PRECISIONS[opt.matmul_prec]
        torch.set_float32_matmul_precision(prec)
        print(f"matmul precision: {prec}")

    if opt.clip_last_layers_skip_weights:
        w = [float(x) for x in opt.clip_last_layers_skip_weights]
        pipe.skip_weights = tuple(x / sum(w) for x in w)

    # placeholders, initialized from the CLIP token embeddings of their init
    # words (weighted by --subj_init_word_weights), not randomly
    mgr = pipe.embedding_manager
    emb_dim = pipe.clip.cfg.hidden_size
    table = pipe.clip.token_embedding.weight.detach().float().cpu().numpy()

    def word_init(words: str, weights=None) -> dict:
        tids = [t for t in tok.encode(words) if 0 <= t < table.shape[0]]
        if not tids:
            return {}
        if len(tids) > opt.layerwise_lora_rank:
            raise SystemExit(
                f"{words!r} tokenizes to {len(tids)} init tokens but --layerwise_lora_rank "
                f"is {opt.layerwise_lora_rank}; the rank must be >= the init-token count")
        kw = dict(init_vecs=table[np.asarray(tids)])
        if weights:
            if len(weights) != len(tids):
                raise SystemExit(f"--subj_init_word_weights: {len(weights)} weights for "
                                 f"{len(tids)} init tokens of {words!r}")
            w = np.asarray(weights, np.float32)
            kw["init_vec_weights"] = w / w.sum()
        return kw

    def generator(offset: int) -> torch.Generator:
        return torch.Generator(device=dev).manual_seed(opt.seed + offset)

    if not opt.zeroshot:  # zero-shot placeholders are generator-backed
        mgr.add_placeholder(
            opt.subject_string, token_id=tok.add_placeholder(opt.subject_string),
            num_vectors=opt.num_vectors_per_subj_token, generator=generator(1), emb_dim=emb_dim,
            rank=opt.layerwise_lora_rank, device=dev,
            **word_init(opt.cls_delta_string, opt.subj_init_word_weights))
    bg_strings = []
    if opt.background_string and not opt.zeroshot:
        bg_strings.append((opt.background_string, 2))
        if opt.wds_background_string and cfg.get("data", {}).get("wds_shards"):
            # the webdataset backgrounds' own embedder: wds captions swap the
            # ordinary bg token for it
            bg_strings.append((opt.wds_background_string, 3))
    for string, offset in bg_strings:
        mgr.add_placeholder(string, token_id=tok.add_placeholder(string),
                            num_vectors=opt.num_vectors_per_bg_token, is_background=True,
                            generator=generator(offset), emb_dim=emb_dim,
                            rank=opt.layerwise_lora_rank, device=dev,
                            **word_init(opt.bg_init_string))
    if opt.zeroshot:
        pass  # run_zero_shot warm-starts the generators
    elif opt.embedding_manager_ckpt and opt.embedding_manager_ckpt.endswith(".npz"):
        loaded = EmbeddingManager.load_native(opt.embedding_manager_ckpt, device=dev)
        for s, info in loaded.placeholders.items():
            info.token_id = tok.add_placeholder(s)
            mgr.placeholders[s] = info
            mgr.embedders[s] = loaded.embedders[s]
            mgr.emb_global_scale_scores.setdefault(s, loaded.emb_global_scale_scores.get(s, 0.0))
    elif opt.embedding_manager_ckpt:
        mgr.load_reference_checkpoint(opt.embedding_manager_ckpt,
                                      token_id_resolver=tok.add_placeholder, device=dev)
    if opt.embedding_manager_ckpt and not opt.zeroshot:
        print(f"warm-started embedding manager from {opt.embedding_manager_ckpt}")

    cli_handled = {"max_steps", "batch_size", "accumulate_grad_batches", "ckpt_every_steps",
                   "use_prodigy", "learning_rate", "seed", "logdir",
                   "randomize_clip_skip_weights", "clip_skip_weights_alpha",
                   "wds_background_string", "num_devices", "val_every_steps"}
    # the file's learning_rate / use_prodigy win when the flag is at its
    # default (for --optimizer: whenever it is prodigy)
    file_trainer = cfg.get("trainer", {})
    lr = opt.lr
    if opt.lr == 7e-4 and "learning_rate" in file_trainer:
        lr = float(file_trainer["learning_rate"])
    use_prodigy = opt.optimizer == "prodigy"
    if opt.optimizer == "prodigy" and "use_prodigy" in file_trainer:
        use_prodigy = bool(file_trainer["use_prodigy"])
    tcfg = TrainerConfig(
        **dataclass_cfg(TrainerConfig, "trainer", skip=cli_handled),
        **dataclass_cfg(TrainerConfig, "data", skip=cli_handled),
        max_steps=opt.max_steps, batch_size=opt.batch_size, num_devices=n_dev,
        accumulate_grad_batches=opt.accumulate_grad_batches,
        learning_rate=lr, use_prodigy=use_prodigy,
        ckpt_every_steps=opt.ckpt_every_steps, seed=opt.seed,
        val_every_steps=(opt.val_every if opt.val_every
                         else int(file_trainer.get("val_every_steps", 0))),
        logdir=opt.logdir,
        randomize_clip_skip_weights=opt.randomize_clip_skip_weights,
        wds_background_string=opt.wds_background_string or "",
        clip_skip_weights_alpha=tuple(
            float(x) for x in (opt.clip_last_layers_skip_weights or (1, 1))))
    pcfg = IterPlanConfig(
        **dataclass_cfg(IterPlanConfig, "iter_plan",
                        skip={"composition_regs_iter_gap", "max_steps"}),
        composition_regs_iter_gap=opt.composition_regs_iter_gap, max_steps=opt.max_steps)
    if opt.zeroshot:
        return run_zero_shot(opt, pipe, tok, dataset, tcfg, pcfg, dtype, dev,
                             wds=bool(cfg.get("data", {}).get("wds_shards")))
    if opt.dreambooth:
        return run_dreambooth(opt, pipe, mesh)
    trainer = Trainer(pipe, dataset, tcfg, pcfg)
    try:
        if opt.resume:
            trainer.load_state(opt.resume)
        if opt.perturb_ratio > 0:
            perturb_params(generator(9), trainer.mgr.embedders, opt.perturb_ratio)
            print(f"perturbed embedder params by U(1±{opt.perturb_ratio})")
        teacher = None
        if opt.arc2face_unet:
            if not opt.arc2face_text_encoder:
                raise SystemExit("--arc2face_unet requires --arc2face_text_encoder")
            teacher = load_arc2face_teacher(
                opt.arc2face_unet, opt.arc2face_text_encoder, tok, dtype=dtype,
                unet_cfg=pipe.unet.cfg if opt.tiny else None, device=dev).as_tuple()
            print(f"arc2face teacher loaded from {opt.arc2face_unet}")
        trainer.fit(arc2face_teacher=teacher)
        trainer.save_state()
    finally:
        trainer.close()
    return 0


def _zero_shot_towers(opt, tok, hidden: int, dev: torch.device):
    """(vision tower, Arc2Face text encoder), fp32: from `CLIP_VISION_PT`
    (ViT-L/14) and `--arc2face_text_encoder` where given and not `--tiny`,
    else tiny random ones from seed + 3 and seed + 4."""
    from adaface_tpu_torch.interop.checkpoint_io import find_weights_file, load_state_dict_file
    from adaface_tpu_torch.interop.hf_clip import (
        HF_TEXT_FILES, map_clip_text_state_dict, map_clip_vision_state_dict,
        text_config_from_state_dict)
    from adaface_tpu_torch.interop.torch_pickle import load_sd_state_dict
    from adaface_tpu_torch.models.clip_text import CLIPTextEncoder
    from adaface_tpu_torch.models.clip_vision import CLIPVisionConfig, CLIPVisionEncoder
    from adaface_tpu_torch.pipeline import build_loaded, build_random

    vis_ckpt = os.environ.get("CLIP_VISION_PT")
    if opt.tiny or not (vis_ckpt and os.path.exists(vis_ckpt)):
        if not opt.tiny:
            print("NOTE: no CLIP_VISION_PT; random vision tower (smoke mode)")
        vis_cfg = CLIPVisionConfig.tiny(hidden_size=48)
        vision = build_random(lambda: CLIPVisionEncoder(vis_cfg), opt.seed + 3, dev)
    else:
        sd = load_sd_state_dict(vis_ckpt)
        prefix = "vision_model." if any(k.startswith("vision_model.") for k in sd) else ""
        vis_cfg = CLIPVisionConfig.vit_l_14()
        vision = build_loaded(lambda: CLIPVisionEncoder(vis_cfg),
                              map_clip_vision_state_dict(sd, vis_cfg.num_layers, prefix), dev)
        print(f"vision tower loaded from {vis_ckpt}")
    arc_path = opt.arc2face_text_encoder
    if opt.tiny or not (arc_path and os.path.exists(arc_path)):
        if not opt.tiny:
            print("NOTE: no --arc2face_text_encoder; random encoder (smoke mode)")
        arc_cfg = CLIPTextConfig.tiny(vocab_size=tok.vocab_size, hidden_size=hidden,
                                      num_layers=2, max_position_embeddings=77)
        arc = build_random(lambda: CLIPTextEncoder(arc_cfg), opt.seed + 4, dev)
    else:
        sd = load_state_dict_file(find_weights_file(arc_path, HF_TEXT_FILES))
        prefix = "text_model." if any(k.startswith("text_model.") for k in sd) else ""
        arc_cfg = text_config_from_state_dict(sd, prefix)
        arc = build_loaded(lambda: CLIPTextEncoder(arc_cfg),
                           map_clip_text_state_dict(sd, arc_cfg.num_layers, prefix), dev)
        print(f"arc2face text encoder loaded from {arc_path}")
    return vision, arc


def run_zero_shot(opt, pipe: StableDiffusionPipeline, tok, dataset, tcfg: TrainerConfig,
                  pcfg: IterPlanConfig, dtype: torch.dtype, dev: torch.device,
                  wds: bool = False) -> int:
    """Train the zero-shot generators (`ZeroShotTrainer.fit`), then write
    `subj_basis_last.pt`. The generators are made from seed + 5 (fg) and
    seed + 6 + i (the i-th bg placeholder), fp32."""
    from adaface_tpu_torch.face_app import default_face_app
    from adaface_tpu_torch.personalization.embedding_manager import NUM_CA_LAYERS
    from adaface_tpu_torch.personalization.subj_basis_generator import SubjBasisGenerator
    from adaface_tpu_torch.personalization.zero_shot import ZeroShotFeatureExtractor
    from adaface_tpu_torch.pipeline import build_random
    from adaface_tpu_torch.training.zs_trainer import ZeroShotTrainer

    D = pipe.clip.cfg.hidden_size
    vision, arc = _zero_shot_towers(opt, tok, D, dev)
    ext = ZeroShotFeatureExtractor(vision, face_embed_fn=default_face_app(device=dev).embed_image)
    mgr = pipe.embedding_manager
    gens = {opt.subject_string: build_random(lambda: SubjBasisGenerator(
        placeholder_is_bg=False, num_out_layers=NUM_CA_LAYERS, num_out_embs_per_layer=16,
        output_dim=D, proj_cfg=arc.cfg, pad_token_id=tok.eos_id), opt.seed + 5, dev)}
    mgr.add_zero_shot_placeholder(opt.subject_string, tok.add_placeholder(opt.subject_string),
                                  gens[opt.subject_string], num_vectors=16)
    bg_strings = [opt.background_string] if opt.background_string else []
    if bg_strings and opt.wds_background_string and wds:
        # the webdataset backgrounds' own generator, as the bg one
        bg_strings.append(opt.wds_background_string)
    vis_cfg = vision.cfg
    for i, bg in enumerate(bg_strings):
        gens[bg] = build_random(lambda: SubjBasisGenerator(
            placeholder_is_bg=True, num_out_layers=NUM_CA_LAYERS,
            num_out_embs_per_layer=opt.num_vectors_per_bg_token, output_dim=D,
            image_embedding_dim=vis_cfg.hidden_size, num_heads=4,
            bg_num_id_vecs=vis_cfg.num_tokens), opt.seed + 6 + i, dev)
        mgr.add_zero_shot_placeholder(bg, tok.add_placeholder(bg), gens[bg],
                                      num_vectors=opt.num_vectors_per_bg_token,
                                      is_background=True)
    if opt.embedding_manager_ckpt:
        mgr.load_reference_checkpoint(opt.embedding_manager_ckpt,
                                      token_id_resolver=tok.add_placeholder, device=dev)
        gens.update(mgr.subj_basis_generators)
        print(f"zs generators warm-started from {opt.embedding_manager_ckpt}")
    trainer = ZeroShotTrainer(pipe, dataset, ext, gens, arc, tcfg,
                              dataclasses.replace(pcfg, do_zero_shot=True),
                              bg_placeholders=frozenset(bg_strings))
    try:
        if opt.resume:
            trainer.load_checkpoint(opt.resume)
        teacher_unet = None
        if opt.arc2face_unet:
            if not opt.arc2face_text_encoder:
                raise SystemExit("--arc2face_unet requires --arc2face_text_encoder")
            teacher_unet = load_arc2face_teacher(
                opt.arc2face_unet, opt.arc2face_text_encoder, tok, dtype=dtype,
                unet_cfg=pipe.unet.cfg if opt.tiny else None, device=dev).unet
            print(f"arc2face teacher loaded from {opt.arc2face_unet}")
        trainer.fit(arc2face_teacher_unet=teacher_unet)
    finally:
        trainer.close()
    return 0


def dreambooth_batch(pipe: StableDiffusionPipeline, train: list, reg: list, rng,
                     skip_weights: Optional[torch.Tensor] = None, mesh=None) -> DreamBoothBatch:
    """The (train, reg) batch of a DreamBooth step from drawn examples: each
    half's images VAE-encoded (the posterior mean times the scale factor),
    its captions tokenized, then its timesteps and noise drawn from `rng`
    (train first); both halves carry `skip_weights`. Under a dp `mesh` each
    rank encodes its own rows and the latents are gathered."""

    def half(examples) -> ReconBatch:
        images = np.stack([e["image"] for e in examples])
        idx = None if mesh is None else mesh.local_rows(len(images))
        with torch.no_grad():
            mean, _ = pipe.vae.encode(torch.as_tensor(images if idx is None else images[idx],
                                                      dtype=torch.float32, device=pipe.device))
        latents = mean * SD_VAE_SCALE_FACTOR
        if idx is not None:
            latents = mesh.gather_rows(latents, len(images))
        ids = pipe.tokenizer([e["caption"] for e in examples])
        t = rng.integers(0, 1000, len(examples))
        noise = rng.standard_normal(tuple(latents.shape))
        return ReconBatch(
            latents=latents, token_ids=ids,
            slot_maps=pipe.embedding_manager.build_slot_maps(ids), fg_mask=None,
            timesteps=torch.as_tensor(t, dtype=torch.int32, device=pipe.device),
            noise=torch.as_tensor(noise, dtype=torch.float32, device=pipe.device),
            skip_weights=skip_weights)

    return DreamBoothBatch(train=half(train), reg=half(reg))


def run_dreambooth(opt, pipe: StableDiffusionPipeline, mesh=None) -> int:
    """The DreamBooth loop: `opt.max_steps` steps of one (subject, class)
    pair a device each (the dp `mesh`'s size) through
    `make_dreambooth_train_step`, clip 0.5 then AdamW at `opt.lr` (its
    moments ZeRO-1-sharded over the mesh), then `embeddings_last.npz` in the
    log dir (rank 0)."""
    from adaface_tpu_torch.data.personalized_db import DreamBoothDataset

    if not opt.reg_data_root:
        raise SystemExit("--dreambooth needs --reg_data_root")
    ds = DreamBoothDataset(opt.data_root, opt.reg_data_root, placeholder=opt.subject_string,
                           class_word=opt.cls_delta_string, size=opt.size, seed=opt.seed)
    mgr = pipe.embedding_manager
    for m in (pipe.clip, pipe.unet, pipe.vae):
        m.requires_grad_(False)
    params = [t.requires_grad_(True) for s in sorted(mgr.embedders)
              for _, t in embedder_leaves(mgr.embedders[s])]
    step = make_dreambooth_train_step(
        pipe.clip, pipe.unet, pipe.base_sched,
        AccumulatedClipped(AdamW(params, opt.lr, mesh=mesh), 0.5),
        skip_weights=pipe.skip_weights, db_reg_weight=opt.db_reg_weight, mesh=mesh)
    rng = np.random.default_rng(opt.seed)
    os.makedirs(opt.logdir, exist_ok=True)
    for i in range(opt.max_steps):
        drawn = [ds.draw_pair() for _ in range(pmesh.dp_of(mesh))]
        sw = None
        if opt.randomize_clip_skip_weights:
            alpha = [float(x) for x in (opt.clip_last_layers_skip_weights or (1, 1))]
            sw = torch.as_tensor(rng.dirichlet(alpha), dtype=torch.float32, device=pipe.device)
        batch = dreambooth_batch(pipe, [p[0] for p in drawn], [p[1] for p in drawn], rng, sw,
                                 mesh)
        m = step(mgr.embedders, pmesh.shard_train_batch(mesh, batch))
        if i % 10 == 0 and pmesh.is_main(mesh):
            print(f"[db {i}/{opt.max_steps}] loss={float(m['loss']):.4f} "
                  f"recon={float(m['recon']):.4f} reg={float(m['db_reg']):.4f}", flush=True)
    path = os.path.join(opt.logdir, "embeddings_last.npz")
    if pmesh.is_main(mesh):
        mgr.save_native(path)
        print(f"saved {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
