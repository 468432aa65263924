"""Subject personalization training CLI of the port (counterpart of the
per-subject path of `scripts/train.py`):

    python -m adaface_tpu_torch.train --base configs/finetune-ti.yaml \\
        --data_root <subject image folder> [--bf16] [a.b=c ...]

It builds the dataset and a random-weight backbone on the card (the SD v1.5
widths, or `--tiny`), registers the subject (and background) placeholders
initialized from the CLIP token embeddings of their init words, applies the
YAML `model_options` to the UNet, and runs the port's `Trainer`
(iteration-plan machine, Prodigy or AdamW behind clipping and accumulation,
checkpoints every `ckpt_every_steps`, SIGUSR1 checkpoint, `--resume`,
`--perturb_ratio`), then saves the resumable state. `--arc2face_unet` (a
diffusers UNet file or directory) with `--arc2face_text_encoder` (an HF
CLIPTextModel file or directory) loads the Arc2Face teacher
(`training/arc2face_teacher.py`, on the card in the run's dtype; under
`--tiny` on the tiny UNet's config) and turns the plan's Arc2Face
iterations into distillation iterations.

Precedence is the JAX script's: an explicit `--flag` beats the config file,
which beats the argparse default. Its quirks are kept: only `--` flags count
as explicit (`-l dir` does not); `--lr` at its default value loses to the
file's `learning_rate`, which `float()` converts (YAML 1.1 reads `1e-4` as
a string); with the option at `prodigy`, even explicitly, the file's
`use_prodigy` decides; the file's `model.params.dtype: bfloat16` turns on
`--bf16`; other file values pass through as YAML gives them.

Paths that are not ported exit with `SystemExit` naming their ROADMAP
queue 1 item: `--zeroshot` (12: it needs the face stack; the zero-shot
trainer runs through `training/zs_trainer.ZeroShotTrainer.fit`), `--dreambooth`,
`--val_every` > 0 and webdataset shards (10), `--actual_resume` and a `.pt`
`--embedding_manager_ckpt` (10b), more than one device (13). Reading image
files needs PIL; `main(dataset=...)` takes a dataset built otherwise.
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
from adaface_tpu_torch.models.clip_text import CLIPTextConfig
from adaface_tpu_torch.models.unet import UNetConfig, UNetModel
from adaface_tpu_torch.models.vae import VAEConfig
from adaface_tpu_torch.ops.grad import perturb_params
from adaface_tpu_torch.personalization.embedding_manager import EmbeddingManager
from adaface_tpu_torch.pipeline import StableDiffusionPipeline
from adaface_tpu_torch.training.arc2face_teacher import load_arc2face_teacher
from adaface_tpu_torch.training.iter_plan import IterPlanConfig
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
                   help="SD v1.x backbone checkpoint (not ported: random weights only)")
    p.add_argument("--subject_string", type=str, default="z")
    p.add_argument("--background_string", type=str, default="y")
    p.add_argument("--wds_background_string", type=str, default="w",
                   help="dedicated bg placeholder of webdataset composites (not ported)")
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
                   help="warm-start embedders from a native .npz checkpoint")
    p.add_argument("--max_steps", type=int, default=2000)
    p.add_argument("--batch_size", type=int, default=3)
    p.add_argument("--num_devices", type=int, default=1,
                   help="data-parallel size (one card only in the port); -1 = all cards")
    p.add_argument("--accumulate_grad_batches", type=int, default=2)
    p.add_argument("--lr", type=float, default=7e-4)
    p.add_argument("--optimizer", choices=("prodigy", "adamw"), default="prodigy")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--logdir", "-l", type=str, default="logs/run")
    p.add_argument("--ckpt_every_steps", type=int, default=500)
    p.add_argument("--val_every", type=int, default=0,
                   help="validation every N steps (not ported; 0 disables)")
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
                   help="zero-shot generator training (not ported: needs the face stack)")
    p.add_argument("--dreambooth", action="store_true",
                   help="DreamBooth baseline (not ported)")
    p.add_argument("--reg_data_root", type=str, default=None,
                   help="class regularization image folder (dreambooth)")
    p.add_argument("--db_reg_weight", type=float, default=1.0)
    p.add_argument("overrides", nargs="*", default=[], help="dotlist config overrides a.b=c")
    return p.parse_args(argv)


def _refuse_unported(opt, cfg: dict, device: torch.device):
    """SystemExit for a path the port does not have yet, naming its ROADMAP
    queue 1 item."""
    if opt.zeroshot:
        raise SystemExit("--zeroshot: the zero-shot entry point needs the face stack "
                         "(default_face_app), which is not ported yet (ROADMAP queue 1 item "
                         "12); train with training/zs_trainer.ZeroShotTrainer.fit")
    if opt.dreambooth:
        raise SystemExit("--dreambooth: DreamBooth is not ported yet (ROADMAP queue 1 item 10)")
    if opt.actual_resume:
        raise SystemExit("--actual_resume: real-checkpoint loading is not ported yet "
                         "(ROADMAP queue 1 item 10b)")
    if opt.embedding_manager_ckpt and not opt.embedding_manager_ckpt.endswith(".npz"):
        raise SystemExit("--embedding_manager_ckpt: only the native .npz loads; reference .pt "
                         "checkpoints are ROADMAP queue 1 item 10b")
    n = opt.num_devices
    if n == -1:
        n = torch.cuda.device_count() if device.type == "cuda" else 1
    if n != 1:
        raise SystemExit(f"--num_devices {opt.num_devices}: the port trains on one card; "
                         "data parallelism is ROADMAP queue 1 item 13")
    if opt.val_every > 0 or int(cfg.get("trainer", {}).get("val_every_steps", 0)) > 0:
        raise SystemExit("--val_every / val_every_steps: validation is not ported yet "
                         "(ROADMAP queue 1 item 10)")
    if cfg.get("data", {}).get("wds_shards"):
        raise SystemExit("data.wds_shards: the webdataset compositor is not ported yet "
                         "(ROADMAP queue 1 item 10)")


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
    dev = resolve_device(device)
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
    _refuse_unported(opt, cfg, dev)

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

    # backbone: random weights (real checkpoints are not ported)
    tok = HashTokenizer()
    dtype = torch.bfloat16 if opt.bf16 else torch.float32
    print("NOTE: random backbone (smoke mode)", flush=True)
    kw = {}
    if opt.tiny:
        kw = dict(clip_cfg=CLIPTextConfig.tiny(vocab_size=tok.vocab_size,
                                               max_position_embeddings=77,
                                               num_extra_tokens=8),
                  unet_cfg=UNetConfig(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                                      attention_levels=(0, 1), num_heads=4, context_dim=64,
                                      use_flash_attention=False),
                  vae_cfg=VAEConfig.tiny())
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

    mgr.add_placeholder(opt.subject_string, token_id=tok.add_placeholder(opt.subject_string),
                        num_vectors=opt.num_vectors_per_subj_token, generator=generator(1),
                        emb_dim=emb_dim, rank=opt.layerwise_lora_rank, device=dev,
                        **word_init(opt.cls_delta_string, opt.subj_init_word_weights))
    if opt.background_string:
        mgr.add_placeholder(opt.background_string,
                            token_id=tok.add_placeholder(opt.background_string),
                            num_vectors=opt.num_vectors_per_bg_token, is_background=True,
                            generator=generator(2), emb_dim=emb_dim,
                            rank=opt.layerwise_lora_rank, device=dev,
                            **word_init(opt.bg_init_string))
    if opt.embedding_manager_ckpt:
        loaded = EmbeddingManager.load_native(opt.embedding_manager_ckpt, device=dev)
        for s, info in loaded.placeholders.items():
            info.token_id = tok.add_placeholder(s)
            mgr.placeholders[s] = info
            mgr.embedders[s] = loaded.embedders[s]
            mgr.emb_global_scale_scores.setdefault(s, loaded.emb_global_scale_scores.get(s, 0.0))
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
        max_steps=opt.max_steps, batch_size=opt.batch_size, num_devices=1,
        accumulate_grad_batches=opt.accumulate_grad_batches,
        learning_rate=lr, use_prodigy=use_prodigy,
        ckpt_every_steps=opt.ckpt_every_steps, seed=opt.seed,
        val_every_steps=0, logdir=opt.logdir,
        randomize_clip_skip_weights=opt.randomize_clip_skip_weights,
        wds_background_string=opt.wds_background_string or "",
        clip_skip_weights_alpha=tuple(
            float(x) for x in (opt.clip_last_layers_skip_weights or (1, 1))))
    pcfg = IterPlanConfig(
        **dataclass_cfg(IterPlanConfig, "iter_plan",
                        skip={"composition_regs_iter_gap", "max_steps"}),
        composition_regs_iter_gap=opt.composition_regs_iter_gap, max_steps=opt.max_steps)
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


if __name__ == "__main__":
    sys.exit(main())
