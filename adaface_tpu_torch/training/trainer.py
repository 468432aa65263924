"""Recon-only training loop (counterpart of the single-device recon path of
`adaface_tpu/training/trainer.py`).

Per step, `plan_iteration` rolls the iteration on the host; a recon plan
draws examples from `PersonalizedDataset` (one subject per instance),
VAE-encodes the images (the posterior mean times the scale factor, no
gradient), builds the `ReconBatch` (timesteps, noise, latent-resolution fg
and augmentation masks, the delta-prompt battery, embedding-noise seed) and
runs the recon step; gradient accumulation and global-norm clipping live in
the optimizer chain (`training/prodigy.py`). The host numpy RNG is consumed
in the JAX trainer's order, so one seed builds the same batches in both.
Checkpoints are the embedding manager's native `.npz` every
`ckpt_every_steps` and `last`; metrics stream to stdout and `metrics.jsonl`.

The optimizer is always Prodigy (learning rate 1, `d_coef`) behind the
clip and accumulation chain. A compositional-distillation plan raises
NotImplementedError (the next slice of the port, ROADMAP.md queue 1);
Arc2Face plans run as recon, as the JAX trainer runs them when it is given
no teacher (the port has none yet). AdamW, the data-parallel mesh, the
webdataset compositor, validation, EMA, the image logger, the teacher
filter, `save_state`/`load_state` and the signal handlers are not ported
yet.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from adaface_tpu_torch.data.personalized import (
    PersonalizedDataset,
    SubjectSampler,
    collate_examples,
)
from adaface_tpu_torch.models.vae import SD_VAE_SCALE_FACTOR
from adaface_tpu_torch.personalization.embedding_manager import EmbeddingManager
from adaface_tpu_torch.personalization.static_embedding import embedder_leaves
from adaface_tpu_torch.training.iter_plan import (
    ARC2FACE_DISTILL,
    COMPOS_DISTILL,
    RECON,
    IterPlan,
    IterPlanConfig,
    plan_iteration,
    sample_timesteps,
)
from adaface_tpu_torch.training.prodigy import AccumulatedClipped, Prodigy
from adaface_tpu_torch.training.train_step import ReconBatch, make_recon_train_step


@dataclasses.dataclass
class TrainerConfig:
    max_steps: int = 2000
    batch_size: int = 3
    accumulate_grad_batches: int = 2
    grad_clip: float = 0.5
    d_coef: float = 10.0
    ckpt_every_steps: int = 500
    log_every_steps: int = 10
    bg_recon_weight: float = 0.1
    # recon-iteration complementary battery weights
    fg_bg_complementary_loss_weight: float = 2e-4
    fg_bg_xlayer_consist_loss_weight: float = 5e-5
    # per-iteration Dirichlet resampling of the clip-skip blend weights
    randomize_clip_skip_weights: bool = False
    clip_skip_weights_alpha: tuple = (1.0, 1.0)
    seed: int = 0
    logdir: str = "logs/run"


class Trainer:
    def __init__(self, pipeline, dataset: PersonalizedDataset,
                 cfg: TrainerConfig = TrainerConfig(),
                 plan_cfg: IterPlanConfig = IterPlanConfig()):
        self.pipe = pipeline
        self.dataset = dataset
        self.cfg = cfg
        self.plan_cfg = dataclasses.replace(plan_cfg, max_steps=cfg.max_steps)
        self.rng = np.random.default_rng(cfg.seed)
        # a single (possibly non-face) subject is plain shuffling; corpora
        # skip non-face subjects
        self.sampler = SubjectSampler(dataset, skip_non_faces=len(dataset.subjects) > 1,
                                      seed=cfg.seed)
        self.mgr: EmbeddingManager = pipeline.embedding_manager
        self.device = pipeline.device
        self.global_step = 0

        os.makedirs(cfg.logdir, exist_ok=True)
        self._log_f = open(os.path.join(cfg.logdir, "metrics.jsonl"), "a")

        # frozen backbone; every embedder leaf trains (pre_vecs included)
        for m in (pipeline.clip, pipeline.unet, pipeline.vae):
            m.requires_grad_(False)
        params = []
        for s in sorted(self.mgr.embedders):
            for _, t in embedder_leaves(self.mgr.embedders[s]):
                params.append(t.requires_grad_(True))
        self.optimizer = AccumulatedClipped(Prodigy(params, lr=1.0, d_coef=cfg.d_coef),
                                            cfg.grad_clip, cfg.accumulate_grad_batches)

        self._bg_placeholders = frozenset(
            s for s, info in self.mgr.placeholders.items() if info.is_background)
        # Prodigy's damping (0.5) and zero-shot disabling of the always-on regs
        delta_scale = 0.5 / 5 if self.plan_cfg.do_zero_shot else 0.5
        self._delta_w = self.plan_cfg.prompt_emb_delta_reg_weight * delta_scale
        self._emb_reg_w = 0.0 if self.plan_cfg.do_zero_shot else 2e-4 * 0.5
        self._recon_steps: Dict[tuple, object] = {}

    # ------------------------------------------------------------- plumbing
    def _log(self, metrics: Dict, plan: IterPlan):
        rec = {"step": self.global_step, "iter_type": plan.iter_type,
               "emb_noise_std": float(plan.emb_noise_std),
               "comp_init_fg": float(plan.comp_init_fg_from_training_image),
               "reuse_init": float(plan.reuse_init_conds),
               "wds_comp": float(plan.use_wds_comp)}
        rec.update({k: float(v) for k, v in metrics.items()})
        if not all(np.isfinite(v) for v in rec.values() if isinstance(v, float)):
            self.save_checkpoint("nonfinite")
            raise FloatingPointError(f"non-finite metric at step {self.global_step}: {rec}")
        self._log_f.write(json.dumps(rec) + "\n")
        self._log_f.flush()
        if self.global_step % self.cfg.log_every_steps == 0:
            msg = " ".join(f"{k}={v:.4f}" for k, v in rec.items() if isinstance(v, float))
            print(f"[{self.global_step}/{self.cfg.max_steps}] {plan.iter_type}: {msg}",
                  flush=True)

    def save_checkpoint(self, tag: Optional[str] = None) -> str:
        tag = tag or f"gs-{self.global_step}"
        path = os.path.join(self.cfg.logdir, f"embeddings_{tag}.npz")
        self.mgr.save_native(path)
        print(f"saved {path}", flush=True)
        return path

    def close(self):
        self._log_f.close()

    # ----------------------------------------------------------- batch prep
    def _draw_examples(self, n: int):
        return [self.dataset[(self.sampler.sample(), True)] for _ in range(n)]

    @torch.no_grad()
    def _latents(self, images: np.ndarray) -> torch.Tensor:
        mean, _ = self.pipe.vae.encode(torch.as_tensor(images, device=self.device))
        return mean * SD_VAE_SCALE_FACTOR

    def _mask_to_latent(self, mask: np.ndarray, lh: int, lw: int) -> np.ndarray:
        m = mask.astype(np.float32)
        ri = (np.arange(lh) * (m.shape[1] / lh)).astype(np.int64)
        ci = (np.arange(lw) * (m.shape[2] / lw)).astype(np.int64)
        return m[:, ri][:, :, ci][..., None]

    def _skip_weights_kw(self) -> dict:
        """Per-iteration Dirichlet clip-skip draw, or nothing when off."""
        if not self.cfg.randomize_clip_skip_weights:
            return {}
        w = self.rng.dirichlet(np.asarray(self.cfg.clip_skip_weights_alpha, np.float64))
        return {"skip_weights": torch.as_tensor(w, dtype=torch.float32, device=self.device)}

    def _prompt_batch(self, examples, key: str):
        prompts = [e[key] if key in e else e["caption"] for e in examples]
        prompts = [p.split("|")[0] for p in prompts]
        ids = self.pipe.tokenizer(prompts)
        return ids, self.mgr.build_slot_maps(ids)

    def _tensor(self, a, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # ---------------------------------------------------------------- steps
    def _get_recon_step(self, use_bg_token: bool):
        """The recon step for this bg-token choice (it changes the battery)."""
        if use_bg_token not in self._recon_steps:
            p, cfg = self.pipe, self.cfg
            self._recon_steps[use_bg_token] = make_recon_train_step(
                p.clip, p.unet, p.base_sched, self.optimizer, skip_weights=p.skip_weights,
                bg_weight=cfg.bg_recon_weight if use_bg_token else 0.0,
                emb_reg_weight=self._emb_reg_w, prompt_delta_weight=self._delta_w,
                complem_weight=cfg.fg_bg_complementary_loss_weight,
                xlayer_weight=cfg.fg_bg_xlayer_consist_loss_weight,
                use_bg_token=use_bg_token, do_zero_shot=self.plan_cfg.do_zero_shot,
                bg_placeholders=self._bg_placeholders)
        return self._recon_steps[use_bg_token]

    def _delta_prompt_battery(self, plan: IterPlan, ex):
        """(token ids [4B, T], slot maps) of the 4-type delta prompts
        (subj/cls x single/comp, bg variants when the plan uses the bg
        token), or None when the prompt-delta regularizer is off."""
        if self._delta_w <= 0:
            return None
        keys = ["subj_prompt_single", "subj_prompt_comp", "cls_prompt_single",
                "cls_prompt_comp"]
        sfx = "_bg" if (plan.use_background_token
                        and all(k + "_bg" in e for e in ex for k in keys)) else ""
        dp = [e[k + sfx].split("|")[0] for k in keys for e in ex]
        ids = self.pipe.tokenizer(dp)
        return ids, self.mgr.build_slot_maps(ids)

    def build_recon_batch(self, plan: IterPlan) -> ReconBatch:
        """Draw and prepare one recon batch (host RNG in the JAX order)."""
        B = self.cfg.batch_size
        ex = self._draw_examples(B)
        batch_np = collate_examples(ex)
        latents = self._latents(batch_np["image"])
        lh, lw = latents.shape[1:3]
        key = "caption_bg" if plan.use_background_token else "caption"
        ids, slots = self._prompt_batch(ex, key)
        t = sample_timesteps(self.rng, plan, B, self.plan_cfg)
        kw = {}
        if plan.emb_noise_std > 0:
            kw = dict(emb_noise_std=float(plan.emb_noise_std),
                      emb_noise_seed=int(self.rng.integers(2 ** 31)))
        delta = self._delta_prompt_battery(plan, ex)
        if delta is not None:
            kw["delta_token_ids"], kw["delta_slot_maps"] = delta
        noise = self._tensor(self.rng.standard_normal(latents.shape))
        return ReconBatch(
            latents=latents, token_ids=ids, slot_maps=slots,
            fg_mask=self._tensor(self._mask_to_latent(batch_np["fg_mask"], lh, lw)),
            timesteps=self._tensor(t, torch.int32), noise=noise,
            img_mask=self._tensor(self._mask_to_latent(batch_np["aug_mask"], lh, lw)),
            have_fg_mask=self._tensor([float(e.get("has_fg_mask", True)) for e in ex]),
            **self._skip_weights_kw(), **kw)

    def _run_recon(self, plan: IterPlan):
        batch = self.build_recon_batch(plan)
        step = self._get_recon_step(plan.use_background_token)
        return step(self.mgr.embedders, batch)

    # ------------------------------------------------------------------ run
    def fit(self, num_steps: Optional[int] = None):
        """Run the training loop for `num_steps` micro-steps (default
        max_steps)."""
        n = num_steps or self.cfg.max_steps
        t0 = time.time()
        try:
            while self.global_step < n:
                plan = plan_iteration(self.rng, self.global_step, self.plan_cfg)
                if plan.iter_type == ARC2FACE_DISTILL:
                    plan.iter_type = RECON  # no teacher
                if plan.iter_type == COMPOS_DISTILL:
                    raise NotImplementedError(
                        "compositional distillation is not ported yet (ROADMAP.md, queue 1); "
                        "set composition_regs_iter_gap=0 for recon-only training")
                metrics = self._run_recon(plan)
                self._log(metrics, plan)
                self.global_step += 1
                if self.global_step % self.cfg.ckpt_every_steps == 0:
                    self.save_checkpoint()
                    self._log_run_summary(t0)
        except KeyboardInterrupt:
            self.save_checkpoint("interrupted")
            raise
        except Exception:
            self.save_checkpoint("exception")
            raise
        self.save_checkpoint("last")
        dt = time.time() - t0
        self._log_run_summary(t0)
        print(f"trained {self.global_step} steps in {dt:.1f}s "
              f"({self.global_step / max(dt, 1e-9):.2f} it/s)", flush=True)
        return self.mgr

    def _log_run_summary(self, t_start: float):
        """Wall time, steps/s and, on a card, the peak device memory."""
        dt = time.time() - t_start
        rec: Dict = {"step": self.global_step, "run_summary": True,
                     "elapsed_s": round(dt, 2),
                     "steps_per_sec": round(self.global_step / max(dt, 1e-9), 4)}
        if self.device.type == "cuda":
            rec["peak_mem_gib"] = round(torch.cuda.max_memory_allocated(self.device) / 2**30, 3)
        self._log_f.write(json.dumps(rec) + "\n")
        self._log_f.flush()
        mem = f", peak memory {rec['peak_mem_gib']:.2f} GiB" if "peak_mem_gib" in rec else ""
        print(f"[summary] {self.global_step} steps, {dt:.1f}s "
              f"({rec['steps_per_sec']:.2f} it/s){mem}", flush=True)
