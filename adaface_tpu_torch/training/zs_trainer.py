"""Zero-shot ("AdaFace") training (counterpart of
`adaface_tpu/training/zs_trainer.py`): the SubjBasisGenerators train over a
multi-subject corpus, the static trainer's plumbing (dataset, VAE encode,
plan machine, optimizer chain, logging) reused.

Per micro-step, `plan_iteration` rolls the iteration on the host:

- recon: `batch_size` examples; their reference features (masked CLIP fg
  and bg, face identity) from the `ZeroShotFeatureExtractor`; the zero-shot
  recon step (`train_step.make_zero_shot_recon_step`), one per (bg token)
  variant;
- compositional distillation: one block (4 UNet rows) of one example, its
  x_start as the static trainer makes it, the zero-shot compos step with
  the subj-single block anchored on `_gen0`, a frozen copy of the generators
  taken at setup;
- Arc2Face distillation (given a teacher UNet): ceil(batch_size / S)
  examples on an S-step plan; a random-face iteration starts from pure
  noise with random identities, one with `add_noise_to_real_id_embs`
  collapses the batch to its first subject and perturbs that identity per
  instance (`_noise_id_embs`).

The host numpy RNG is consumed in the JAX trainer's order, an integer from
it wherever JAX draws a PRNG key (the embedding noise, the generators'
dropout), so one seed builds the same batches in both. Checkpoints
(`subj_basis_<tag>.pt`, the port's own `torch.save` file) hold the
generators, their frozen anchor, the optimizer chain, the step and the host,
dataset and sampler RNG states, so a resumed run draws what an uninterrupted
one would. Not ported: the mesh placement of the trainables (one card;
ROADMAP queue 1 item 13), the teacher filter's no-grad zero-shot contexts
(`_zs_subject_embs`, `_zs_compos_contexts`: the filter is item 12) and the
validation pass (`val_every_steps` > 0 raises, as in the static trainer:
item 10).
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from adaface_tpu_torch.data.personalized import collate_examples
from adaface_tpu_torch.personalization.arc2face import (
    FORWARD_TEMPLATE,
    INVERSE_TEMPLATE,
    make_template_ids,
)
from adaface_tpu_torch.training.iter_plan import (
    ARC2FACE_DISTILL,
    COMPOS_DISTILL,
    RECON,
    IterPlan,
    IterPlanConfig,
    plan_iteration,
    sample_timesteps,
)
from adaface_tpu_torch.training.train_step import (
    ZeroShotArc2FaceBatch,
    ZeroShotComposBatch,
    ZeroShotReconBatch,
    ZeroShotTemplates,
    make_zero_shot_arc2face_step,
    make_zero_shot_compos_step,
    make_zero_shot_recon_step,
)
from adaface_tpu_torch.training.trainer import Trainer, TrainerConfig


class ZeroShotTrainer(Trainer):
    def __init__(self, pipeline, dataset, extractor, generators: Dict[str, nn.Module],
                 arc2face_encoder: nn.Module, cfg: TrainerConfig = TrainerConfig(),
                 plan_cfg: IterPlanConfig = IterPlanConfig(),
                 bg_placeholders=frozenset()):
        """`generators`: placeholder -> SubjBasisGenerator (trained in place),
        each placeholder registered in the pipeline's manager;
        `arc2face_encoder`: the frozen Arc2Face text encoder."""
        self.generators = generators
        super().__init__(pipeline, dataset, cfg, plan_cfg)
        self.extractor = extractor
        self.bg_placeholders = frozenset(bg_placeholders)
        self._arc_encoder = arc2face_encoder.eval().requires_grad_(False)
        tok = pipeline.tokenizer
        self._templates = ZeroShotTemplates(make_template_ids(tok, FORWARD_TEMPLATE),
                                            make_template_ids(tok, INVERSE_TEMPLATE),
                                            int(tok.encode("id")[0]))
        # the frozen anchor of the compos iterations' subj-single block
        self._gen0 = {s: copy.deepcopy(g).requires_grad_(False) for s, g in generators.items()}
        self._zs_recon_steps: Dict[bool, object] = {}
        self._zs_compos_step = None
        self._zs_a2f_steps: Dict[tuple, object] = {}

    def _trainable_params(self) -> list:
        """The generators' parameters (sorted placeholder order), set to take
        gradients; the manager's static embedders, if any, stay as they are."""
        return [p.requires_grad_(True) for s in sorted(self.generators)
                for p in self.generators[s].face_trainable_parameters()]

    def _dropout_seed(self) -> int:
        """The generators' dropout seed of one iteration, drawn where the JAX
        trainer draws its dropout key."""
        return int(self.rng.integers(2 ** 31))

    # ------------------------------------------------------------ checkpoints
    def save_checkpoint(self, tag: Optional[str] = None) -> str:
        tag = tag or f"gs-{self.global_step}"
        path = os.path.join(self.cfg.logdir, f"subj_basis_{tag}.pt")
        cpu = lambda gens: {s: {k: v.detach().cpu() for k, v in g.state_dict().items()}
                            for s, g in gens.items()}
        torch.save({"generators": cpu(self.generators), "frozen_generators": cpu(self._gen0),
                    "global_step": self.global_step,
                    "use_prodigy": self.cfg.use_prodigy,
                    "optimizer": self.optimizer.state_dict(),
                    "rng_state": self.rng.bit_generator.state,
                    "dataset_rng_state": self.dataset.rng.bit_generator.state,
                    "sampler_rng_state": self.sampler.rng.bit_generator.state}, path)
        print(f"saved {path}", flush=True)
        return path

    def load_checkpoint(self, path: str) -> "ZeroShotTrainer":
        """Resume generator training from `save_checkpoint`'s file, in place
        (the optimizer holds the parameters)."""
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        if bool(ckpt["use_prodigy"]) != bool(self.cfg.use_prodigy):
            raise ValueError(f"{path} was saved with use_prodigy={ckpt['use_prodigy']}, "
                             f"this run has {self.cfg.use_prodigy}")
        for gens, key in ((self.generators, "generators"), (self._gen0, "frozen_generators")):
            if set(ckpt[key]) != set(gens):
                raise ValueError(f"{path}: {key} for {sorted(ckpt[key])}, this run has "
                                 f"{sorted(gens)}")
            for s, g in gens.items():
                g.load_state_dict(ckpt[key][s], strict=True)
        self.global_step = int(ckpt["global_step"])
        self.optimizer.load_state_dict(ckpt["optimizer"])
        self.rng.bit_generator.state = ckpt["rng_state"]
        self.dataset.rng.bit_generator.state = ckpt["dataset_rng_state"]
        self.sampler.rng.bit_generator.state = ckpt["sampler_rng_state"]
        print(f"resumed zs training from {path} at step {self.global_step}", flush=True)
        return self

    # ------------------------------------------------------------------ steps
    def _step_kw(self) -> dict:
        p = self.pipe
        return dict(bg_placeholders=self.bg_placeholders,
                    arc2face_encoder=self._arc_encoder, templates=self._templates,
                    skip_weights=p.skip_weights)

    def _get_zs_recon_step(self, use_bg_token: bool):
        """The zs recon step of this bg-token choice (it changes the battery
        and the bg recon weight)."""
        if use_bg_token not in self._zs_recon_steps:
            p, cfg = self.pipe, self.cfg
            self._zs_recon_steps[use_bg_token] = make_zero_shot_recon_step(
                p.clip, p.unet, p.base_sched, self.optimizer, **self._step_kw(),
                bg_weight=cfg.bg_recon_weight if use_bg_token else 0.0,
                complem_weight=cfg.fg_bg_complementary_loss_weight,
                xlayer_weight=cfg.fg_bg_xlayer_consist_loss_weight,
                prompt_delta_weight=self._delta_w, use_bg_token=use_bg_token)
        return self._zs_recon_steps[use_bg_token]

    def _get_zs_compos_step(self):
        if self._zs_compos_step is None:
            p = self.pipe
            self._zs_compos_step = make_zero_shot_compos_step(
                p.clip, p.unet, p.base_sched, self.optimizer, **self._step_kw(),
                frozen_generators=self._gen0, prompt_delta_weight=self._delta_w,
                mix_prompt_distill_weight=self.plan_cfg.mix_prompt_distill_weight)
        return self._zs_compos_step

    def _get_zs_arc2face_step(self, plan: IterPlan, teacher_unet):
        key = (plan.num_denoising_steps, plan.gen_arc2face_rand_face, id(teacher_unet))
        if key not in self._zs_a2f_steps:
            p = self.pipe
            self._zs_a2f_steps[key] = make_zero_shot_arc2face_step(
                p.clip, p.unet, teacher_unet, p.base_sched, self.optimizer, **self._step_kw(),
                num_denoising_steps=plan.num_denoising_steps,
                use_fg_mask=not plan.gen_arc2face_rand_face)
        return self._zs_a2f_steps[key]

    # ------------------------------------------------------------ batch prep
    def _features(self, ex):
        f = self.extractor.encode([e["image_unnorm"] for e in ex],
                                  [e["fg_mask"] for e in ex], is_face=True)
        # the extractor runs in inference mode, whose tensors a backward
        # cannot save: normal copies
        copy_ = lambda t: None if t is None else t.clone()
        return dataclasses.replace(f, clip_fg=copy_(f.clip_fg), clip_bg=copy_(f.clip_bg),
                                   id_embs=copy_(f.id_embs))

    def _id_embs_or_draw(self, feats, n: int) -> torch.Tensor:
        """The extractor's identity embeddings, or (no face embedder) n
        standard normal draws from the host RNG."""
        if feats.id_embs is not None:
            return feats.id_embs.float()
        return self._tensor(self.rng.standard_normal((n, 512)))

    @staticmethod
    def _per_instance(t: torch.Tensor, n: int) -> torch.Tensor:
        return t if t.shape[0] == n else t.expand((n,) + tuple(t.shape[1:]))

    def build_zs_recon_batch(self, ex: list, plan: IterPlan) -> ZeroShotReconBatch:
        """One zs recon batch from the drawn examples (host RNG in the JAX
        order)."""
        B = len(ex)
        batch_np = collate_examples(ex)
        latents = self._latents(batch_np["image"])
        lh, lw = latents.shape[1:3]
        ids, slots = self._prompt_batch(
            ex, "caption_bg" if plan.use_background_token else "caption")
        feats = self._features(ex)
        id_embs = self._id_embs_or_draw(feats, B)
        t = sample_timesteps(self.rng, plan, B, self.plan_cfg)
        kw = {}
        if plan.emb_noise_std > 0:
            kw = dict(emb_noise_std=float(plan.emb_noise_std),
                      emb_noise_seed=int(self.rng.integers(2 ** 31)))
        delta = self._delta_prompt_battery(plan, ex)
        if delta is not None:
            kw["delta_token_ids"], kw["delta_slot_maps"] = delta
        fg = self._tensor(self._mask_to_latent(batch_np["fg_mask"], lh, lw))
        noise = self._tensor(self.rng.standard_normal(tuple(latents.shape)))
        return ZeroShotReconBatch(
            latents=latents, token_ids=ids, slot_maps=slots, fg_mask=fg,
            timesteps=self._tensor(t, torch.int32), noise=noise,
            img_mask=self._tensor(self._mask_to_latent(batch_np["aug_mask"], lh, lw)),
            have_fg_mask=self._tensor([float(e.get("has_fg_mask", True)) for e in ex]),
            clip_fg=self._per_instance(feats.clip_fg, B),
            clip_bg=self._per_instance(feats.clip_bg, B), id_embs=id_embs,
            dropout_seed=self._dropout_seed(), **self._skip_weights_kw(), **kw)

    def build_zs_compos_batch(self, plan: IterPlan) -> ZeroShotComposBatch:
        """One zs compos block (host RNG in the JAX order). The reference
        images' features come from this draw's example: the cached-feature
        branch of a reuse-init iteration needs the teacher filter's cache."""
        CB = 1  # one block on one card
        ex = self._draw_examples(CB)
        self._wds_compos_swap(plan, ex)
        prompts = self._compos_prompt_battery(plan, ex)
        latents = self._latents(np.stack([e["image"] for e in ex]))
        lh, lw = latents.shape[1:3]
        fg_latent = self._mask_to_latent(np.stack([e["fg_mask"] for e in ex]), lh, lw)
        for b, e in enumerate(ex):
            if not e.get("has_fg_mask", True):
                fg_latent[b] = 0.0
        latents, fg_latent, prompts, prev_t = self._compos_x_start(
            plan, ex, latents, fg_latent, prompts)
        ids = self.pipe.tokenizer(prompts)
        slots = self.mgr.build_slot_maps(ids)
        subj_string = next(s for s in self.generators if s not in self.bg_placeholders)
        feats = self._features(ex)
        id_embs = self._id_embs_or_draw(feats, CB)
        t = sample_timesteps(self.rng, plan, CB, self.plan_cfg, prev_t=prev_t)
        noise = self._tensor(self.rng.standard_normal(tuple(latents.shape)))
        kw = {}
        if plan.emb_noise_std > 0:
            kw = dict(emb_noise_std=float(plan.emb_noise_std),
                      emb_noise_seed=int(self.rng.integers(2 ** 31)))
        return ZeroShotComposBatch(
            token_ids=ids, slot_maps=slots, subj_slot_map=slots[subj_string],
            latents=latents, fg_mask=self._tensor(fg_latent),
            timesteps=self._tensor(t, torch.int32), noise=noise,
            t_frac=self._tensor(t / self.plan_cfg.num_timesteps),
            training_percent=plan.training_percent,
            clip_fg=feats.clip_fg[:CB], clip_bg=feats.clip_bg[:CB], id_embs=id_embs[:CB],
            cls_mix_ranges=self._cls_mix_ranges(plan), dropout_seed=self._dropout_seed(),
            preserve_loss_scale=self._preserve_scale(plan), **self._skip_weights_kw(), **kw)

    def _noise_id_embs(self, id_embs: np.ndarray) -> np.ndarray:
        """Norm-keeping identity noise: std U(0.02, 0.06) times the batch
        mean of the rows' (ddof 1) std, each row rescaled to its norm."""
        e = np.asarray(id_embs, np.float32)
        std_mean = float(e.std(axis=-1, ddof=1).mean())
        noise_std = float(self.rng.uniform(0.02, 0.06)) * std_mean
        noised = e + self.rng.standard_normal(e.shape).astype(np.float32) * noise_std
        orig = np.linalg.norm(e, axis=-1, keepdims=True)
        new = np.linalg.norm(noised, axis=-1, keepdims=True)
        return noised * orig / (new + 1e-8)

    def build_zs_arc2face_batch(self, plan: IterPlan) -> ZeroShotArc2FaceBatch:
        """One zs Arc2Face batch (host RNG in the JAX order): ceil(batch /
        S) examples on an S-step plan."""
        S = plan.num_denoising_steps
        B = self._arc2face_batch_size(self.cfg.batch_size, S)
        ex = self._draw_examples(B)
        batch_np = collate_examples(ex)
        feats = self._features(ex)
        bfg = self._per_instance(feats.clip_fg, B)
        bbg = self._per_instance(feats.clip_bg, B)
        img_kw = {}
        if plan.gen_arc2face_rand_face:
            # random identities from pure noise, no masks (the VAE encode
            # only sizes the draw, as in the JAX trainer)
            id_embs = self.rng.standard_normal((B, 512)).astype(np.float32)
            latents = self._tensor(self.rng.standard_normal(
                tuple(self._latents(batch_np["image"]).shape)))
            fg = None
        else:
            id_embs = (feats.id_embs.float().cpu().numpy() if feats.id_embs is not None
                       else self.rng.standard_normal((B, 512)).astype(np.float32))
            latents = self._latents(batch_np["image"])
            lh, lw = latents.shape[1:3]
            fg = self._tensor(self._mask_to_latent(batch_np["fg_mask"], lh, lw))
            img_kw["img_mask"] = self._tensor(self._mask_to_latent(batch_np["aug_mask"], lh, lw))
            if plan.add_noise_to_real_id_embs:
                # the first subject's image, masks and features for every
                # instance, its identity perturbed per instance; captions
                # stay as drawn
                first = lambda t: t[:1].expand(t.shape)
                latents, fg, bfg, bbg = first(latents), first(fg), first(bfg), first(bbg)
                img_kw["img_mask"] = first(img_kw["img_mask"])
                id_embs = self._noise_id_embs(np.broadcast_to(id_embs[:1], id_embs.shape))
        ids, slots = self._prompt_batch(ex, "caption")
        t = sample_timesteps(self.rng, plan, B, self.plan_cfg)
        noises = self._tensor(self.rng.standard_normal((S,) + tuple(latents.shape)))
        relative_ts = self._tensor(self.rng.uniform(size=(max(S - 1, 1), B)))
        id_embs = self._tensor(id_embs)
        id_embs = id_embs / (torch.linalg.vector_norm(id_embs, dim=-1, keepdim=True) + 1e-12)
        return ZeroShotArc2FaceBatch(
            latents=latents, token_ids=ids, slot_maps=slots,
            timesteps=self._tensor(t, torch.int32), noises=noises, relative_ts=relative_ts,
            fg_mask=fg, clip_fg=bfg, clip_bg=bbg, id_embs=id_embs,
            dropout_seed=self._dropout_seed(), **img_kw, **self._skip_weights_kw())

    # -------------------------------------------------------------------- run
    def _run_zs_recon(self, plan: IterPlan):
        plan.iter_type = RECON
        ex = self._draw_examples(self.cfg.batch_size)
        batch = self.build_zs_recon_batch(ex, plan)
        return self._get_zs_recon_step(plan.use_background_token)(self.generators, batch)

    def _run_zs_compos(self, plan: IterPlan):
        return self._get_zs_compos_step()(self.generators, self.build_zs_compos_batch(plan))

    def _run_zs_arc2face(self, plan: IterPlan, teacher_unet):
        batch = self.build_zs_arc2face_batch(plan)
        return self._get_zs_arc2face_step(plan, teacher_unet)(self.generators, batch)

    def _post_step(self, t0: float):
        self.global_step += 1
        if self.global_step % self.cfg.ckpt_every_steps == 0:
            self.save_checkpoint()
            self._log_run_summary(t0)

    def fit(self, num_steps: Optional[int] = None, arc2face_teacher_unet=None):
        """Train the generators until `num_steps` micro-steps (default
        max_steps). `arc2face_teacher_unet`: the frozen teacher UNet that
        runs Arc2Face plans (its context comes from the frozen Arc2Face
        encoder, so it needs no ctx_fn); without one they run as recon."""
        n = num_steps or self.cfg.max_steps
        t0 = time.time()
        while self.global_step < n:
            plan = plan_iteration(self.rng, self.global_step, self.plan_cfg)
            if plan.iter_type == COMPOS_DISTILL:
                metrics = self._run_zs_compos(plan)
            elif plan.iter_type == ARC2FACE_DISTILL and arc2face_teacher_unet is not None:
                metrics = self._run_zs_arc2face(plan, arc2face_teacher_unet)
            else:
                metrics = self._run_zs_recon(plan)
            self._log(metrics, plan)
            self._post_step(t0)
        self.save_checkpoint("last")
        self._log_run_summary(t0)
        return self.generators
