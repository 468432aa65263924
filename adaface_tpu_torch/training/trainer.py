"""Training loop (counterpart of the single-device path of
`adaface_tpu/training/trainer.py`).

Per step, `plan_iteration` rolls the iteration on the host. A recon plan
draws examples from `PersonalizedDataset` (one subject per instance),
VAE-encodes the images (the posterior mean times the scale factor, no
gradient), builds the `ReconBatch` (timesteps, noise, latent-resolution fg
and augmentation masks, the delta-prompt battery, embedding-noise seed) and
runs the recon step. A compositional-distillation plan (every
`composition_regs_iter_gap`-th step) draws one example, builds its 4-type
prompt block, its x_start (the training image's foreground scaled onto
noise, pure noise, or a cached reconstruction on a reuse-init iteration),
timesteps in the top 20% (mid-range on reuse), compel draws and the class-mix
ranges, and runs the compositional step; one block (4 UNet rows) a device,
whatever `batch_size` says. Gradient accumulation and global-norm
clipping live in the optimizer chain (`training/prodigy.py`). The host numpy
RNG is consumed in the JAX trainer's order, so one seed builds the same
batches in both. Checkpoints are the embedding manager's native `.npz`
every `ckpt_every_steps` and `last`; metrics stream to stdout and
`metrics.jsonl`.

The optimizer is Prodigy (learning rate 1, `d_coef`) or, with
`use_prodigy` off, AdamW at `learning_rate` (times accumulation x devices x
batch under `scale_lr`), behind the clip and accumulation chain; the
prompt-delta and embedding regularizers are damped by 0.5 under Prodigy
only. `use_ema` keeps an EMA shadow of the embedders, which the
checkpoints save. `save_state` / `load_state` hold everything a resumed run
needs to continue as an uninterrupted one would (step, embedders, the whole
optimizer chain, the host, dataset and subject-sampler RNG states, the EMA
state) in the port's own `torch.save` file. SIGUSR1 asks for a checkpoint
at the next step's end, SIGUSR2 enters pdb. Given an Arc2Face teacher
(`fit(arc2face_teacher=(teacher_unet, ctx_fn))`,
`training/arc2face_teacher.py`), Arc2Face plans run the distillation step
(batch ceil(batch_size / S) on an S-step plan, the teacher's context from
`ctx_fn(examples, plan)`; a random-face iteration keeps the dataset's
latents and drops the masks, as the JAX trainer does); without one they run
as recon.

With `wds_shards`, a `BackgroundCompositor` (`data/wds.py`) pastes the
subject over LAION-style backgrounds: a `p_wds_comp_recon` share of the
recon iterations train on the composite (its captions, the class flavor at
an annealed probability, the bg token at 0.95, the discounted
`wds_bg_recon_weight` and, when its weight is > 0, the fg vs comp-extra
complementary battery), and a `p_wds_comp_compos` share of the compos
iterations start from the bg-only image, their comp extras replaced by the
background's. `val_every_steps` > 0 runs a validation pass (the recon
battery without gradients on `val_batches` batches of a separate stream over
the same images, `val/` rows, an `_ema` arm over the EMA shadow, and a
sample grid when an image logger is set, `set_image_logger`). Validation
draws from its own RNGs only, so it does not move the training stream.
`set_teacher_filter(clip_scorer)` turns on CLIP teacher filtering of the
compos iterations (`training/teacher_filter.py`): `num_candidate_teachers`
candidate (noise, t) draws of the block are denoised without gradients under
the subject-comp and the class-mixed comp contexts and CLIP-scored; an
unteachable block skips the iteration (`skipped_unteachable`), a teachable
one trains on its best candidate's noise and t and caches that candidate's
reconstruction, which a later compos iteration of the subject reuses
(reuse-init).

Data parallelism (`num_devices` > 1, in one of that many ranks of
`parallel.mesh.launch`; the trainer builds its dp mesh over them, as JAX's
does, `trainer.py:140-152`):
`batch_size` is per device, so every rank draws the global batch
(`batch_size x dp`, `dp` compos blocks) from the same host RNGs, VAE-encodes
its own rows and gathers the latents (and, zero-shot, the reference
features), so that every host decision is the same on every rank; the
teacher filter denoises the rank's own candidates and the ranks' CLIP
losses are gathered before the per-block verdicts. The step gets the rank's
slice (`mesh.shard_train_batch`); the step builders take the mesh, so the
gradients are averaged over the ranks and the losses' batch reductions are
global (`train_step`, `losses`). The
trainables and the frozen backbone are replicated, the optimizer state
ZeRO-1-sharded (`training/prodigy.py`). Rank 0 alone writes metrics.jsonl,
the checkpoints, the train state, the image grids and the validation rows.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import signal
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
from adaface_tpu_torch.ops.compel import sample_compel_cfg
from adaface_tpu_torch.parallel import mesh as pmesh
from adaface_tpu_torch.personalization.embedding_manager import EmbeddingManager
from adaface_tpu_torch.personalization.static_embedding import embedder_leaves
from adaface_tpu_torch.training.iter_plan import (
    ARC2FACE_DISTILL,
    COMPOS_DISTILL,
    RECON,
    IterPlan,
    IterPlanConfig,
    anneal_value,
    plan_iteration,
    sample_timesteps,
)
from adaface_tpu_torch.training.adamw import AdamW
from adaface_tpu_torch.training.ema import EmaState, ema_init, ema_update
from adaface_tpu_torch.training.mixing import mix_static_vk_embeddings
from adaface_tpu_torch.training.prodigy import AccumulatedClipped, Prodigy
from adaface_tpu_torch.training.train_step import (
    Arc2FaceBatch,
    ComposBatch,
    ReconBatch,
    make_arc2face_distill_step,
    make_compos_distill_step,
    make_recon_train_step,
)
from adaface_tpu_torch.training.x_init import init_x_with_fg_from_training_image


# the metrics of a compos iteration the teacher filter skips
SKIPPED_UNTEACHABLE = {"loss": 0.0, "skipped_unteachable": 1.0}


@dataclasses.dataclass
class TrainerConfig:
    max_steps: int = 2000
    batch_size: int = 3
    accumulate_grad_batches: int = 2
    grad_clip: float = 0.5
    # AdamW's rate (use_prodigy off), times accumulation x devices x batch
    # under scale_lr
    learning_rate: float = 7e-4
    scale_lr: bool = True
    # data-parallel ranks (-1: every rank of this process's group);
    # batch_size is per device
    num_devices: int = 1
    use_prodigy: bool = True
    d_coef: float = 10.0
    ckpt_every_steps: int = 500
    log_every_steps: int = 10
    bg_recon_weight: float = 0.1
    # recon-iteration complementary battery weights
    fg_bg_complementary_loss_weight: float = 2e-4
    fg_bg_xlayer_consist_loss_weight: float = 5e-5
    # the webdataset compositor's settings (the `data` section of
    # finetune-ada.yaml): the fg vs comp-extra battery's weight, the shards,
    # the composite's share of recon and compos iterations, the bg recon
    # weight of a composite and its dedicated bg placeholder
    fg_wds_complementary_loss_weight: float = 0.0
    wds_shards: tuple = ()
    p_wds_comp_recon: float = 0.05
    p_wds_comp_compos: float = 0.2
    wds_bg_recon_weight: float = 0.05
    wds_background_string: str = "w"
    # compel weighting of the compos iterations' V/K contexts: probability
    # and the range the level is drawn from
    apply_compel_cfg_prob: float = 0.0
    compel_cfg_weight_level_range: tuple = (2.0, 2.0)
    # per-iteration Dirichlet resampling of the clip-skip blend weights
    randomize_clip_skip_weights: bool = False
    clip_skip_weights_alpha: tuple = (1.0, 1.0)
    # EMA shadow of the embedders (LitEma; the checkpoints save the shadow)
    use_ema: bool = False
    ema_decay: float = 0.9999
    # a validation pass every N steps (0: none) over val_batches batches
    val_every_steps: int = 0
    val_batches: int = 2
    seed: int = 0
    logdir: str = "logs/run"


class Trainer:
    def __init__(self, pipeline, dataset: PersonalizedDataset,
                 cfg: TrainerConfig = TrainerConfig(),
                 plan_cfg: IterPlanConfig = IterPlanConfig()):
        # the trainer builds its dp mesh from num_devices, as JAX's does
        # (`trainer.py:140-152`), over the ranks of this process's group (-1:
        # all of them); more devices than ranks raise
        n = cfg.num_devices
        mesh = pmesh.make_mesh(None if n == -1 else n) if n != 1 else None
        have = pmesh.dp_of(mesh)
        cfg = dataclasses.replace(cfg, num_devices=have)
        self.mesh = mesh if have > 1 else None
        self._dp = have
        self._main = pmesh.is_main(mesh)
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
        self._sig_ckpt_requested = False

        os.makedirs(cfg.logdir, exist_ok=True)
        # rank 0 alone writes the metrics
        self._log_f = open(os.path.join(cfg.logdir, "metrics.jsonl") if self._main
                           else os.devnull, "a")

        # frozen backbone
        for m in (pipeline.clip, pipeline.unet, pipeline.vae):
            m.requires_grad_(False)
        params = self._trainable_params()
        if cfg.use_prodigy:
            inner = Prodigy(params, lr=1.0, d_coef=cfg.d_coef, mesh=self.mesh)
        else:
            lr = cfg.learning_rate
            if cfg.scale_lr:
                lr *= cfg.accumulate_grad_batches * self._dp * cfg.batch_size
            inner = AdamW(params, lr, mesh=self.mesh)
        self.optimizer = AccumulatedClipped(inner, cfg.grad_clip, cfg.accumulate_grad_batches)

        self._bg_placeholders = frozenset(
            s for s, info in self.mgr.placeholders.items() if info.is_background)
        # Prodigy's damping (0.5; 1 under AdamW) and zero-shot disabling of
        # the always-on regs (the delta reg /5, the embedding reg off)
        damping = 0.5 if cfg.use_prodigy else 1.0
        delta_scale = damping / 5 if self.plan_cfg.do_zero_shot else damping
        self._delta_w = self.plan_cfg.prompt_emb_delta_reg_weight * delta_scale
        self._emb_reg_w = 0.0 if self.plan_cfg.do_zero_shot else 2e-4 * damping
        self._recon_steps: Dict[tuple, object] = {}
        self._val_loss = None
        self._compos_step = None
        self._a2f_steps: Dict[tuple, object] = {}
        # the empty prompt's first-layer context, frozen, for compel
        self._empty_ctx = None
        if cfg.apply_compel_cfg_prob > 0:
            self._empty_ctx = pipeline.encode_negative("", 1)[0, 0].clone()
        # the teacher filter and its reuse-init cache (`set_teacher_filter`)
        self.teacher_filter = None
        self.cached_inits = None
        self.image_logger = None
        self.ema_state: Optional[EmaState] = (ema_init(self.mgr.embedders) if cfg.use_ema
                                              else None)
        self.compositor = None
        if cfg.wds_shards:
            from adaface_tpu_torch.data.wds import BackgroundCompositor

            self.compositor = BackgroundCompositor(list(cfg.wds_shards), size=dataset.size)
        # the validation stream: the same images under RNGs of their own
        self._val_sampler = None
        if cfg.val_every_steps > 0:
            self._val_dataset = copy.copy(dataset)
            self._val_dataset.rng = np.random.default_rng(cfg.seed + 1017)
            self._val_sampler = SubjectSampler(
                self._val_dataset, skip_non_faces=len(dataset.subjects) > 1,
                seed=cfg.seed + 1017)
            self._val_rng = np.random.default_rng(cfg.seed + 1017)
        signal.signal(signal.SIGUSR1, self._on_sigusr1)
        signal.signal(signal.SIGUSR2, self._on_sigusr2)

    def set_teacher_filter(self, clip_scorer, **filter_kw):
        """Turn on CLIP teacher filtering and reuse-init caching of the
        compos iterations. `filter_kw` goes to `TeacherFilter`
        (clip_loss_thres, cls_subj_clip_margin, student_cfg_scale,
        teacher_cfg_scale)."""
        from adaface_tpu_torch.training.teacher_filter import CachedInits, TeacherFilter

        p = self.pipe
        self.teacher_filter = TeacherFilter(clip_scorer, p.unet, p.vae, p.base_sched, **filter_kw)
        self.cached_inits = CachedInits()

    def set_image_logger(self, every_steps: int = 500, **kw):
        """Write sample grids under `<logdir>/images/` (`training/image_logger.py`):
        the validation pass's, and the teacher filter's candidates."""
        from adaface_tpu_torch.training.image_logger import ImageLogger

        self.image_logger = ImageLogger(self.cfg.logdir, every_steps=every_steps, **kw)

    def _trainable_params(self) -> list:
        """Every embedder leaf (pre_vecs included), set to take gradients."""
        return [t.requires_grad_(True) for s in sorted(self.mgr.embedders)
                for _, t in embedder_leaves(self.mgr.embedders[s])]

    # ------------------------------------------------------------- plumbing
    def _on_sigusr1(self, *_):
        """Ask for a checkpoint at the end of the current step."""
        self._sig_ckpt_requested = True

    def _on_sigusr2(self, *_):
        import pdb

        pdb.set_trace()

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
        if self.global_step % self.cfg.log_every_steps == 0 and self._main:
            msg = " ".join(f"{k}={v:.4f}" for k, v in rec.items() if isinstance(v, float))
            print(f"[{self.global_step}/{self.cfg.max_steps}] {plan.iter_type}: {msg}",
                  flush=True)

    def save_checkpoint(self, tag: Optional[str] = None) -> str:
        """The embeddings' `.npz` (`embeddings_<tag>.npz`, default
        `gs-<step>`): the EMA shadow when EMA is on, else the live
        embedders. Rank 0 writes (the embedders are replicated)."""
        tag = tag or f"gs-{self.global_step}"
        path = os.path.join(self.cfg.logdir, f"embeddings_{tag}.npz")
        if not self._main:
            return path
        if self.ema_state is not None:
            live = self.mgr.embedders
            self.mgr.embedders = self.ema_state.shadow
            try:
                self.mgr.save_native(path)
            finally:
                self.mgr.embedders = live
        else:
            self.mgr.save_native(path)
        print(f"saved {path}", flush=True)
        return path

    # ------------------------------------------------------ full train state
    @staticmethod
    def _leaves_cpu(embedders: Dict) -> Dict:
        return {s: {n: t.detach().cpu().clone() for n, t in embedder_leaves(e)}
                for s, e in embedders.items()}

    @staticmethod
    @torch.no_grad()
    def _load_leaves(embedders: Dict, saved: Dict, what: str):
        """Copy saved leaves into the live tensors in place (the optimizer
        holds them)."""
        if set(saved) != set(embedders):
            raise ValueError(f"{what}: saved placeholders {sorted(saved)}, this run has "
                             f"{sorted(embedders)}")
        for s, e in embedders.items():
            leaves = dict(embedder_leaves(e))
            if set(saved[s]) != set(leaves):
                raise ValueError(f"{what}: {s} has leaves {sorted(saved[s])} saved, "
                                 f"{sorted(leaves)} here")
            for n, t in leaves.items():
                t.copy_(saved[s][n])

    def save_state(self, path: Optional[str] = None) -> str:
        """The whole resumable state (`train_state.pt` in the log dir): step,
        embedders, the optimizer chain (the accumulation's micro-step count
        and running mean included), the host, dataset and subject-sampler
        RNG states, and the EMA state, as plain tensors, ints and dicts
        (`torch.save`; the JAX package's pickle holds optax classes). Every
        rank takes part (the ZeRO-1 state is gathered); rank 0 writes."""
        path = path or os.path.join(self.cfg.logdir, "train_state.pt")
        opt_state = self.optimizer.state_dict()
        if not self._main:
            return path
        state = {
            "global_step": self.global_step,
            "use_prodigy": self.cfg.use_prodigy,
            "embedders": self._leaves_cpu(self.mgr.embedders),
            "optimizer": opt_state,
            "rng_state": self.rng.bit_generator.state,
            "dataset_rng_state": self.dataset.rng.bit_generator.state,
            "sampler_rng_state": self.sampler.rng.bit_generator.state,
            "ema_state": (None if self.ema_state is None else
                          {"shadow": self._leaves_cpu(self.ema_state.shadow),
                           "num_updates": self.ema_state.num_updates}),
        }
        torch.save(state, path)
        print(f"saved train state {path} (step {self.global_step})", flush=True)
        return path

    def load_state(self, path: str) -> "Trainer":
        """Restore `save_state`'s file into this trainer, in place (every rank
        reads it; a state saved at any dp resumes at any other)."""
        state = torch.load(path, map_location="cpu", weights_only=True)
        if bool(state["use_prodigy"]) != bool(self.cfg.use_prodigy):
            raise ValueError(f"{path} was saved with use_prodigy={state['use_prodigy']}, "
                             f"this run has {self.cfg.use_prodigy}")
        self.global_step = int(state["global_step"])
        self._load_leaves(self.mgr.embedders, state["embedders"], path)
        self.optimizer.load_state_dict(state["optimizer"])
        self.rng.bit_generator.state = state["rng_state"]
        self.dataset.rng.bit_generator.state = state["dataset_rng_state"]
        self.sampler.rng.bit_generator.state = state["sampler_rng_state"]
        if state["ema_state"] is not None:
            if self.ema_state is None:
                self.ema_state = ema_init(self.mgr.embedders)
            self._load_leaves(self.ema_state.shadow, state["ema_state"]["shadow"], path)
            self.ema_state = EmaState(self.ema_state.shadow,
                                      int(state["ema_state"]["num_updates"]))
        print(f"resumed from {path} at step {self.global_step}", flush=True)
        return self

    def close(self):
        self._log_f.close()

    # ----------------------------------------------------------- batch prep
    def _draw_examples(self, n: int):
        return [self.dataset[(self.sampler.sample(), True)] for _ in range(n)]

    def _own_rows(self, fn, items, n: int):
        """`fn(items)` over the whole batch of `n` rows; under a dp mesh each
        rank runs `fn` on its own rows and the results are gathered (every
        rank then holds the same global tensors). `fn` returns a tensor, or a
        tuple of tensors or Nones."""
        idx = None if self.mesh is None else self.mesh.local_rows(n)
        if idx is None:
            return fn(items)
        out = fn(items[idx] if isinstance(items, np.ndarray) else [items[i] for i in idx])
        gather = lambda t: self.mesh.gather_rows(t, n)
        return tuple(gather(t) for t in out) if isinstance(out, tuple) else gather(out)

    @torch.no_grad()
    def _latents(self, images: np.ndarray) -> torch.Tensor:
        """VAE posterior means x scale factor; each dp rank encodes its own
        rows."""
        def encode(x):
            mean, _ = self.pipe.vae.encode(torch.as_tensor(x, device=self.device))
            return mean * SD_VAE_SCALE_FACTOR

        return self._own_rows(encode, np.asarray(images), len(images))

    def _shard(self, batch):
        """This rank's slice of a global batch (the batch itself on one
        device)."""
        return pmesh.shard_train_batch(self.mesh, batch)

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
    def _get_recon_step(self, use_bg_token: bool, use_wds: bool = False):
        """The recon step for this (bg token, webdataset composite) choice:
        each changes the battery and the bg recon weight."""
        key = (use_bg_token, use_wds)
        if key not in self._recon_steps:
            p, cfg = self.pipe, self.cfg
            self._recon_steps[key] = make_recon_train_step(
                p.clip, p.unet, p.base_sched, self.optimizer, skip_weights=p.skip_weights,
                bg_weight=(cfg.wds_bg_recon_weight if use_wds
                           else cfg.bg_recon_weight if use_bg_token else 0.0),
                emb_reg_weight=self._emb_reg_w, prompt_delta_weight=self._delta_w,
                complem_weight=cfg.fg_bg_complementary_loss_weight,
                xlayer_weight=cfg.fg_bg_xlayer_consist_loss_weight,
                wds_complem_weight=cfg.fg_wds_complementary_loss_weight if use_wds else 0.0,
                use_bg_token=use_bg_token, do_zero_shot=self.plan_cfg.do_zero_shot,
                bg_placeholders=self._bg_placeholders, mesh=self.mesh)
        return self._recon_steps[key]

    def _delta_prompt_battery(self, plan: IterPlan, ex):
        """(token ids [4B, T], slot maps) of the 4-type delta prompts
        (subj/cls x single/comp, bg variants when the plan uses the bg
        token; on a webdataset iteration the comp prompts are the single
        ones plus the background's extra), or None when the prompt-delta
        regularizer is off."""
        if self._delta_w <= 0:
            return None
        keys = ["subj_prompt_single", "subj_prompt_comp", "cls_prompt_single",
                "cls_prompt_comp"]
        sfx = "_bg" if (plan.use_background_token
                        and all(k + "_bg" in e for e in ex for k in keys)) else ""
        dp = [e[k + sfx].split("|")[0] for k in keys for e in ex]
        if plan.use_wds_comp:
            B = len(ex)
            for i, e in enumerate(ex):
                extra = e.get("wds_comp_extra", "")
                if extra:
                    dp[B + i] = dp[i] + extra  # subj_comp
                    dp[3 * B + i] = dp[2 * B + i] + extra  # cls_comp
        ids = self.pipe.tokenizer(dp)
        return ids, self.mgr.build_slot_maps(ids)

    # ------------------------------------------------------------ webdataset
    def _subject_spec(self, e: dict):
        """The SubjectSpec an example was drawn from."""
        return next((s for s in self.dataset.subjects if s.name == e.get("subject_name")),
                    self.dataset.subjects[0])

    def _composite(self, e: dict) -> None:
        """Fill the example's wds_* keys; the captions swap the bg token for
        the dedicated webdataset one only when that placeholder is
        registered."""
        spec = self._subject_spec(e)
        wbg = self.cfg.wds_background_string
        if wbg not in getattr(self.mgr, "placeholders", {}):
            wbg = None
        self.compositor.composite(e, spec.cls_delta_string,
                                  background_string=spec.background_string,
                                  wds_background_string=wbg)

    def _wds_extra_mask(self, ids: np.ndarray, slots: Dict,
                        extend_subj_by_one: bool = False) -> np.ndarray:
        """[B, T] comp-extra token mask of webdataset instances: real word
        tokens (not BOS, not EOS/padding) that are neither subject nor bg
        slots. With the class-flavored captions the class token right after
        the subject's slots counts as subject (`extend_subj_by_one`)."""
        ids = np.asarray(ids)
        tok = self.pipe.tokenizer
        real = ((ids != tok.bos_id) & (ids != tok.eos_id)).astype(np.float32)
        for s, m in slots.items():
            pos = np.asarray(m) >= 0
            is_bg = (s in getattr(self, "bg_placeholders", ())
                     or (s in getattr(self.mgr, "placeholders", {})
                         and self.mgr.placeholders[s].is_background))
            if extend_subj_by_one and not is_bg:
                ext = np.zeros_like(pos)
                ext[:, 1:] = pos[:, :-1]
                pos = pos | ext
            real = real * (~pos)
        return real

    def _wds_recon_swap(self, plan: IterPlan, ex) -> tuple:
        """Roll and apply a recon iteration's webdataset composite: the
        image becomes the fg-over-background overlay, the captions their
        wds variants (the class flavor, the class word after the subject,
        at a probability annealed 0.6 -> 0.1 over the first half of
        training), and a plan without the bg token takes it at 0.5 (0.95 in
        all, where the plan rolled 0.9). Changes `plan` in place. Returns
        (plan, use_wds, use_wds_cls)."""
        use_wds = self.compositor is not None and self.rng.random() < self.cfg.p_wds_comp_recon
        use_wds_cls = False
        if use_wds:
            for e in ex:
                self._composite(e)
            use_wds = all(e.get("has_wds_comp") for e in ex)
        if use_wds:
            p_cls = anneal_value(plan.training_percent, 0.5, (0.6, 0.1))
            use_wds_cls = (self.rng.random() < p_cls
                           and all("wds_cls_caption" in e for e in ex))
            ck = "wds_cls_caption" if use_wds_cls else "wds_caption"
            for e in ex:
                e["image"] = e["wds_image"]
                e["caption"] = e[ck]
                e["caption_bg"] = e.get(ck + "_bg", e[ck])
            if not plan.use_background_token and self.rng.random() < 0.5:
                plan.use_background_token = True
            plan.use_wds_comp = True
        return plan, use_wds, use_wds_cls

    def build_recon_batch(self, plan: IterPlan) -> ReconBatch:
        """Draw and prepare one recon batch (host RNG in the JAX order); on a
        webdataset composite `plan.use_wds_comp` comes back set. Global:
        batch_size x dp rows."""
        B = self.cfg.batch_size * self._dp
        ex = self._draw_examples(B)
        plan, use_wds, use_wds_cls = self._wds_recon_swap(plan, ex)
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
        if use_wds and self.cfg.fg_wds_complementary_loss_weight > 0:
            kw["wds_extra_token_mask"] = self._tensor(
                self._wds_extra_mask(ids, slots, extend_subj_by_one=use_wds_cls))
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
        step = self._get_recon_step(plan.use_background_token, plan.use_wds_comp)
        return step(self.mgr.embedders, self._shard(batch))

    # ------------------------------------------------------------ validation
    def _get_val_loss(self):
        """The validation pass's loss: the plain recon battery (bg weight 0,
        no prompt-delta term, no bg token), no gradient."""
        if self._val_loss is None:
            p, cfg = self.pipe, self.cfg
            self._val_loss = make_recon_train_step(
                p.clip, p.unet, p.base_sched, None, skip_weights=p.skip_weights,
                bg_weight=0.0, emb_reg_weight=self._emb_reg_w, prompt_delta_weight=0.0,
                complem_weight=cfg.fg_bg_complementary_loss_weight,
                xlayer_weight=cfg.fg_bg_xlayer_consist_loss_weight, use_bg_token=False,
                do_zero_shot=self.plan_cfg.do_zero_shot,
                bg_placeholders=self._bg_placeholders, mesh=self.mesh).loss_fn
        return self._val_loss

    def _val_plan(self) -> IterPlan:
        return IterPlan(iter_type=RECON,
                        training_percent=self.global_step / max(self.cfg.max_steps, 1))

    def _val_examples(self, n: int) -> list:
        return [self._val_dataset[(self._val_sampler.sample(), True)] for _ in range(n)]

    def _val_batch(self, B: int) -> ReconBatch:
        """One validation batch from the val stream (its dataset, sampler
        and RNG; the training stream is not touched)."""
        rng = self._val_rng
        ex = self._val_examples(B)
        batch_np = collate_examples(ex)
        latents = self._latents(batch_np["image"])
        lh, lw = latents.shape[1:3]
        ids, slots = self._prompt_batch(ex, "caption")
        t = sample_timesteps(rng, self._val_plan(), B, self.plan_cfg)
        return ReconBatch(
            latents=latents, token_ids=ids, slot_maps=slots,
            fg_mask=self._tensor(self._mask_to_latent(batch_np["fg_mask"], lh, lw)),
            timesteps=self._tensor(t, torch.int32),
            noise=self._tensor(rng.standard_normal(latents.shape)),
            img_mask=self._tensor(self._mask_to_latent(batch_np["aug_mask"], lh, lw)),
            have_fg_mask=self._tensor([float(e.get("has_fg_mask", True)) for e in ex]))

    def _check_val_stream(self):
        if self._val_sampler is None:
            raise RuntimeError("no validation stream: construct the trainer with "
                               "TrainerConfig(val_every_steps > 0) (or train.py --val_every N)")

    def _write_val(self, sums: Dict[str, float]) -> Dict:
        """Log the batch means of `sums` as `val/` rows (rank 0)."""
        rec: Dict = {"step": self.global_step}
        rec.update({f"val/{k}": v / self.cfg.val_batches for k, v in sums.items()})
        self._log_f.write(json.dumps(rec) + "\n")
        self._log_f.flush()
        if self._main:
            msg = " ".join(f"{k}={v:.4f}" for k, v in rec.items() if k != "step")
            print(f"[{self.global_step}/{self.cfg.max_steps}] val: {msg}", flush=True)
        return rec

    @torch.no_grad()
    def run_validation(self) -> Dict[str, float]:
        """One validation pass: the recon battery without gradients on
        `val_batches` batches of the val stream, logged as `val/` rows; with
        EMA on, the same batches over the shadow as `val/*_ema`; with an
        image logger, a sample grid of a val example's subject prompt."""
        self._check_val_stream()
        loss_fn = self._get_val_loss()
        arms = [("", self.mgr.embedders)]
        if self.ema_state is not None:
            arms.append(("_ema", self.ema_state.shadow))
        sums: Dict[str, float] = {}
        for _ in range(self.cfg.val_batches):
            batch = self._shard(self._val_batch(self.cfg.batch_size * self._dp))
            for suffix, emb in arms:
                _, metrics = loss_fn(emb, batch)
                for k, v in pmesh.metrics_mean(metrics, self.mesh).items():
                    sums[k + suffix] = sums.get(k + suffix, 0.0) + float(v)
        rec = self._write_val(sums)
        if self.image_logger is not None and self._main:
            ex = self._val_examples(1)[0]
            self.image_logger.log_samples(self.global_step, self.pipe, ex["subj_prompt_single"],
                                          tag="val_samples")
        return rec

    # ------------------------------------------------------- compositional
    def _get_compos_step(self):
        if self._compos_step is None:
            p = self.pipe
            self._compos_step = make_compos_distill_step(
                p.clip, p.unet, p.base_sched, self.optimizer, skip_weights=p.skip_weights,
                prompt_delta_weight=self._delta_w,
                mix_prompt_distill_weight=self.plan_cfg.mix_prompt_distill_weight,
                do_zero_shot=self.plan_cfg.do_zero_shot,
                bg_placeholders=self._bg_placeholders, empty_ctx=self._empty_ctx,
                mesh=self.mesh)
        return self._compos_step

    def _compos_x_start(self, plan: IterPlan, ex: list, latents: torch.Tensor,
                        fg_latent: np.ndarray, prompts: list):
        """x_start of a compos iteration over the CB blocks `ex`. Reuse-init
        when every block's subject has a cached entry whose iteration flags
        agree: the cached x_start, t, fg mask, prompt battery and flags are
        restored (the reconstruction was denoised under those prompts), and
        each subject's entry is popped once. Otherwise fresh: the training
        image's fg scaled onto noise when the plan asks for it and a mask
        has fg, else pure noise. Returns (latents, fg_latent, prompts,
        prev_t or None, the popped cache entries or None)."""
        prev_t, entries = None, None
        flag_keys = ("use_background_token", "comp_init_fg_from_training_image",
                     "use_wds_comp")
        if self.cached_inits is not None:
            cand = [self.cached_inits.peek(e["subject_name"]) for e in ex]
            if all(c is not None for c in cand) and all(
                    all(bool(c.get(k, False)) == bool(cand[0].get(k, False))
                        for k in flag_keys) for c in cand):
                popped = {e["subject_name"]: None for e in ex}
                for name in popped:
                    popped[name] = self.cached_inits.pop(name)
                entries = [popped[e["subject_name"]] for e in ex]
        if entries is not None:
            latents = self._tensor(np.concatenate([c["x_start"][:1] for c in entries]))
            prev_t = np.concatenate([np.asarray(c["t"][:1]) for c in entries])
            if all(c.get("fg_mask") is not None for c in entries):
                fg_latent = np.concatenate([np.asarray(c["fg_mask"])[:1] for c in entries])
            if all(c.get("prompts") is not None for c in entries):
                per = [list(c["prompts"]) for c in entries]
                prompts = [p[k] for k in range(4) for p in per]
            e0 = entries[0]
            plan.reuse_init_conds = True
            plan.do_teacher_filter = False
            plan.use_background_token = bool(
                e0.get("use_background_token", plan.use_background_token))
            plan.comp_init_fg_from_training_image = bool(
                e0.get("comp_init_fg_from_training_image", False))
            plan.use_wds_comp = bool(e0.get("use_wds_comp", False))
        elif plan.use_wds_comp:
            pass  # the bg-only webdataset image's latents stay as they are
        elif plan.comp_init_fg_from_training_image and float(fg_latent.sum()) > 0:
            x_np, fg_latent = init_x_with_fg_from_training_image(
                self.rng, latents.float().cpu().numpy(), fg_latent, plan.training_percent)
            latents = self._tensor(x_np)
        else:
            plan.comp_init_fg_from_training_image = False
            latents = self._tensor(self.rng.standard_normal(tuple(latents.shape)))
        return latents, fg_latent, prompts, prev_t, entries

    def _cache_teacher_recon(self, e: dict, x_recon, t, fg_latent, plan: IterPlan, prompts,
                             **zs_extra):
        """Cache a reconstruction for a later reuse-init iteration of this
        subject, with the conditioning it was denoised under (this block's
        4 prompts and the plan's flags; on the zero-shot path its reference
        features through `zs_extra`)."""
        if self.cached_inits is None:
            return
        host = lambda a: a.detach().float().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
        self.cached_inits.put(
            e["subject_name"], host(x_recon), host(t), fg_mask=host(fg_latent),
            prompts=list(prompts), use_background_token=bool(plan.use_background_token),
            comp_init_fg_from_training_image=bool(plan.comp_init_fg_from_training_image),
            use_wds_comp=bool(plan.use_wds_comp), **zs_extra)

    def _filter_verdict_per_block(self, verdict, n_cand: int, CB: int):
        """(any teachable, best candidate [CB], block teachable [CB]):
        `TeacherFilter.per_block`, where the thresholds live."""
        return self.teacher_filter.per_block(verdict, n_cand, CB)

    def _cache_filtered_blocks(self, ex, verdict, best, block_teachable, cand_t, fg_latent,
                               plan: IterPlan, prompts, n_cand: int, zs_extra_fn=None):
        """Each teachable block caches its best candidate's subject-context
        reconstruction (cand-major row best * CB + b) with its own 4 prompts
        and mask; `zs_extra_fn(b)` adds the zero-shot features."""
        CB = len(ex)
        for b in range(CB):
            if not block_teachable[b]:
                continue
            i = int(best[b]) * CB + b
            extra = zs_extra_fn(b) if zs_extra_fn is not None else {}
            self._cache_teacher_recon(
                ex[b], verdict.x_recons[i:i + 1], np.asarray(cand_t)[i:i + 1],
                np.asarray(fg_latent)[b:b + 1], plan, [prompts[k * CB + b] for k in range(4)],
                **extra)

    def _teacher_filter_block(self, plan: IterPlan, ex: list, latents: torch.Tensor,
                              fg_latent: np.ndarray, prompts: list, ctx_fn,
                              zs_extra_fn=None):
        """The teacher filter of a fresh compos iteration over the CB blocks
        `ex`, when it is on: `num_candidate_teachers` cand-major copies of the
        x_start with noise and timesteps drawn from the host RNG (after the
        batch's own), their contexts from `ctx_fn(cand_t)`, the verdict, the
        candidates' grid to the image logger when it is due. Returns None
        when the filter is off, "skip" when no block is teachable, else the
        chosen (noise, t) after caching the teachable blocks."""
        if (self.teacher_filter is None or not plan.do_teacher_filter
                or plan.reuse_init_conds):
            return None
        CB = len(ex)
        n_cand = self.plan_cfg.num_candidate_teachers
        cand_x = torch.cat([latents] * n_cand)
        cand_noise = self._tensor(self.rng.standard_normal(tuple(cand_x.shape)))
        cand_t = np.asarray(sample_timesteps(self.rng, plan, n_cand * CB, self.plan_cfg),
                            np.int32)
        ctx = ctx_fn(cand_t)
        log_now = (self.image_logger is not None
                   and self.image_logger.should_log(self.global_step))
        verdict = self._filter_candidates(cand_x, cand_noise, cand_t, ctx,
                                          prompts[3 * CB:] * n_cand, n_cand, CB, log_now)
        ok, best, block_ok = self._filter_verdict_per_block(verdict, n_cand, CB)
        if log_now and self._main:
            sel = {int(best[b]) * CB + b for b in range(CB) if block_ok[b]}
            colors = [2 if i % (n_cand * CB) in sel else 1 for i in range(2 * n_cand * CB)]
            self.image_logger.log_candidates(self.global_step, verdict.images, colors)
        if not ok:
            return "skip"
        rows = [int(best[b]) * CB + b for b in range(CB)]
        self._cache_filtered_blocks(ex, verdict, best, block_ok, cand_t, fg_latent, plan,
                                    prompts, n_cand, zs_extra_fn=zs_extra_fn)
        return cand_noise[rows], cand_t[rows]

    def _filter_candidates(self, cand_x, cand_noise, cand_t, ctx: Dict, cls_prompts: list,
                           n_cand: int, CB: int, with_images: bool):
        """The teacher filter's verdict over the cand-major [n_cand * CB]
        candidates. Under a dp mesh each rank denoises and scores the
        candidates of its own blocks; the CLIP losses, the subject rows'
        reconstructions (and, when the grid is due, the images) are gathered,
        so every rank takes the same per-block verdicts."""
        from adaface_tpu_torch.training.teacher_filter import FilterVerdict

        tf = self.teacher_filter
        N = n_cand * CB
        idx = None if self.mesh is None else self.mesh.local_rows(CB)
        if idx is None:
            return tf.filter(cand_x, cand_noise, self._tensor(cand_t, torch.int32),
                             ctx["subj_comp"], ctx["mix_comp"], ctx["uncond"], cls_prompts)
        rows = np.concatenate([c * CB + idx for c in range(n_cand)])
        pick = lambda t: t.index_select(1, torch.as_tensor(rows, device=t.device))
        u = ctx["uncond"]
        v = tf.filter(cand_x[rows], cand_noise[rows], self._tensor(cand_t[rows], torch.int32),
                      tuple(pick(t) for t in ctx["subj_comp"]),
                      tuple(pick(t) for t in ctx["mix_comp"]),
                      u if u.shape[1] == 1 else pick(u), [cls_prompts[i] for i in rows])
        n_loc = len(rows)

        def gather(local, n_rows_global, rows_global):
            full = torch.zeros((n_rows_global,) + tuple(local.shape[1:]), dtype=local.dtype,
                               device=self.device)
            full[torch.as_tensor(rows_global, device=self.device)] = local.to(self.device)
            return self.mesh.all_reduce_(full)

        losses = gather(torch.as_tensor(np.stack([v.losses_subj_comp, v.losses_mix_comp], 1),
                                        dtype=torch.float64), N, rows).cpu().numpy()
        x_recons = gather(v.x_recons[:n_loc], N, rows)
        images = None
        if with_images:
            both = np.concatenate([rows, rows + N])
            images = gather(torch.as_tensor(v.images.astype(np.int32)), 2 * N,
                            both).cpu().numpy().astype(np.uint8)
        return FilterVerdict(False, 0, losses[:, 0], losses[:, 1], images, x_recons)

    @torch.no_grad()
    def _compos_contexts(self, ids: np.ndarray, slots: Dict, plan: IterPlan, t: np.ndarray):
        """(subj_comp, mix_comp, uncond) contexts of the teacher filter's
        candidate denoise: the 4-type prompts encoded with the static
        subject embeddings patched in, the class word spread over the pad
        slots, then V/K-mixed."""
        ctx = self._distribute_cls_ctx(self.pipe._encode_patched(ids, slots), slots)
        subj = next(s for s, i in self.mgr.placeholders.items() if not i.is_background)
        return self._mix_ctx_for_filter(ctx, slots[subj], plan, t, ids.shape[1])

    @staticmethod
    def _distribute_cls_ctx(ctx: torch.Tensor, slots: Dict) -> torch.Tensor:
        """The class word spread over the multi-vector pad slots in the cls
        halves of an encoded 4-type context [L, 4B, T, D] (each
        placeholder's subject-prompt slot map, in sorted order)."""
        B = ctx.shape[1] // 4
        cs, cc = ctx[:, 2 * B:3 * B], ctx[:, 3 * B:]
        for s in sorted(slots):
            sm = np.asarray(slots[s])[:B]
            cs = EmbeddingManager.distribute_cls_embeddings(cs, sm)
            cc = EmbeddingManager.distribute_cls_embeddings(cc, sm)
        return torch.cat([ctx[:, :2 * B], cs, cc], dim=1)

    @torch.no_grad()
    def _mix_ctx_for_filter(self, ctx: torch.Tensor, subj_slot, plan: IterPlan, t: np.ndarray,
                            T: int) -> Dict:
        """The filter contexts from an encoded 4-type context [L, 4B, T, D]:
        subject-comp and class-comp rows repeated num_candidate_teachers
        times (cand-major), V/K-mixed at the candidates' t, and the empty
        prompt's context. Each of subj_comp / mix_comp is a (V, K) pair."""
        B = ctx.shape[1] // 4
        n_cand = self.plan_cfg.num_candidate_teachers
        sc = torch.cat([ctx[:, B:2 * B]] * n_cand, dim=1)
        cc = torch.cat([ctx[:, 3 * B:]] * n_cand, dim=1)
        tok = torch.as_tensor(np.asarray(subj_slot)[B:2 * B] >= 0, dtype=ctx.dtype,
                              device=ctx.device)
        r = self._cls_mix_ranges(plan)
        s_vk, m_vk = mix_static_vk_embeddings(
            sc, cc, torch.cat([tok] * n_cand), plan.training_percent,
            self._tensor(np.asarray(t) / self.plan_cfg.num_timesteps),
            v_cls_scale_range=(r[2], r[3]), k_cls_scale_range=(r[0], r[1]))
        return {"subj_comp": (s_vk[:, :, :T], s_vk[:, :, T:]),
                "mix_comp": (m_vk[:, :, :T], m_vk[:, :, T:]),
                "uncond": self.pipe.encode_negative("", n_cand * B)}

    def _wds_compos_swap(self, plan: IterPlan, ex: list) -> None:
        """A compos iteration's webdataset composite, at `p_wds_comp_compos`:
        every block starts from its bg-only background image (kept intact as
        x_start), with `comp_init_fg_from_training_image` forced on. All or
        nothing over the blocks (the plan's flags are batch-global). Changes
        `plan` and the examples in place; without a compositor it returns
        before any draw."""
        if self.compositor is None or self.rng.random() >= self.cfg.p_wds_comp_compos:
            return
        for e in ex:
            self._composite(e)
        if not all(e.get("has_wds_comp") for e in ex):
            return
        for e in ex:
            e["image"] = e["wds_image_bgonly"]
        plan.use_wds_comp = True
        plan.comp_init_fg_from_training_image = True

    def _wds_comp_prompts(self, plan: IterPlan, e: dict, prompts: list) -> list:
        """On a webdataset iteration, the comp prompts' extras replaced by
        the webdataset background's."""
        if not plan.use_wds_comp or not e.get("wds_comp_extra"):
            return prompts
        extra = e["wds_comp_extra"]
        return [prompts[0], prompts[0] + extra, prompts[2], prompts[2] + extra]

    def _compos_prompt_battery(self, plan: IterPlan, ex: list) -> list:
        """The type-major 4-type prompts over the CB blocks ([ss_0.., sc_0..,
        cs_0.., cc_0..]) with the richest suffix (_fp_bg, _fp, _bg, none)
        whose whole battery every block has."""
        bg, fp = plan.use_background_token, plan.use_fp_trick

        def keys_for(suffix):
            return [f"subj_prompt_single{suffix}", f"subj_prompt_comp{suffix}",
                    f"cls_prompt_single{suffix}", f"cls_prompt_comp{suffix}"]

        suffix = ""
        for cand in ((["_fp_bg"] if (fp and bg) else []) + (["_fp"] if fp else [])
                     + (["_bg"] if bg else []) + [""]):
            if all(k in e for e in ex for k in keys_for(cand)):
                suffix = cand
                break
        per_block = [self._wds_comp_prompts(plan, e, [e[k].split("|")[0]
                                                      for k in keys_for(suffix)])
                     for e in ex]
        return [p[k] for k in range(4) for p in per_block]

    def build_compos_batch(self, plan: IterPlan) -> Optional[ComposBatch]:
        """Draw and prepare one compos iteration (host RNG in the JAX order):
        one block a device (CB = dp); None when the teacher filter finds it
        unteachable."""
        CB = self._dp
        ex = self._draw_examples(CB)
        self._wds_compos_swap(plan, ex)
        prompts = self._compos_prompt_battery(plan, ex)
        latents = self._latents(np.stack([e["image"] for e in ex]))
        lh, lw = latents.shape[1:3]
        fg_latent = self._mask_to_latent(np.stack([e["fg_mask"] for e in ex]), lh, lw)
        for b, e in enumerate(ex):
            if not e.get("has_fg_mask", True):
                # a maskless instance must not preserve its all-1 default
                # mask; zeroing it also turns fg-init off
                fg_latent[b] = 0.0
        latents, fg_latent, prompts, prev_t, _ = self._compos_x_start(
            plan, ex, latents, fg_latent, prompts)
        # tokenized after the cache check: a reuse-init iteration restores
        # the cached prompts
        ids = self.pipe.tokenizer(prompts)
        slots = self.mgr.build_slot_maps(ids)
        subj_string = next(s for s, info in self.mgr.placeholders.items()
                           if not info.is_background)
        t = sample_timesteps(self.rng, plan, CB, self.plan_cfg, prev_t=prev_t)
        noise = self._tensor(self.rng.standard_normal(tuple(latents.shape)))
        chosen = self._teacher_filter_block(
            plan, ex, latents, fg_latent, prompts,
            lambda cand_t: self._compos_contexts(ids, slots, plan, cand_t))
        if chosen == "skip":
            return None
        if chosen is not None:
            noise, t = chosen
        compel_level, compel_mask = 0.0, None
        if self.cfg.apply_compel_cfg_prob > 0:
            compel_level, compel_mask = sample_compel_cfg(
                self.rng, self.cfg.apply_compel_cfg_prob,
                self.cfg.compel_cfg_weight_level_range, n_instances=4 * CB)
        kw = {}
        if plan.emb_noise_std > 0:
            kw = dict(emb_noise_std=float(plan.emb_noise_std),
                      emb_noise_seed=int(self.rng.integers(2 ** 31)))
        return ComposBatch(
            token_ids=ids, slot_maps=slots, subj_slot_map=slots[subj_string],
            latents=latents, fg_mask=self._tensor(fg_latent),
            timesteps=self._tensor(t, torch.int32), noise=noise,
            t_frac=self._tensor(t / self.plan_cfg.num_timesteps),
            training_percent=plan.training_percent,
            compel_level=compel_level,
            compel_batch_mask=None if compel_mask is None else self._tensor(compel_mask),
            cls_mix_ranges=self._cls_mix_ranges(plan),
            preserve_loss_scale=self._preserve_scale(plan),
            **self._skip_weights_kw(), **kw)

    def _run_compos(self, plan: IterPlan):
        batch = self.build_compos_batch(plan)
        if batch is None:  # unteachable: the distillation is skipped
            return SKIPPED_UNTEACHABLE
        return self._get_compos_step()(self.mgr.embedders, self._shard(batch))

    def _preserve_scale(self, plan: IterPlan) -> float:
        """The elastic-matching preserve battery's scale: on only when x_start
        was fg-initialized, halved again on a reuse-init iteration."""
        if not plan.comp_init_fg_from_training_image:
            return 0.0
        return 0.25 if plan.reuse_init_conds else 0.5

    def _cls_mix_ranges(self, plan: IterPlan) -> tuple:
        """[k_lb, k_ub, v_lb, v_ub] class-mix scale ranges of the V/K teacher
        contexts: zero-shot mixes more subject into V; fg-initialized
        iterations slightly less."""
        fg_init = plan.comp_init_fg_from_training_image
        if self.plan_cfg.do_zero_shot:
            k = (1.0, 0.8)
            v = (1.0, 0.7) if fg_init else (1.0, 0.6)
        else:
            k = (1.0, 1.0)
            v = (1.0, 0.85) if fg_init else (1.0, 0.7)
        return (*k, *v)

    # ------------------------------------------------------------- Arc2Face
    @staticmethod
    def _arc2face_batch_size(batch_size: int, S: int) -> int:
        """A multi-step iteration keeps the first of S chunks of the batch,
        ceil(batch_size / S) instances; a single-step one all of them."""
        return -(-batch_size // S) if S > 1 else batch_size

    def build_arc2face_batch(self, plan: IterPlan, ctx_fn) -> Arc2FaceBatch:
        """Draw and prepare one Arc2Face distillation batch (host RNG in the
        JAX order; `ctx_fn` draws from the teacher's own)."""
        S = plan.num_denoising_steps
        B = self._arc2face_batch_size(self.cfg.batch_size, S) * self._dp
        ex = self._draw_examples(B)
        batch_np = collate_examples(ex)
        latents = self._latents(batch_np["image"])
        lh, lw = latents.shape[1:3]
        ids, slots = self._prompt_batch(ex, "caption")
        t = sample_timesteps(self.rng, plan, B, self.plan_cfg)
        teacher_ctx = ctx_fn(ex, plan)
        img_kw = {}
        if not plan.gen_arc2face_rand_face:
            # a random-face iteration keeps the dataset's latents but
            # carries no augmentation mask (and its step ignores the fg mask)
            img_kw["img_mask"] = self._tensor(
                self._mask_to_latent(batch_np["aug_mask"], lh, lw))
        return Arc2FaceBatch(
            latents=latents, teacher_context=teacher_ctx.float(), token_ids=ids,
            slot_maps=slots, timesteps=self._tensor(t, torch.int32),
            noises=self._tensor(self.rng.standard_normal((S,) + tuple(latents.shape))),
            relative_ts=self._tensor(self.rng.uniform(size=(max(S - 1, 1), B))),
            fg_mask=self._tensor(self._mask_to_latent(batch_np["fg_mask"], lh, lw)),
            **img_kw, **self._skip_weights_kw())

    def _get_arc2face_step(self, plan: IterPlan, teacher_unet):
        key = (plan.num_denoising_steps, plan.gen_arc2face_rand_face, id(teacher_unet))
        if key not in self._a2f_steps:
            p = self.pipe
            # the configured skip weights are not passed: the JAX trainer's
            # step takes its default (0.5, 0.5) here
            self._a2f_steps[key] = make_arc2face_distill_step(
                p.clip, p.unet, teacher_unet, p.base_sched, self.optimizer,
                num_denoising_steps=plan.num_denoising_steps,
                use_fg_mask=not plan.gen_arc2face_rand_face, mesh=self.mesh)
        return self._a2f_steps[key]

    def _run_arc2face(self, plan: IterPlan, teacher):
        teacher_unet, ctx_fn = teacher
        batch = self.build_arc2face_batch(plan, ctx_fn)
        return self._get_arc2face_step(plan, teacher_unet)(self.mgr.embedders,
                                                           self._shard(batch))

    # ------------------------------------------------------------------ run
    def fit(self, num_steps: Optional[int] = None, arc2face_teacher=None):
        """Run the training loop until `num_steps` micro-steps (default
        max_steps) are done, in the JAX loop's order: step, log, EMA update,
        step count, a checkpoint SIGUSR1 asked for, every `val_every_steps`
        a validation pass, then every `ckpt_every_steps` a checkpoint and
        the resumable state. On an
        exception the checkpoint and state are saved as `exception`.
        `arc2face_teacher`: a (teacher_unet, ctx_fn(examples, plan) -> [B,
        T, D]) pair (`Arc2FaceTeacher.as_tuple()`) turning Arc2Face plans
        into distillation iterations."""
        n = num_steps or self.cfg.max_steps
        t0 = time.time()
        try:
            while self.global_step < n:
                plan = plan_iteration(self.rng, self.global_step, self.plan_cfg)
                if plan.iter_type == ARC2FACE_DISTILL and arc2face_teacher is None:
                    plan.iter_type = RECON
                if plan.iter_type == COMPOS_DISTILL:
                    metrics = self._run_compos(plan)
                elif plan.iter_type == ARC2FACE_DISTILL:
                    metrics = self._run_arc2face(plan, arc2face_teacher)
                else:
                    metrics = self._run_recon(plan)
                self._log(metrics, plan)
                if self.ema_state is not None:
                    self.ema_state = ema_update(self.ema_state, self.mgr.embedders,
                                                self.cfg.ema_decay)
                self.global_step += 1
                if self._sig_ckpt_requested:
                    self.save_checkpoint()
                    self._sig_ckpt_requested = False
                if (self.cfg.val_every_steps > 0
                        and self.global_step % self.cfg.val_every_steps == 0):
                    self.run_validation()
                if self.global_step % self.cfg.ckpt_every_steps == 0:
                    self.save_checkpoint()
                    self.save_state()
                    self._log_run_summary(t0)
        except KeyboardInterrupt:
            self.save_checkpoint("interrupted")
            raise
        except Exception:
            self.save_checkpoint("exception")
            self.save_state(os.path.join(self.cfg.logdir, "train_state_exception.pt"))
            raise
        self.save_checkpoint("last")
        dt = time.time() - t0
        self._log_run_summary(t0)
        if self._main:
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
        if not self._main:
            return
        mem = f", peak memory {rec['peak_mem_gib']:.2f} GiB" if "peak_mem_gib" in rec else ""
        print(f"[summary] {self.global_step} steps, {dt:.1f}s "
              f"({rec['steps_per_sec']:.2f} it/s){mem}", flush=True)
