"""Host-side iteration planning (the port's own copy of
`adaface_tpu/training/iter_plan.py`, numpy only, unchanged in behavior).

`plan_iteration(rng, step, cfg)` -> `IterPlan` rolls the whole iteration on
the host before the step runs: type (recon, compositional distillation,
Arc2Face distillation), background token, fp trick, embedding noise; and
`sample_timesteps` draws the per-type timesteps. Probabilities and
t-sampling strategies are the reference's (citations inline).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

RECON = "recon"
COMPOS_DISTILL = "compos_distill"
ARC2FACE_DISTILL = "arc2face_distill"


@dataclasses.dataclass
class IterPlanConfig:
    """Static training-policy knobs (`ddpm.py:109-177` defaults +
    `v1-finetune-ada.yaml`)."""

    composition_regs_iter_gap: int = 3
    # the ada (zero-shot flagship) value, `v1-finetune-ada.yaml:40`; the
    # static-layerwise/ti configs override to 2e-4. Since round 4 this is
    # the ACTUAL compos mix-distill loss weight (not just the
    # teacher-filter gate), so the default must match the reference yaml.
    mix_prompt_distill_weight: float = 1e-4
    prompt_emb_delta_reg_weight: float = 2e-4
    arc2face_distill_iter_prob: float = 0.0
    p_gen_arc2face_rand_face: float = 0.4  # `ddpm.py:130`
    p_add_noise_to_real_id_embs: float = 0.6  # `ddpm.py:131`
    p_use_fp_trick: float = 0.9  # `ddpm.py:1480`
    use_fp_trick: bool = True
    p_use_background_token_recon: float = 0.9  # `ddpm.py:1574-1579`
    p_use_background_token_compos: float = 0.5  # `ddpm.py:1561`
    p_reuse_init_conds: float = 1.0  # 0.25 in mix-subject folders (`:1457-1458`)
    num_candidate_teachers: int = 2  # `ddpm.py:121`
    num_timesteps: int = 1000
    max_steps: int = 2000
    do_zero_shot: bool = True
    # multi-step arc2face distillation: 1/3/5/7 teacher steps drawn with
    # p=[0.4, 0.3, 0.2, 0.1] (`:1835-1851`); candidates above
    # max_num_denoising_steps are dropped and the probs renormalized
    # (CLI default 7, `main.py:272`)
    arc2face_denoising_steps: tuple = (1, 3, 5, 7)
    arc2face_denoising_step_probs: tuple = (0.4, 0.3, 0.2, 0.1)
    max_num_denoising_steps: int = 7
    # annealed embedding-noise injection (`v1-finetune-ada.yaml:96-101`,
    # `anneal_add_noise_to_embedding`, `ldm/util.py:2384-2399`)
    emb_noise_begin_std_range: tuple = (0.02, 0.04)
    emb_noise_end_std_range: tuple = (0.02, 0.04)
    emb_noise_prob: dict = dataclasses.field(default_factory=lambda: {
        RECON: 0.6, ARC2FACE_DISTILL: 0.0, COMPOS_DISTILL: 0.4})


@dataclasses.dataclass
class IterPlan:
    """Everything the host training loop needs to assemble one iteration."""

    iter_type: str = RECON
    training_percent: float = 0.0
    do_prompt_delta_reg: bool = True
    use_background_token: bool = False
    use_fp_trick: bool = False
    reuse_init_conds: bool = False
    do_teacher_filter: bool = False
    calc_clip_loss: bool = False
    # fresh compos iters: start from the training image's scaled-down fg on
    # noise (`init_x_with_fg_from_training_image`) vs pure noise
    # (`ddpm.py:1534-1557`: p=1 zero-shot, annealed 0.7->0.9 otherwise)
    comp_init_fg_from_training_image: bool = False
    # arc2face
    gen_arc2face_rand_face: bool = False
    add_noise_to_real_id_embs: bool = False
    num_denoising_steps: int = 1
    emb_noise_std: float = 0.0  # 0 = no noise this iteration
    # wds background compositing this iteration (`ddpm.py:1485-1532`):
    # recon iters train on the fg-over-new-bg overlay, compos iters start
    # from the bg-only image kept intact. Rolled by the trainer (needs the
    # compositor), restored from the cache on reuse-init (`ddpm.py:1911`)
    use_wds_comp: bool = False


def anneal_value(training_percent: float, final_percent: float,
                 value_range) -> float:
    """Linear anneal, clamped at final (`ldm/util.py:1708-1717`)."""
    v_init, v_final = value_range
    if training_percent < final_percent:
        return v_init + (v_final - v_init) * training_percent
    return v_final


def probably_anneal_t(t: np.ndarray, training_percent: float,
                      num_timesteps: int, ratio_range,
                      keep_prob_range=(0.0, 0.5),
                      rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Per-element t rescaling with an annealed keep probability
    (`probably_anneal_t`, `ldm/util.py:1748-1770`)."""
    rng = rng or np.random.default_rng()
    keep_p = anneal_value(training_percent, 1.0, keep_prob_range)
    if rng.random() < keep_p:
        return t
    lb, ub = ratio_range
    t = np.asarray(t)
    # float32 products like the reference's torch scalar arithmetic —
    # float64 rounds t*ratio differently at e.g. 700*1.3 (911 vs 910),
    # shifting a bound by 1
    lo = np.clip((t.astype(np.float32) * np.float32(lb)).astype(np.int64),
                 0, num_timesteps - 1)
    hi = np.minimum((t.astype(np.float32) * np.float32(ub)).astype(np.int64)
                    + 1, num_timesteps)
    return rng.integers(lo, hi)


def sample_emb_noise_std(rng: np.random.Generator, plan: "IterPlan",
                         cfg: IterPlanConfig) -> float:
    """Host half of `anneal_add_noise_to_embedding`: the std (or 0) for
    this iteration; the relative-std noise applies in-graph."""
    prob = cfg.emb_noise_prob.get(plan.iter_type, 0.0)
    if rng.random() > prob:
        return 0.0
    lb = anneal_value(plan.training_percent, 1.0,
                      (cfg.emb_noise_begin_std_range[0],
                       cfg.emb_noise_end_std_range[0]))
    ub = anneal_value(plan.training_percent, 1.0,
                      (cfg.emb_noise_begin_std_range[1],
                       cfg.emb_noise_end_std_range[1]))
    return float(rng.uniform(lb, ub))


def plan_iteration(rng: np.random.Generator, global_step: int,
                   cfg: IterPlanConfig) -> IterPlan:
    """One host-side dice roll (`training_step`, `ddpm.py:519-576` +
    `shared_step` flag logic)."""
    plan = IterPlan(training_percent=min(global_step / max(cfg.max_steps, 1), 1.0))

    # compositional distillation every composition_regs_iter_gap steps
    if (cfg.composition_regs_iter_gap > 0
            and (cfg.mix_prompt_distill_weight > 0
                 or cfg.prompt_emb_delta_reg_weight > 0)
            and global_step % cfg.composition_regs_iter_gap == 0):
        plan.iter_type = COMPOS_DISTILL
        plan.calc_clip_loss = True
        plan.do_teacher_filter = cfg.mix_prompt_distill_weight > 0
        plan.reuse_init_conds = False  # caller flips it when a cache entry exists
        plan.use_fp_trick = (cfg.use_fp_trick
                             and rng.random() < cfg.p_use_fp_trick)
        plan.use_background_token = (
            rng.random() < cfg.p_use_background_token_compos)
        p_fg_init = 1.0 if cfg.do_zero_shot else anneal_value(
            plan.training_percent, 0.5, (0.7, 0.9))
        plan.comp_init_fg_from_training_image = rng.random() < p_fg_init
        plan.emb_noise_std = sample_emb_noise_std(rng, plan, cfg)
        return plan

    # arc2face distillation iters carved out of recon iters (`:572-576`)
    if cfg.arc2face_distill_iter_prob > 0 and rng.random() < cfg.arc2face_distill_iter_prob:
        plan.iter_type = ARC2FACE_DISTILL
        plan.do_prompt_delta_reg = False  # `:575-576`
        plan.gen_arc2face_rand_face = rng.random() < cfg.p_gen_arc2face_rand_face
        if not plan.gen_arc2face_rand_face:
            plan.add_noise_to_real_id_embs = (
                rng.random() < cfg.p_add_noise_to_real_id_embs)
        cand = [s for s in cfg.arc2face_denoising_steps
                if s <= cfg.max_num_denoising_steps]
        p = np.asarray(cfg.arc2face_denoising_step_probs[:len(cand)],
                       np.float64)
        plan.num_denoising_steps = int(
            rng.choice(np.asarray(cand), p=p / p.sum()))
        plan.emb_noise_std = sample_emb_noise_std(rng, plan, cfg)
        return plan

    plan.iter_type = RECON
    plan.use_background_token = (
        rng.random() < cfg.p_use_background_token_recon)
    plan.emb_noise_std = sample_emb_noise_std(rng, plan, cfg)
    return plan


def sample_timesteps(rng: np.random.Generator, plan: IterPlan,
                     batch_size: int, cfg: IterPlanConfig,
                     prev_t: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-iteration-type t sampling (`ddpm.py:2604-2862`)."""
    T = cfg.num_timesteps
    if plan.iter_type == COMPOS_DISTILL:
        if plan.reuse_init_conds and prev_t is not None:
            # mid-range, >= 150 steps below the previous t (`:2627-2635`)
            t_mid = rng.integers(int(T * 0.4), int(T * 0.7), batch_size)
            return np.minimum(t_mid, prev_t - int(T * 0.15))
        return rng.integers(int(T * 0.8), T, batch_size)  # `:2639-2642`

    t = rng.integers(0, T, batch_size)
    if plan.use_wds_comp and plan.iter_type == RECON:
        # wds recon iters DECREASE t to preserve more semantics — overlay
        # backgrounds are out-of-domain and intrinsically hard to denoise
        # (`ddpm.py:2841-2847`)
        return probably_anneal_t(t, plan.training_percent, T, (0.8, 1.0),
                                 keep_prob_range=(0.5, 0.3), rng=rng)
    if plan.iter_type == ARC2FACE_DISTILL or cfg.do_zero_shot:
        t = probably_anneal_t(t, plan.training_percent, T, (1.0, 1.3),
                              keep_prob_range=(0.4, 0.2), rng=rng)
        if plan.num_denoising_steps > 1:
            # shift t upward for multi-step trajectories (`:2852-2856`)
            n = plan.num_denoising_steps
            t = (4 * t + (n - 1) * T) // (3 + n)
    else:
        t = probably_anneal_t(t, plan.training_percent, T, (1.0, 1.3),
                              keep_prob_range=(0.4, 0.2), rng=rng)
    return np.asarray(t)
