"""CLIP teacher filtering for compositional distillation, and its reuse-init
cache (counterpart of `adaface_tpu/training/teacher_filter.py`).

Before the distillation pass with gradients, `num_candidate_teachers`
candidate (x_start, noise, t) draws of each block are denoised without
gradients: the UNet's eps under the subject-comp contexts (student rows) and
the class-mixed comp contexts (teacher rows), and under the empty prompt's;
CFG at 5 for the student rows and 6 for the teacher rows; x0 from eps; the
VAE decode. The images are CLIP-T scored against the class-comp prompt
(`diag`). A candidate is teachable when its teacher image clears `0.5 -
CLIP-T <= clip_loss_thres` and beats the student by more than
`cls_subj_clip_margin`; each block takes its teachable candidate of the
largest teacher-student gap, or, riding along a partly teachable batch, its
best-scoring one. The best candidate's reconstruction under the subject
context seeds a later reuse-init iteration (`CachedInits`).

The UNet calls run the port's flash forward on the card (no gradients, so no
backward kernel); the decision is two floats per candidate on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from adaface_tpu_torch.models.vae import SD_VAE_SCALE_FACTOR

# the reference's gen_cfg_scales_for_stu_tea(6, 5): teacher (mix-comp) rows
# 6, student (subj-comp) rows 5
STUDENT_CFG_SCALE = 5.0
TEACHER_CFG_SCALE = 6.0


def _host(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@dataclasses.dataclass
class FilterVerdict:
    is_teachable: bool
    best_cand_idx: int
    losses_subj_comp: np.ndarray  # [N]
    losses_mix_comp: np.ndarray  # [N]
    images: np.ndarray  # [2N, H, W, 3] uint8 (subj-comp rows, then mix-comp rows)
    # the CFG x0 reconstructions [2N, h, w, 4]; a reuse-init iteration caches
    # the best candidate's subject row
    x_recons: Optional[torch.Tensor] = None


class TeacherFilter:
    def __init__(self, clip_scorer, unet, vae, sched, clip_loss_thres: float = 0.28,
                 cls_subj_clip_margin: float = 0.002,
                 student_cfg_scale: float = STUDENT_CFG_SCALE,
                 teacher_cfg_scale: float = TEACHER_CFG_SCALE):
        self.clip_scorer = clip_scorer
        self.unet, self.vae, self.sched = unet, vae, sched
        self.clip_loss_thres = clip_loss_thres
        self.cls_subj_clip_margin = cls_subj_clip_margin
        self.student_cfg_scale = student_cfg_scale
        self.teacher_cfg_scale = teacher_cfg_scale

    @torch.no_grad()
    def denoise(self, x_start, noise, t, ctx_v, ctx_k, uncond_ctx, cfg_scales):
        """One candidate denoise: eps at t under the comp contexts (V and K)
        and under the uncond context, CFG per row, x0 from eps, the VAE
        decode. Returns (images in [0, 1] [N, H, W, 3], x0 [N, h, w, 4])."""
        x_noisy = self.sched.q_sample(x_start, t, noise)
        eps_c = self.unet(x_noisy, t, ctx_v, context_k=ctx_k)
        eps_u = self.unet(x_noisy, t, uncond_ctx)
        eps = eps_u + cfg_scales[:, None, None, None] * (eps_c - eps_u)
        x0 = self.sched.predict_x0_from_eps(x_noisy, t, eps)
        imgs = self.vae.decode(x0 / SD_VAE_SCALE_FACTOR).float()
        return torch.clamp((imgs + 1.0) / 2.0, 0.0, 1.0), x0

    def filter(self, x_start: torch.Tensor, noise: torch.Tensor, t: torch.Tensor,
               subj_comp_ctx: Tuple[torch.Tensor, torch.Tensor],
               mix_comp_ctx: Tuple[torch.Tensor, torch.Tensor],
               uncond_ctx: torch.Tensor, cls_comp_prompt) -> FilterVerdict:
        """x_start / noise [N, h, w, 4], t [N] int; the comp contexts (V, K),
        each [L, N, T, D]; uncond [1 or L, N, T, D]; `cls_comp_prompt` a
        string or N strings (one per cand-major row)."""
        N = x_start.shape[0]
        dev = x_start.device
        two = lambda a, dim=0: torch.cat([a, a], dim=dim)
        ctx_v = torch.cat([subj_comp_ctx[0], mix_comp_ctx[0]], dim=1)
        ctx_k = torch.cat([subj_comp_ctx[1], mix_comp_ctx[1]], dim=1)
        scales = torch.tensor([self.student_cfg_scale] * N + [self.teacher_cfg_scale] * N,
                              dtype=torch.float32, device=dev)
        imgs, x0 = self.denoise(two(x_start), two(noise), two(t), ctx_v, ctx_k,
                                two(uncond_ctx, 1), scales)
        imgs255 = (imgs * 255).to(torch.uint8).cpu().numpy()  # truncation, as in JAX
        pl = ([cls_comp_prompt] * N if isinstance(cls_comp_prompt, str)
              else list(cls_comp_prompt))
        assert len(pl) == N, f"{len(pl)} prompts for {N} candidates"
        sims = self.clip_scorer.txt_to_img_similarity(pl + pl, imgs255, reduction="diag")
        losses = 0.5 - _host(sims)
        verdict = FilterVerdict(False, 0, losses[:N], losses[N:], imgs255, x0)
        any_ok, best, _ = self.per_block(verdict, n_cand=N, CB=1)
        verdict.is_teachable = any_ok
        verdict.best_cand_idx = int(best[0])
        return verdict

    def per_block(self, verdict: FilterVerdict, n_cand: int, CB: int):
        """Per-block teachability over a cand-major [n_cand * CB] verdict:
        (any teachable, best candidate [CB], block teachable [CB])."""
        l_subj = np.asarray(verdict.losses_subj_comp).reshape(n_cand, CB)
        l_mix = np.asarray(verdict.losses_mix_comp).reshape(n_cand, CB)
        diffs = l_subj - l_mix
        teachable = (l_mix <= self.clip_loss_thres) & (diffs > self.cls_subj_clip_margin)
        block_ok = teachable.any(axis=0)
        best_teachable = np.argmax(np.where(teachable, diffs, -1e4), axis=0)
        best_scoring = np.argmax(diffs, axis=0)
        best = np.where(block_ok, best_teachable, best_scoring)
        return bool(block_ok.any()), best, block_ok


class CachedInits:
    """Per subject, one cached reconstruction with the iteration context it
    was made under; a later compositional iteration pops it and reuses it as
    x_start at mid-range t."""

    def __init__(self):
        self._store: Dict[str, dict] = {}

    def put(self, subject: str, x_start, t, **extra):
        """`extra` carries the iteration context: fg_mask, prompts,
        use_background_token, comp_init_fg_from_training_image, ..."""
        self._store[subject] = {"x_start": np.asarray(x_start), "t": np.asarray(t), **extra}

    def peek(self, subject: str) -> Optional[dict]:
        return self._store.get(subject)

    def pop(self, subject: str) -> Optional[dict]:
        return self._store.pop(subject, None)

    def __contains__(self, subject: str) -> bool:
        return subject in self._store
