#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port (`adaface_tpu_torch`) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. card: name and power limit (nvidia-smi), torch/CUDA versions, TF32 off;
  2. build: every CUDA kernel source in `adaface_tpu_torch/csrc/`, one nvcc
     each, started together; each instantiation's registers and spills
     printed (ptxas -v); no library may spill; the SASS (cuobjdump) of the
     bf16 flash forward and backward, the feed-forward (K9) and the
     Winograd conv (K10) must run their products on wgmma (HGMMA), not
     mma.sync, and that of the fp32 kernels (flash, K9, K10) and of the
     GroupNorm+SiLU (K8, both instances) on FFMA alone;
  3. forward kernel vs plain: the packed flash-attention forward against its
     plain fp32 PyTorch version at every generate shape, a fused-qkv input
     and a key bias with a fully masked row, each gated on max abs and
     relative L2 error; planted faults must fail the same gate; kernel,
     plain and SDPA times;
  4. backward kernels vs plain: at the training shapes (B3 L4096 d40, B3
     L1024 d80, B3 L256 d160, with a 30% key mask plus a fully masked batch
     row, and without bias), the forward's lse and the dq and dk/dv/dbias
     kernels against the plain backward on the same bf16 inputs; planted
     faults (a skipped 64-key tile, delta omitted, dk without its scale, the
     last query tile of dk/dv skipped) must fail the gate; two launches
     must agree bit for bit; kernel, plain and SDPA-backward times, and the
     lse's plain and memory-efficient-attention times;
  5. reference: the SD-width CLIP, UNet and VAE in bf16 on the card against
     the same weights in fp32 on the CPU, on a small input;
  6. generate: `StableDiffusionPipeline.generate` at SD-v1.5 width, batch
     8, 512x512, DDIM-50, CFG 10->4, bf16, random weights, one 9-vector
     subject placeholder: one warm-up and 3 timed requests, each of which
     must launch the forward kernel exactly 750 times;
  7. generate profile: stage times, and device time by kernel category and
     the device's idle share for one whole request;
  8. training reference: one recon loss and its embedder gradients at SD
     widths on a 32x32 latent, bf16 on the card against fp32 on the CPU;
  8b. compos reference: one compositional loss and its embedder gradients
     at SD widths on a 64x64 latent (512x512 images, one block: 4 UNet
     rows), bf16 against an fp32 copy on the card (einsum attention, the
     fused knobs off, TF32 off), at the same gates;
  9. training: `Trainer.fit` on `configs/finetune-static-layerwise.yaml`'s
     values (batch 3, 512x512, 2-step accumulation, Prodigy, clip 0.5,
     `composition_regs_iter_gap` 3) for 8 micro-steps: each recon
     micro-step must launch exactly 15 forward, 14 dq and 14 dk/dv kernels
     at batch 3 (the UNet's first self-attention precedes everything
     trained, so it has no backward), each compos micro-step (0, 3, 6) as
     many at batch 4 without key bias (`COMPOS_SHAPES`); metrics finite,
     embedders moved, the checkpoint reloads; median s per recon and per
     compos micro-step, peak memory, one profiled micro-step of each kind.
The fused configuration (`FUSED_KNOBS`: the JAX package's
`ADAFACE_GN_MAX_ELEMS` and `ADAFACE_FUSED_FF` knobs, set in-process and
restored after each use) adds:
  4b. fused kernels vs plain: the GroupNorm+SiLU kernel (K8) and the
      LayerNorm + GEGLU feed-forward kernel (K9) against their plain fp32
      versions at every shape the fused generate and training paths give
      them (relative L2 and max abs gates; planted faults must fail them;
      two launches must agree bit for bit); kernel, bound, plain and
      default-arm times, for K8 also its launch plan, device time (the
      profiler's) and F.group_norm + F.silu's time, and for K9 its launch plan and the two cuBLAS
      products alone (`F.linear(y, w1)`, `F.linear(h, w2)`) as its library
      time; K8 also at `GN_EDGE_SHAPES` (one image, 8 rows, one channel a
      group, the widest C at N 1024, ragged rows, every cluster size, a
      partial warp, C 6144 on the one-row-lane launch), and at
      `GN_TAIL_SHAPES` with pre-activations in [-12, -3], where each
      output element must be within GN_TAIL_REL_TOL of the plain version
      and a kernel built with the tanh.approx SiLU (`GN_TANH_PATCHES`) must
      not; K9 at `FF_EDGE_SHAPES` (one row,
      ragged row blocks, its 64- and 128-column tile instances, the deepest
      split), agreement and repeats only;
  5b. the reference UNet comparison again under the knobs (31 K8 and 16 K9
      launches at its small input);
  6b. generate under the knobs: one warm-up and 2 timed requests, each of
      which must launch exactly 750 flash forwards, 2,250 K8 and 800 K9;
      one profiled request;
  9b. training under the knobs: 4 micro-steps (compos 0 and 3), each with
      exactly 15/14/14 flash launches, 45 K8 and 4 K9 (the transformer
      blocks of layers 1, 2, 4 and 5; the others capture), at batch 3 on a
      recon micro-step and 4 on a compos one; metrics finite, embedders
      moved; one profiled micro-step.
The knob arms of the attention dispatch (the JAX package's `ADAFACE_FLASH_*`
knobs, set in-process and restored) and the Winograd conv add:
  4c. arm kernels vs plain: the forward kernel through the public entries
      under the knobs at the arms' new shapes: cross-attention with Lk 77
      padded to 128 (K4, and K5 under MAXFREE=0; a fully masked row must
      average all 128 padded keys), K2 and K5 at the generate
      self-attention shapes, the [B*H, L, d] one-head fold (K6, K7), K1's
      EXP_BF16 / MXU_SUM arithmetic (and, at 8x scores, the default
      function must fail the comparison); then the backward kernels at the
      fold's and the cross-attention's training shapes, where dk/dv splits
      its query loop (a slice left out is a planted fault). Relative L2 and
      max abs gates, planted faults, repeats; kernel, plain, SDPA and
      default-arm times;
  4e. the backward at `BWD_EDGE_SHAPES` (one query row, ragged and unequal
      lengths, fused-projection thirds, each head dim) and at every split
      depth, agreement and repeats only; dk/dv timed at each split where
      the plan splits;
  4d. K10, the Winograd conv, at every 3x3 stride-1 conv shape of one
      generate UNet call (recorded by hooks) that the gates admit under
      ADAFACE_WINOGRAD=1, driven through `conv3x3_same`; against its plain
      version (planted faults: a position left out, a sign of A^T flipped,
      the bias dropped, the input transform rounded once or kept in fp32, a
      slice's partial dropped from a split's sum), at the launch plan's
      split and at another (split and unsplit), two launches bit for bit;
      kernel, bound, plain and F.conv2d times; one backward through the op;
  6c. generate under each of `ARM_CONFIGS` (K2, K5, K4 cross, K6, K7, K1
      flags, fuse_qkv, ADAFACE_CFG_DEDUP=0, ADAFACE_CROSS_KV=0): one
      warm-up and one timed request each, with
      exactly the expected launches by (TPU kernel id, shape); images bit
      for bit the default request's where the arm changes no arithmetic,
      else within ARM_UINT8_MEAN_TOL;
  9c. training under `PACKED=0` (K6) and `CROSS=1`: 2 recon-only
      micro-steps each with exact forward, dq and dk/dv launches by (arm,
      shape); metrics finite, embedders moved.
The compositional path adds:
  4f. the flash forward with its lse, dq and dk/dv at the compos shapes (B4
      L4096 d40, B4 L1024 d80, B4 L256 d160, no key bias, and with one),
      and K8 / K9 at the compos step's batch-4 shapes (in 4b's loops),
      against their plain versions with 4's and 4b's gates, planted faults
      and repeats; kernel, plain, bound and library times.
The fp32 path (slice 13) adds:
  4g. the fp32 flash kernel (`csrc/flash_attn_fp32.cu`, FFMA only: the
      build gate holds it to no spill, no HGMMA and no HMMA) through the
      wrappers on fp32 tensors: forward with lse, dq and dk/dv/dbias at the
      B3 and B4 training shapes with and without key bias, the forward at
      the four generate shapes of MAIN_SHAPES, against the plain fp32
      versions (relative L2 and max abs gates of 1e-5; planted faults must
      fail them, the forward's also as a patched kernel source,
      FP32_FAULTS["flash_fwd"]; two launches agree bit for bit); kernel,
      plain, SDPA (fp32) times and the bound; the forward's edge cases
      (FP32_FWD_EDGES: ragged Lq and Lk, a one-head fold, a fully masked
      row, a split key range with no key, unaligned rows, both K1 flag
      arms) against the plain version at the same gates;
  9d. the port's training entry point, `adaface_tpu_torch.train.main`,
      in-process on the seeded dataset at full SD width:
      `finetune-static-layerwise.yaml` in fp32 (4 micro-steps with exact
      fp32-kernel launches; the checkpoint reloads), `finetune-ti.yaml
      --bf16` (AdamW, K=1, no background token; 6 micro-steps), a run
      resumed from its step-3 state to step 6 (metrics within
      TRAIN_LOSS_TOL of the uninterrupted run's), `finetune-ada.yaml`
      with `model_options.use_remat=true` (exact launches, the recompute's
      forwards included), without (peak memory), and with it under the
      fused knobs (K9 twice in each non-capturing block, K8 once); median
      seconds per recon and compos micro-step and peak memory of each run.
The fp32 instances of K8, K9 and K10 (slice 14) add:
  4h. K8's fp32 instance (`csrc/gn_silu.cu`), K9 in fp32
      (`csrc/ln_geglu_ff_fp32.cu`) and K10 in fp32 (`csrc/winograd_fp32.cu`),
      FFMA only, through their wrappers on fp32 tensors against their plain
      fp32 versions at every shape of the fused paths and the 15 Winograd
      conv shapes (relative L2 and max abs of the largest value, 1e-5 each;
      K9 on out - x); each kernel's planted fault (`FP32_FAULTS`: a cluster
      peer's partial, an F chunk of GEMM2, a Winograd position left out),
      built as a text patch, must fail the gate; two launches agree bit for
      bit; K8 and K9 at their edge shapes; kernel, plain, library
      (F.group_norm + F.silu, cuBLAS SGEMMs and the unfused fp32 chain,
      F.conv2d; TF32 off) and bound times; `conv3x3_same` in fp32, whose
      gate sends some shapes to the direct conv as in JAX;
  [fp32-main]. an fp32 pipeline serves one request under the default knobs
      and one under the fused knobs (batch 8, 512x512, CFG, DDIM cut to
      FP32_REQUEST_STEPS): exact fp32 launches (flash; GN_SHAPES and
      FF_SHAPES of K8 and K9 per UNet call under the knobs, no bf16 one),
      images within ARM_UINT8_MEAN_TOL of each other;
  9e. the fp32 run of 9d (`finetune-static-layerwise.yaml`, no --bf16)
      again under the fused knobs: exact fp32 flash, K8 and K9 launches per
      micro-step and no bf16 K8 or K9 one, each loss within TRAIN_LOSS_TOL
      of 9d's fp32 run; s per micro-step and peak memory beside 9d's.
Slice 16 (the fp32 backward redesigned, the Upsample fold) adds:
  4g. the backward's patched-source faults (FP32_FAULTS "flash_dq": the
      last key tile left out of dq's ds K product; "flash_dkv": delta left
      out of ds) at every training shape, dq's and dk/dv's device time
      beside the CUDA events, and the backward's edge cases
      (FP32_BWD_EDGES: Lq != Lk, ragged lengths, unaligned rows, a fully
      masked batch row, the one-head fold, Lk 20 and Lq 20) at the fp32
      gates, with repeats bit for bit;
  [upsample]. the UNet's and the VAE's `Upsample` at the default request's
      six shapes (recorded by hooks): the default module gives the phase
      fold (one conv of zero-framed phase kernels) bit for bit, and the
      fold, the fold as JAX's four 2x2 convs and the naive upsample-then-conv
      (ADAFACE_SUBPIXEL_UP=0) timed side by side in bf16, each with its
      relative L2 error against the naive function in fp32;
  8, 8b. under the default Upsample, whose fold sums its taps in bf16 as
      JAX's default does, the fp32 reference folds the same taps in bf16
      and runs the rest in fp32; the loss within FOLD_LOSS_TOL (set from
      recorded readings: the loss error is one draw of the bf16 UNet's eps
      noise), the UNet's eps within TRAIN_EPS_TOL; both phases run again
      under ADAFACE_SUBPIXEL_UP=0 at TRAIN_LOSS_TOL and TRAIN_EPS_TOL, and
      the fold's eps error may exceed the naive path's by FOLD_EPS_RATIO
      at most.
Slice 17 (the fp32 K9 redesigned, with a launch plan) adds:
  4h. K9 fp32's rows print the plan and each GEMM's cuBLAS SGEMM time; at
      FF_FP32_FORCED it runs through its C entry under every GEMM2 width
      that divides C and every split of F (the fp32 gate, repeats bit for
      bit);
  [fp32-profile]. after [fp32-main], one fp32 request under the default
      knobs and one under the fused knobs through the profiler: device time
      by category (the fp32 kernels by name, fp32 K9 apart from bf16 K9)
      and the idle share.
Slice 18 (the fp32 K10 redesigned: narrow paths for Cin or Cout 4, the
general path on K9's design with a launch plan) adds:
  4h. K10 fp32's rows print the plan, each shape's planted fault is its
      path's (FP32_FAULTS "wino" general, "wino_narrow" narrow); at
      WINO_FP32_FORCED it runs through its C entry under every path the
      shape takes and every split (the fp32 gate, repeats bit for bit);
      WINO_FP32_EDGE_SHAPES (ragged M, Cin and Cout off 16, B1) through
      the wrapper; `conv3x3_same` itself timed at every shape, with its
      cached weight layout and with the layout made anew a call.
Slice 19 (zero-shot generation; no kernel of its own) adds:
  [zero-shot]. after [fp32-main], the zero-shot stack at the shipped
      model's widths in bf16 from seeds (a ViT-L/14 vision tower, a ViT-L/14
      text Arc2Face encoder, the fg generator on that config with K 16, the
      bg generator with K 4) on [main]'s UNet, VAE and CLIP, fed four
      512x512 reference images with fg masks and a seeded face embedder
      that finds no face in one: the three vision passes, the Arc2Face
      forward and generators, `encode_prompts` (stage ms), one warm-up and
      3 batch-8 requests at [main]'s point (s/request, peak GiB). Gates: the
      fg and bg features, both generators' outputs and the context each
      within its ZS_REL_TOL of the same code in fp32 on the CPU, while
      each of its faults (a second identity, fg features in place of bg
      ones) falls outside it; a second identity moves the context by more
      than ZS_MOVE_MIN and the same one repeats it bit for bit; each
      request's flash launches those of a [main] request;
      `generate(context=...)` images of the right shape.
Slice 20 (zero-shot training and Arc2Face distillation; no kernel of its
own) adds:
  4i. the flash forward with its lse, dq and dk/dv at batch 1
      (`ZS_B1_SHAPES`: a multi-step Arc2Face iteration keeps ceil(3 / S) = 1
      instance at S 3), with and without a key bias, against their plain
      versions with 4's gates, planted faults and repeats; kernel, plain,
      SDPA (forward and backward) and bound times; each launch's CTAs;
  [zs-train]. after 9d, `ZeroShotTrainer.fit` at full width (finetune-ada
      yaml's trainer values, zero-shot on): [main]'s UNet, VAE and CLIP in
      bf16, a second SD v1.5 UNet as the Arc2Face teacher, the zero-shot
      stack of [zero-shot] (the generators in fp32) over a seeded
      two-subject dataset with a faceless image; ZS_TRAIN_ROUNDS rounds of
      six scripted micro-step kinds (zs compos, zs recon with and without
      the bg token, zs Arc2Face S 1 on a real face, S 3 on a random face,
      S 3 on noised real ids), each with exact flash launches by kind and
      shape; the generators move at the first update and stay finite; the
      last checkpoint loads back bit for bit; s per micro-step kind, peak
      GiB, one profiled zs recon micro-step; one zs recon loss with its
      generator gradients and ZS_REF_A2F_DRAWS S 1 Arc2Face losses at 32x32
      latents, bf16 against fp32 on the CPU, each gate (the two losses,
      each generator's gradients) with planted faults of which one must
      fall outside it; `Trainer.fit(arc2face_teacher=)` at S 1
      and S 3 with exact launches; and the entry point with
      `--arc2face_unet` / `--arc2face_text_encoder` on the teacher written
      as diffusers and HF fp16 safetensors.
The last lines are one JSON object per kernel list, the card line, and
`{"ok": true, "device": {...}}`. Without a CUDA card, or without the package
beside it, the script exits non-zero and prints no result.
"""

import contextlib
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

# Published H100 SXM peaks (NVIDIA data sheet, dense) for the bounds.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
MUFU_EXP2_PER_CLOCK_PER_SM = 16  # CUDA programming guide, compute capability 9.0
# Kernel vs plain gate. With randn q, k, v each score is about N(0, 1), so the
# output is small (std about 0.026 at L4096, 0.05 at L1024, 0.10 at L256) and
# a loose absolute limit would pass a wrong kernel. The gate holds both the
# relative L2 error ||out - plain|| / ||plain|| and the max abs error per head
# dim (bf16 rounding of o and of the probabilities measured 1e-3..3e-3 abs on
# an H100). Planted faults (one 64-key tile skipped, a wrong softmax scale)
# must fail it, and the script checks that they do.
KERNEL_REL_TOL = 1e-2
KERNEL_ABS_TOL = {40: 5e-3, 80: 5e-3, 160: 1e-2}
MASKED_ROW_TOL = 1e-3  # the fully masked row vs the uniform average of v
# relative L2 error, bf16 on the card vs fp32 on the CPU through whole models;
# it grows with depth (measured on an H100: CLIP 1.0e-2, UNet 1.6e-2, VAE
# decoder 3.5e-2 with its ~30 convs at up to 512 channels)
REFERENCE_TOL = {"clip": 5e-2, "unet eps": 5e-2, "vae decode": 1e-1}
STEPS, BATCH, SIZE = 50, 8, 512
PROMPT = "a photo of a z , , , , , , , , person"
SOURCE = "adaface_tpu_torch/csrc/flash_attn_packed.cu"
FWD_LIB = "flash_attn_packed"
# products all wgmma (phase_build); none of these may spill, nor K8, which
# has no products
WGMMA_LIBS = (FWD_LIB, "flash_attn_bwd", "ln_geglu_ff", "winograd")
# the fp32 kernels (flash, K9, K10; K8's fp32 instance shares gn_silu with
# its bf16 one, which has no products): FFMA only, no tensor-core product
# (no HGMMA, no HMMA: JAX asks for fp32 products, which TF32 would not give)
FP32_LIB = "flash_attn_fp32"
FFMA_LIBS = (FP32_LIB, "gn_silu", "ln_geglu_ff_fp32", "winograd_fp32")
NOSPILL_LIBS = WGMMA_LIBS + FFMA_LIBS
BWD_SOURCE = "adaface_tpu_torch/csrc/flash_attn_bwd.cu"
K1 = "adaface_tpu/ops/flash_attention.py:578"  # _flash_kernel_heads_pvt
K4 = "adaface_tpu/ops/flash_attention.py:544"  # _flash_kernel_heads_short
K3A = "adaface_tpu/ops/flash_attention.py:236"  # _row_lse_kernel
K3B = "adaface_tpu/ops/flash_attention.py:252"  # _bwd_dq_kernel
K3C = "adaface_tpu/ops/flash_attention.py:272"  # _bwd_dkv_kernel
# (B, L, H, d) -> (TPU kernel replaced, launches per generate call)
MAIN_SHAPES = {
    (16, 4096, 8, 40): (K1, 200),
    (8, 4096, 8, 40): (K1, 50),   # CFG stem dedup: layer 1 runs at batch B
    (16, 1024, 8, 80): (K1, 250),
    (16, 256, 8, 160): (K4, 250),
}


# Training: (B, L, H, d) of every self-attention at L >= 256 in one recon
# micro-step at 512x512, batch 3 -> (TPU forward kernel, launches per
# micro-step of the forward, of dq and of dk/dv). Five self-attentions run
# at each shape. The first (layer 1) comes before anything that depends on
# the trained embedders, so autograd records no graph for it: it runs the
# forward without lse and no backward, as XLA drops its backward in JAX.
TRAIN_SHAPES = {(3, 4096, 8, 40): (K1, 5, 4), (3, 1024, 8, 80): (K1, 5, 5),
                (3, 256, 8, 160): (K4, 5, 5)}
# A compositional micro-step runs one UNet call over one block of 4 rows
# (subj_single, subj_comp, mix_single, mix_comp) with no key mask: the same
# self-attentions at batch 4, without bias. The distillation layers capture
# their cross-attention on the einsum path; their self-attention stays on the
# flash path. Again the first self-attention has no backward.
COMPOS_SHAPES = {(4, 4096, 8, 40): (K1, 5, 4), (4, 1024, 8, 80): (K1, 5, 5),
                 (4, 256, 8, 160): (K4, 5, 5)}
# the shipped configs' `composition_regs_iter_gap`: micro-steps 0, 3, 6, ...
# are compositional
COMPOS_GAP = 3
# the shipped configs, read by the port's own YAML reader
CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")
TRAIN_STEPS = 8  # micro-steps (compos 0, 3, 6), 4 optimizer updates
# Backward gate, kernel vs the plain fp32 backward on the same bf16 inputs.
# Measured on an H100 at these shapes: dq/dk/dv relative L2 2.2e-3..2.4e-3
# (bf16 rounding of ds, p and the outputs), max abs 1.0e-3..7.1e-3 growing
# with d; lse 2e-6 abs; dbias (fp32 sums of fp32 ds) relative 6e-7. Planted
# faults give relative L2 far above these limits; the script checks it.
BWD_REL_TOL = 1e-2
BWD_ABS_TOL = {40: 5e-3, 80: 1e-2, 160: 2.5e-2}
LSE_ABS_TOL = 1e-4
DBIAS_REL_TOL = 1e-4
# Training reference, bf16 card vs fp32 CPU through CLIP, the UNet forward
# and backward and the losses: relative error of the loss (measured 9.2e-5
# on an H100) and relative L2 error of each embedder leaf's gradient
# (measured 2.2e-2..2.7e-2).
TRAIN_LOSS_TOL = 1e-3
TRAIN_GRAD_TOL = 1e-1
# (8, 8b) the relative L2 error of the bf16 UNet's eps against the fp32
# reference's (measured 1.731e-2 recon and 1.736e-2 compos under either
# Upsample path on an H100), and how far the fold's may exceed the naive
# path's. The loss's relative error is one draw of what that eps noise does
# to the loss, and the two paths draw differently: recon 2.232e-3 under the
# fold (6.613e-4 naive), compos 9.565e-4 (9.421e-4). `upsample_probe.py`
# shows that the Upsample's own rounding does not move it (the whole
# Upsample computed in bf16 inside the fp32 reference leaves it near
# 2.3e-3). FOLD_LOSS_TOL is set from those readings.
TRAIN_EPS_TOL = 2.5e-2
FOLD_EPS_RATIO = 1.2
FOLD_LOSS_TOL = 3e-3
# (8b) the compos reference holds its loss and gradients to the same gates
# (B, Lq, Lk, H, d, key bias, q/k/v as thirds of one fused projection) that
# no path gives the backward but its wrappers take, checked for agreement
# only (dq, dk, dv at CROSS_BWD_ABS_TOL of the largest value and BWD_REL_TOL,
# dbias at DBIAS_REL_TOL): one query row, ragged Lq and Lk, Lq != Lk, strided
# fused-projection thirds, each head dim; the plan's split where it splits.
BWD_EDGE_SHAPES = [(1, 1, 64, 2, 40, True, False), (2, 333, 200, 3, 160, True, False),
                   (1, 1000, 77, 2, 80, False, False), (2, 130, 130, 8, 80, True, True),
                   (2, 517, 517, 8, 40, False, True), (3, 300, 4100, 1, 40, True, False),
                   (1, 700, 1100, 2, 160, False, False)]
# (B, Lq, Lk, H, d) run at every split 1..BWD_MAX_SPLIT (9 query tiles), and
# (B, Lq, Lk, H, d) of the training path where dk/dv is timed at each split
BWD_SPLIT_SHAPES = [(1, 520, 190, 2, 40), (1, 520, 190, 2, 80), (1, 520, 190, 2, 160)]
BWD_SPLIT_TIMED = [(3, 4096, 128, 8, 40), (3, 1024, 128, 8, 80), (3, 256, 256, 8, 160)]


# The fused configuration and its two kernels.
FUSED_KNOBS = {"ADAFACE_GN_MAX_ELEMS": "4194304", "ADAFACE_FUSED_FF": "1"}
GN_SOURCE = "adaface_tpu_torch/csrc/gn_silu.cu"
FF_SOURCE = "adaface_tpu_torch/csrc/ln_geglu_ff.cu"
K8 = "adaface_tpu/ops/fused_norm.py:67"  # _gn_silu_kernel
K9 = "adaface_tpu/ops/fused_ff.py:51"  # _ff_kernel
# (B, N, C) of the GroupNorm+SiLU sites of one UNet call at a 64x64 latent ->
# sites: 2 per ResBlock (22) and the output norm; the CFG stem's ResBlock
# runs at batch 8. Every site passes the gates at the threshold above (the
# largest slab, up_0_res_0's input, is 4096 x 960). 50 UNet calls a request.
# At C 320, 960 and 1920 a group (10, 30, 60 channels) is not a whole number
# of the kernel's 16-byte vectors.
GN_SHAPES = {(8, 4096, 320): 2, (16, 4096, 320): 6, (16, 4096, 640): 2,
             (16, 4096, 960): 1, (16, 1024, 320): 1, (16, 1024, 640): 6,
             (16, 1024, 960): 1, (16, 1024, 1280): 1, (16, 1024, 1920): 1,
             (16, 256, 640): 1, (16, 256, 1280): 6, (16, 256, 1920): 1,
             (16, 256, 2560): 2, (16, 64, 1280): 11, (16, 64, 2560): 3}
# the same sites at batch 3, per recon micro-step (one UNet call)
GN_TRAIN_SHAPES = {(3, 4096, 320): 8, (3, 4096, 640): 2, (3, 4096, 960): 1,
                   (3, 1024, 320): 1, (3, 1024, 640): 6, (3, 1024, 960): 1,
                   (3, 1024, 1280): 1, (3, 1024, 1920): 1, (3, 256, 640): 1,
                   (3, 256, 1280): 6, (3, 256, 1920): 1, (3, 256, 2560): 2,
                   (3, 64, 1280): 11, (3, 64, 2560): 3}
# (B, L, C) of the fused feed-forwards of one UNet call: all 16 transformer
# blocks in generate; in a recon micro-step only layers 1, 2, 4 and 5, since
# the blocks of DISTILL_LAYER_INDICES capture
FF_SHAPES = {(16, 4096, 320): 5, (16, 1024, 640): 5, (16, 256, 1280): 5, (16, 64, 1280): 1}
FF_TRAIN_SHAPES = {(3, 4096, 320): 2, (3, 1024, 640): 2}
# the same sites in a compos micro-step: batch 4, and K9 again only in the
# uncaptured layers 1, 2, 4 and 5
GN_COMPOS_SHAPES = {(4, n, c): k for (_, n, c), k in GN_TRAIN_SHAPES.items()}
FF_COMPOS_SHAPES = {(4, 4096, 320): 2, (4, 1024, 640): 2}
# (B, L, C, F) that no path gives K9 but its wrapper takes, checked for
# agreement only: one row, ragged row blocks, F not a multiple of 128 (64-
# column GEMM1 tiles), C not a multiple of 160 (128- and 64-column GEMM2
# tiles, of 128 and of 256 rows), the deepest split
FF_EDGE_SHAPES = [(1, 1, 320, 1280), (1, 129, 640, 2560), (2, 33, 64, 192),
                  (1, 200, 128, 512), (1, 8, 1280, 5120), (3, 1000, 1280, 5120),
                  (1, 9000, 192, 768), (1, 5000, 512, 2048)]
FUSED_TRAIN_STEPS = 4  # compos 0 and 3
# K8 gate, kernel (bf16 out) vs the plain fp32 function on the same bf16
# inputs. Measured on an H100 at all 29 shapes: relative L2 1.67e-3..1.69e-3,
# max abs up to 1.56e-2 (values up to ~8), which is the output's own bf16
# rounding. The inputs carry per-channel offsets and a ramp of -4..4 over
# the rows, as activations vary over an image, so that a stats chunk left
# out moves the statistics: that fault measured 8.4e-3 relative L2 (max abs
# 4.9e-2..5.7e-2) at its mildest shape, N 4096 x C 960, where the chunk is
# 1% of the rows.
GN_REL_TOL = 4e-3
GN_ABS_TOL = 2.5e-2
# The planted fault "row chunk 0 left out of the stats" leaves out the rows
# of the first stats chunk of the earlier two-launch kernel (about this many
# elements, a multiple of 8 rows), or CTA 0's rows where the launch plan
# gives a CTA more.
GN_FAULT_CHUNK_ELEMS = 32768
# (B, N, C) that no path gives K8 but its wrapper takes, checked for
# agreement and a bit-for-bit repeat only: one image; 8 rows (a cluster of
# 8, one row a CTA); one channel a group (C 32); the widest C at N 1024;
# ragged rows against the plan's rows per CTA (N 1000, 4100 and 203 over 16);
# clusters of 1, 2 and 4 (N 1, 3, 5); C 800, whose 500 threads end in a
# partial warp; C 6144, past the row-lane launch's 4096 (one row lane of
# 768 threads)
GN_EDGE_SHAPES = [(1, 4096, 320), (2, 8, 640), (4, 512, 32), (1, 1024, 2560),
                  (3, 1000, 960), (2, 4100, 640), (16, 203, 320), (160, 1, 64),
                  (64, 3, 128), (32, 5, 256), (2, 300, 800), (2, 64, 6144)]
# K8's SiLU tail: at these shapes every pre-activation lies in [-12, -3]
# (`gn_tail_inputs`), where SiLU is a small difference, and each output
# element must be within GN_TAIL_REL_TOL (one bf16 ulp; its own rounding is
# at most half of one) of the plain fp32 version. The planted fault is the
# kernel built with SiLU as h + h tanh.approx(h), h = y / 2 (tanh.approx is
# good to ~2^-11 absolute, and 1 + tanh(h) falls to 1e-5 at y = -12).
GN_TAIL_SHAPES = [(16, 1024, 640), (3, 4096, 320)]
GN_TAIL_REL_TOL = 2.0 ** -7
GN_SILU_LINE = "    f[j] = apply_silu ? __fdividef(y, 1.f + __expf(-y)) : y;"
GN_NORM8 = "template <typename T>\n__device__ __forceinline__ Raw8<T> norm8("
GN_TANH_PATCHES = [
    (GN_NORM8,
     "__device__ __forceinline__ float tanh_approx(float x) {\n  float y;\n"
     "  asm(\"tanh.approx.f32 %0, %1;\" : \"=f\"(y) : \"f\"(x));\n  return y;\n}\n\n"
     + GN_NORM8),
    (GN_SILU_LINE, "    f[j] = apply_silu ? fmaf(0.5f * y, tanh_approx(0.5f * y), 0.5f * y) : y;")]
# K9 gate on the feed-forward part, relative L2 of (out - x) against (plain
# - x), and max abs of out - plain. Measured on an H100 at all 6 shapes:
# 6.04e-3..6.08e-3 relative and up to 4.6e-2 abs, the bf16 roundings of the
# reference chain (y, u, h, o, out); an F-chunk of 64 left out gives
# 0.107-0.221, swapped value and gate halves 0.88.
FF_REL_TOL = 1.5e-2
FF_ABS_TOL = 8e-2


@contextlib.contextmanager
def knobs_set(values):
    """Set environment knobs for the block, then restore the old values."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _typed(shapes, dtype="bf16"):
    """Launch counts by shape as the K8, K9 and K10 counters key them, by
    (dtype, *shape)."""
    return {(dtype,) + tuple(k): n for k, n in shapes.items()}


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg):
    print(msg, flush=True)


def time_ms(torch, fn, reps=10, rounds=10, warmup=2):
    """Median over `rounds` of the CUDA-event time of `reps` back-to-back
    calls of fn(), divided by `reps`, after warm-up. Back-to-back calls keep
    the device queue full, so a short kernel is not timed at the host's
    launch rate."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def device_ms(torch, fn, reps=20):
    """Device time of the kernels fn() launches, per call, from
    torch.profiler over `reps` calls (after one warm-up): what a call costs
    the card where back-to-back calls are paced by the host."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = lambda e: getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
    return sum(dev(e) for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")) / 1e3 / reps


def bound(b, lq, lk, h, d, exp2_rate, with_bias):
    """Least time of the forward: 4*B*H*Lq*Lk*d tensor-core flops (the real
    head dim, not the kernel's padded tile), B*H*Lq*Lk exp2, or the bytes of
    q, k, v (and the bias) read once and o written once, whichever is
    largest."""
    t_mma = 4 * b * h * lq * lk * d / PEAK_BF16_FLOPS
    t_exp = b * h * lq * lk / exp2_rate
    nbytes = 2 * h * d * (2 * b * lq + 2 * b * lk) + (4 * b * lk if with_bias else 0)
    t_bytes = nbytes / PEAK_HBM_BYTES
    return max(t_mma, t_exp, t_bytes) * 1e3, ("bytes" if t_bytes >= max(t_mma, t_exp)
                                               else "operations")


def phase_card(torch):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    name, power, max_sm_mhz = [s.strip() for s in smi.stdout.splitlines()[0].split(",")]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.splitlines()[0].strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"[card] {card}")
    say(f"[card] torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} devices {torch.cuda.device_count()} max SM clock "
        f"{max_sm_mhz} MHz; allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    exp2_rate = sms * MUFU_EXP2_PER_CLOCK_PER_SM * float(max_sm_mhz) * 1e6
    return card, exp2_rate


def phase_build(kernels):
    """Build every source; print each instantiation's registers and spills
    (ptxas -v) and any ptxas performance warning. No library
    (`NOSPILL_LIBS`) may spill; the SASS of the bf16 flash forward and
    backward, K9 and K10 (`WGMMA_LIBS`) must run their products on wgmma
    (HGMMA), not mma.sync (HMMA), and that of the fp32 kernels and K8
    (`FFMA_LIBS`) on FFMA alone."""
    t0 = time.time()
    logs = kernels.build_all()
    say(f"[build] {time.time() - t0:.1f} s for {len(logs)} sources in parallel, libraries "
        f"{[p.name for p in kernels.BUILD_DIR.glob('*.so')]}")
    spills = []
    for name, log in logs.items():
        entry = ""
        for line in log.splitlines():
            if "Compiling entry" in line:
                entry = line.split("_Z")[-1].split("EEEv")[0][-40:]
                say(f"[build]   {name}: {entry}")
            elif ("registers" in line or "spill" in line or "error" in line
                  or "Performance Loss" in line):
                say(f"[build]   {name}:   {line.strip()}")
                if (name in NOSPILL_LIBS and "spill" in line
                        and not line.strip().startswith("0 bytes stack frame, 0 bytes spill")):
                    spills.append(f"{name} {entry} ({line.strip()})")
    if spills:
        fail(f"registers spill in {'; '.join(spills)}")
    for name in WGMMA_LIBS:
        lib = kernels.library_path(name)
        sass = subprocess.run([kernels.cuda_tool("cuobjdump"), "-sass", str(lib)],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout.splitlines()
        count = lambda op: sum(1 for line in sass if op in line)
        say(f"[build] {lib.name} SASS: {count('HGMMA')} HGMMA (wgmma), {count('HMMA')} HMMA "
            f"(mma.sync), {count('MUFU.EX2')} MUFU.EX2")
        if count("HGMMA") == 0 or count("HMMA") != 0:
            fail(f"{name}: the products are not all wgmma")
    for name in FFMA_LIBS:
        sass = subprocess.run([kernels.cuda_tool("cuobjdump"), "-sass",
                               str(kernels.library_path(name))], capture_output=True, text=True,
                              timeout=300, check=True).stdout.splitlines()
        count = lambda op: sum(1 for line in sass if op in line)
        say(f"[build] {name} SASS: {count('FFMA')} FFMA, {count('HGMMA')} HGMMA, "
            f"{count('HMMA')} HMMA")
        if count("FFMA") == 0 or count("HGMMA") or count("HMMA"):
            fail(f"{name}: the products are not all fp32 FFMA")


def n_launches(fa, kind=None):
    """Kernel launches counted since `launches_by_shape` was last cleared,
    of one kind ("fwd", "dq", "dkv") or of all."""
    return sum(n for key, n in fa.launches_by_shape.items() if kind in (None, key[0]))


def launches_by_arm(fa, kind="fwd"):
    """Launches of one kind since the counter was last cleared, by arm id."""
    arms = {}
    for key, n in fa.launches_by_shape.items():
        if key[0] == kind:
            arms[key[1]] = arms.get(key[1], 0) + n
    return arms


def kernel_errors(out, plain):
    """(max abs error, relative L2 error) of a kernel output against fp32."""
    diff = out.float() - plain
    return diff.abs().max().item(), (diff.norm() / plain.norm()).item()


def gate_passes(out, plain, d, abs_tol=None):
    err, rel = kernel_errors(out, plain)
    return err <= (abs_tol or KERNEL_ABS_TOL[d]) and rel <= KERNEL_REL_TOL


def check_gate_rejects_faults(fa, q, k, v, h, d, bias, plain, label, flags=0, abs_tol=None):
    """Planted faults, made with the plain version (with K1's `flags`) and
    rounded to bf16 like a kernel output: one 64-key tile skipped, and the
    softmax scale of head dim d + 8. The gate must reject both, or it could
    pass a wrong kernel."""
    kb = None if bias is None else bias[:, 64:]
    faults = {
        "key tile 0 skipped": fa.flash_attention_blc_plain(q, k[:, 64:], v[:, 64:], h,
                                                           key_bias=kb, flags=flags),
        f"scale of d{d + 8}": fa.flash_attention_blc_plain(q, k, v, h, key_bias=bias,
                                                           scale=(d + 8) ** -0.5, flags=flags),
    }
    for name, wrong in faults.items():
        err, rel = kernel_errors(wrong.bfloat16(), plain)
        say(f"[kernel]   planted fault, {name}: max abs err {err:.3e} rel L2 {rel:.3e}")
        if gate_passes(wrong.bfloat16(), plain, d, abs_tol):
            fail(f"{label}: the gate passes a planted fault ({name})")


def phase_kernels(torch, fa, card, exp2_rate):
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    rand = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    rows = {}
    cases = [(shape, "packed") for shape in MAIN_SHAPES] + [
        ((16, 1024, 8, 80), "fused-qkv"), ((4, 4096, 8, 40), "bias, row 0 fully masked")]
    for (b, l, h, d), kind in cases:
        inner = h * d
        bias = None
        if kind == "fused-qkv":
            qkv = rand(b, l, 3 * inner)
            q, k, v = qkv[..., :inner], qkv[..., inner:2 * inner], qkv[..., 2 * inner:]
        else:
            q, k, v = rand(b, l, inner), rand(b, l, inner), rand(b, l, inner)
        if kind.startswith("bias"):
            bias = torch.zeros((b, l), device="cuda")
            bias[0] = -1e30
            bias[1:, torch.rand(l, generator=gen, device="cuda") > 0.6] = -1e30
        fa.launches_by_shape.clear()
        out = fa.flash_attention_blc_cuda(q, k, v, h, key_bias=bias)
        torch.cuda.synchronize()
        if n_launches(fa) != 1:
            fail(f"kernel wrapper counted {n_launches(fa)} launches for one call")
        plain = fa.flash_attention_blc_plain(q, k, v, h, key_bias=bias)
        if not torch.isfinite(out).all():
            fail(f"{kind} B{b} L{l} H{h} d{d}: non-finite kernel output")
        err, rel = kernel_errors(out, plain)
        label = f"{kind} B{b} L{l} H{h} d{d}"
        if bias is not None:
            uniform = v[0].float().mean(0)  # the masked row attends evenly
            err_u = (out[0].float() - uniform).abs().max().item()
            say(f"[kernel] masked row vs uniform average of v: max abs err {err_u:.3e} "
                f"(tol {MASKED_ROW_TOL})")
            if not err_u <= MASKED_ROW_TOL:
                fail("fully masked row is not uniform")
        ms = time_ms(torch, lambda: fa.flash_attention_blc_cuda(q, k, v, h, key_bias=bias))
        plain_ms = time_ms(torch, lambda: fa.flash_attention_blc_plain(q, k, v, h, key_bias=bias))
        qh, kh, vh = (t.unflatten(-1, (h, d)).transpose(1, 2) for t in (q, k, v))
        mask = None if bias is None else bias.to(torch.bfloat16)[:, None, None, :]
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, scale=d ** -0.5))
        bound_ms, bound_by = bound(b, l, l, h, d, exp2_rate, bias is not None)
        fa.launches_by_shape.clear()
        say(f"[kernel] {label:44s}: max abs err {err:.3e} (tol {KERNEL_ABS_TOL[d]}) "
            f"rel L2 {rel:.3e} (tol {KERNEL_REL_TOL}) kernel {ms:.4f} ms plain "
            f"{plain_ms:.4f} ms sdpa {library_ms:.4f} ms bound {bound_ms:.4f} ms "
            f"({bound_by}) [{card}]")
        if not gate_passes(out, plain, d):
            fail(f"{label}: kernel disagrees with plain (max abs {err:.3e}, rel L2 {rel:.3e})")
        check_gate_rejects_faults(fa, q, k, v, h, d, bias, plain, label)
        if kind == "packed":
            rows[(b, l, h, d)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                      bound_ms=bound_ms, bound_by=bound_by,
                                      library_ms=library_ms)
        del q, k, v, out, plain
    torch.cuda.empty_cache()
    return rows


def bwd_bound(b, lq, lk, h, d, exp2_rate, kind, with_bias):
    """Least time of a backward kernel: 6 (dq) or 8 (dk/dv) x B*H*Lq*Lk*d
    tensor-core flops (the real head dim), B*H*Lq*Lk exp2, or the bytes of
    q, k, v, dO, lse, delta (and the bias) read once and the outputs (dq, or
    dk and dv) written once, whichever is largest."""
    t_mma = (6 if kind == "dq" else 8) * b * h * lq * lk * d / PEAK_BF16_FLOPS
    t_exp = b * h * lq * lk / exp2_rate
    outs = b * lq * h * d if kind == "dq" else 2 * b * lk * h * d
    nbytes = (2 * b * h * d * (2 * lq + 2 * lk) + 2 * outs + 2 * 4 * b * h * lq
              + (4 * b * lk if with_bias else 0))
    t_bytes = nbytes / PEAK_HBM_BYTES
    return max(t_mma, t_exp, t_bytes) * 1e3, ("bytes" if t_bytes >= max(t_mma, t_exp)
                                               else "operations")


def lse_bound(b, l, h, d, exp2_rate):
    """Least time of the row lse on its own (`_row_lse_kernel`'s function):
    2*B*H*L^2*d tensor-core flops for the scores, B*H*L^2 exp2, or q and k
    read once and lse written once, whichever is largest."""
    t_mma = 2 * b * h * l * l * d / PEAK_BF16_FLOPS
    t_exp = b * h * l * l / exp2_rate
    t_bytes = (2 * 2 * b * l * h * d + 4 * b * h * l) / PEAK_HBM_BYTES
    return max(t_mma, t_exp, t_bytes) * 1e3, ("bytes" if t_bytes >= max(t_mma, t_exp)
                                               else "operations")


def _gate_bwd(got, plain, d, what, scaled=False):
    """(max abs, rel L2, passes) of one backward output against fp32. With
    `scaled` (the cross-attention's 128 keys, whose dk and dv sum the
    probabilities of every query: 50x the self-attention's), dq, dk and dv
    hold max abs against CROSS_BWD_ABS_TOL of the largest plain value."""
    err, rel = kernel_errors(got, plain)
    if scaled and what in ("dq", "dk", "dv"):
        return err, rel, (err <= CROSS_BWD_ABS_TOL * plain.abs().max().item()
                          and rel <= BWD_REL_TOL)
    if what == "o":
        ok = gate_passes(got, plain, d)
    elif what == "lse":
        ok = err <= LSE_ABS_TOL
    elif what == "dbias":
        ok = rel <= DBIAS_REL_TOL
    else:
        ok = err <= BWD_ABS_TOL[d] and rel <= BWD_REL_TOL
    return err, rel, ok


def check_bwd_repeats(torch, fa, args, got, label, split=None):
    """Launch dq and dk/dv again on the same inputs; dq, dk, dv and dbias
    must agree bit for bit (no atomics; a split sums its slices in order)."""
    again = (fa.flash_bwd_dq_cuda(*args),) + fa.flash_bwd_dkv_cuda(*args, need_dbias=True,
                                                                     split=split)[:3]
    for what, a, b in zip(("dq", "dk", "dv", "dbias"), got, again):
        if not torch.equal(a, b):
            fail(f"{label}: two launches disagree on {what}")


def phase_backward_kernels(torch, fa, card, exp2_rate, shapes=TRAIN_SHAPES,
                           biases=(True, False)):
    """The forward's lse and the dq and dk/dv/dbias kernels at `shapes`
    (the recon training shapes; phase 4f passes the compos ones) against
    the plain backward, with and without a key bias as `biases` lists,
    planted faults, and times in the first configuration of `biases` (the
    path's own: the recon step masks its keys, the compos step does not)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = {}
    for (b, l, h, d), (replaces, _, _) in shapes.items():
        for with_bias in biases:
            inner = h * d
            rand = lambda: torch.randn((b, l, inner), generator=gen, device="cuda").bfloat16()
            q, k, v, do = rand(), rand(), rand(), rand()
            bias = None
            if with_bias:
                bias = torch.where(torch.rand((b, l), generator=gen, device="cuda") > 0.3,
                                   0.0, -1e30)
                if b > 1:  # a fully masked batch row (at B1 it would be all of them)
                    bias[0] = -1e30
            scale = d ** -0.5
            label = f"B{b} L{l} H{h} d{d} {'bias' if with_bias else 'no bias'}"
            fa.launches_by_shape.clear()
            out, lse = fa.flash_attention_blc_cuda(q, k, v, h, bias, return_lse=True)
            delta = fa.row_delta(out, do, h)
            dq = fa.flash_bwd_dq_cuda(q, k, v, bias, do, lse, delta, h)
            dk, dv, dbias = fa.flash_bwd_dkv_cuda(q, k, v, bias, do, lse, delta, h,
                                                  need_dbias=True)
            torch.cuda.synchronize()
            counted = [n_launches(fa, kind) for kind in ("fwd", "dq", "dkv")]
            if counted != [1, 1, 1]:
                fail(f"{label}: wrappers counted {counted} fwd/dq/dkv launches for one "
                     f"call each")
            check_bwd_repeats(torch, fa, (q, k, v, bias, do, lse, delta, h),
                              (dq, dk, dv, dbias), label)
            again = fa.flash_attention_blc_cuda(q, k, v, h, bias, return_lse=True)
            if not (torch.equal(again[0], out) and torch.equal(again[1], lse)):
                fail(f"{label}: two forward launches disagree on o or lse")
            plain_out = fa.flash_attention_blc_plain(q, k, v, h, bias)
            plain_lse = fa.row_lse_plain(q, k, h, bias)
            pdq, pdk, pdv, pdb = fa.flash_backward_plain(q, k, v, bias, out, do, lse, h)
            checks = [("o", out, plain_out), ("lse", lse, plain_lse), ("dq", dq, pdq),
                      ("dk", dk, pdk),
                      ("dv", dv, pdv), ("dbias", dbias.sum(1), pdb.sum(1))]
            errs = {}
            for what, got, ref in checks:
                if not torch.isfinite(got).all():
                    fail(f"{label}: non-finite {what}")
                err, rel, ok = _gate_bwd(got, ref, d, what)
                errs[what] = (err, rel)
                say(f"[backward] {label:26s} {what:5s}: max abs err {err:.3e} rel L2 "
                    f"{rel:.3e}{'' if ok else '  FAILS THE GATE'}")
                if not ok:
                    fail(f"{label}: {what} disagrees with the plain backward")
            # planted faults, made with the plain version and rounded like
            # the kernels' outputs; each must fail the gate
            tile_dq = fa.flash_backward_plain(q, k[:, 64:], v[:, 64:],
                                              None if bias is None else bias[:, 64:],
                                              out, do, lse, h)[0]
            no_delta = fa.flash_backward_plain(q, k, v, bias, torch.zeros_like(out), do,
                                               lse, h)
            skipped_dk = pdk.clone()
            skipped_dk[:, :64] = 0
            last = (l - 1) // 64 * 64  # dk/dv without the last query tile
            no_last = fa.flash_backward_plain(q[:, :last], k, v, bias, out[:, :last],
                                              do[:, :last], lse[:, :, :last], h)
            faults = [("key tile 0 skipped", "dq", tile_dq, pdq),
                      ("key tile 0 skipped", "dk", skipped_dk, pdk),
                      ("delta omitted", "dq", no_delta[0], pdq),
                      ("delta omitted", "dk", no_delta[1], pdk),
                      ("dk without its scale", "dk", pdk / scale, pdk),
                      ("last query tile skipped", "dk", no_last[1], pdk),
                      ("last query tile skipped", "dv", no_last[2], pdv)]
            for name, what, wrong, ref in faults:
                err, rel, ok = _gate_bwd(wrong.bfloat16(), ref, d, what)
                say(f"[backward]   planted fault, {name} ({what}): max abs err {err:.3e} "
                    f"rel L2 {rel:.3e}")
                if ok:
                    fail(f"{label}: the gate passes a planted fault ({name}, {what})")
            # the forward's own planted faults, and the lse without the
            # first key tile
            check_gate_rejects_faults(fa, q, k, v, h, d, bias, plain_out, label)
            tile_lse = fa.row_lse_plain(q, k[:, 64:], h, None if bias is None else bias[:, 64:])
            err, rel, ok = _gate_bwd(tile_lse, plain_lse, d, "lse")
            say(f"[backward]   planted fault, key tile 0 skipped (lse): max abs err {err:.3e}")
            if ok:
                fail(f"{label}: the gate passes a planted fault (key tile 0 skipped, lse)")
            del tile_dq, no_delta, skipped_dk, no_last, tile_lse
            if with_bias != biases[0]:
                continue
            # times at the path's configuration (the first of `biases`); the
            # forward with and without its lse output, alternated
            fwd_times = {False: [], True: []}
            for want_lse in (False, True, True, False):
                fwd_times[want_lse].append(time_ms(torch, lambda: fa.flash_attention_blc_cuda(
                    q, k, v, h, bias, return_lse=want_lse)))
            fwd_ms = statistics.mean(fwd_times[True])
            fwd_nolse_ms = statistics.mean(fwd_times[False])
            dq_ms = time_ms(torch, lambda: fa.flash_bwd_dq_cuda(q, k, v, bias, do, lse,
                                                                delta, h))
            dkv_ms = time_ms(torch, lambda: fa.flash_bwd_dkv_cuda(q, k, v, bias, do, lse,
                                                                  delta, h))
            dq_dev = device_ms(torch, lambda: fa.flash_bwd_dq_cuda(q, k, v, bias, do, lse,
                                                                   delta, h))
            dkv_dev = device_ms(torch, lambda: fa.flash_bwd_dkv_cuda(q, k, v, bias, do, lse,
                                                                     delta, h))
            fwd_plain_ms = time_ms(torch, lambda: (fa.flash_attention_blc_plain(
                q, k, v, h, bias), fa.row_lse_plain(q, k, h, bias)), reps=2, rounds=3)
            lse_plain_ms = time_ms(torch, lambda: fa.row_lse_plain(q, k, h, bias),
                                   reps=2, rounds=3)
            bwd_plain_ms = time_ms(torch, lambda: fa.flash_backward_plain(
                q, k, v, bias, out, do, lse, h), reps=2, rounds=3)
            qh, kh, vh = (t.unflatten(-1, (h, d)).transpose(1, 2).detach().requires_grad_(True)
                          for t in (q, k, v))
            mask = None if bias is None else bias.to(torch.bfloat16)[:, None, None, :]
            sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                          scale=scale)
            fwd_lib_ms = time_ms(torch, lambda: sdpa().detach())
            # K3a's library yardstick: the memory-efficient attention with
            # its log-sum-exp output
            efficient = torch.ops.aten._scaled_dot_product_efficient_attention
            lse_lib_ms = time_ms(torch, lambda: efficient(
                qh.detach(), kh.detach(), vh.detach(),
                None if mask is None else mask.expand(b, h, l, l), True, scale=scale))
            o_lib = sdpa()
            g_lib = do.unflatten(-1, (h, d)).transpose(1, 2)
            bwd_lib_ms = time_ms(torch, lambda: torch.autograd.grad(
                o_lib, (qh, kh, vh), g_lib, retain_graph=True))
            bwd_lib_dev = device_ms(torch, lambda: torch.autograd.grad(
                o_lib, (qh, kh, vh), g_lib, retain_graph=True))
            del o_lib, qh, kh, vh
            fwd_bound = bound(b, l, l, h, d, exp2_rate, with_bias)
            lse_b = lse_bound(b, l, h, d, exp2_rate)
            dq_bound = bwd_bound(b, l, l, h, d, exp2_rate, "dq", with_bias)
            dkv_bound = bwd_bound(b, l, l, h, d, exp2_rate, "dkv", with_bias)
            rows[("fwd", b, l, h, d)] = dict(
                replaces=f"{replaces} (+ {K3A} as the lse output)",
                max_abs_err=errs["o"][0], ms=fwd_ms, plain_ms=fwd_plain_ms,
                bound_ms=fwd_bound[0], bound_by=fwd_bound[1], library_ms=fwd_lib_ms)
            rows[("dq", b, l, h, d)] = dict(
                replaces=K3B, max_abs_err=errs["dq"][0], ms=dq_ms, plain_ms=bwd_plain_ms,
                bound_ms=dq_bound[0], bound_by=dq_bound[1], library_ms=bwd_lib_ms,
                device_ms=dq_dev)
            rows[("dkv", b, l, h, d)] = dict(
                replaces=K3C, max_abs_err=max(errs["dk"][0], errs["dv"][0]), ms=dkv_ms,
                plain_ms=bwd_plain_ms, bound_ms=dkv_bound[0], bound_by=dkv_bound[1],
                library_ms=bwd_lib_ms, device_ms=dkv_dev)
            say(f"[backward] {label}: fwd+lse {fwd_ms:.4f} ms, fwd without lse "
                f"{fwd_nolse_ms:.4f} ms (lse costs {fwd_ms / fwd_nolse_ms - 1:+.1%}, "
                f"{fwd_ms - fwd_nolse_ms:+.4f} ms, against the lse's own bound "
                f"{lse_b[0]:.4f} ms ({lse_b[1]}); fwd bound {fwd_bound[0]:.4f}, "
                f"sdpa fwd {fwd_lib_ms:.4f}), dq {dq_ms:.4f} ms (device {dq_dev:.4f}; bound "
                f"{dq_bound[0]:.4f} {dq_bound[1]}), dk/dv {dkv_ms:.4f} ms (device "
                f"{dkv_dev:.4f}; bound {dkv_bound[0]:.4f} {dkv_bound[1]}), sdpa backward "
                f"{bwd_lib_ms:.4f} ms (device {bwd_lib_dev:.4f}), plain fwd "
                f"{fwd_plain_ms:.3f} ms, plain backward {bwd_plain_ms:.3f} ms; lse (K3a) plain "
                f"{lse_plain_ms:.3f} ms, efficient attention with lse {lse_lib_ms:.4f} ms "
                f"[{card}]")
            del q, k, v, do, out, lse, delta, dq, dk, dv, dbias, pdq, pdk, pdv, pdb
    fa.launches_by_shape.clear()
    torch.cuda.empty_cache()
    return rows


def _bwd_case(torch, fa, gen, b, lq, lk, h, d, with_bias, fused, split=None):
    """Forward with lse, then dq and dk/dv (at the plan's split, or `split`)
    on random inputs; repeats bit for bit and agreement with the plain
    backward. Returns (label, {output: (max abs err, rel L2)})."""
    inner = h * d
    rand = lambda l, w: torch.randn((b, l, w), generator=gen, device="cuda").bfloat16()
    if fused:
        qkv = rand(lq, 3 * inner)
        q, k, v = qkv[..., :inner], qkv[..., inner:2 * inner], qkv[..., 2 * inner:]
    else:
        q, k, v = rand(lq, inner), rand(lk, inner), rand(lk, inner)
    do = rand(lq, inner)
    bias = None
    if with_bias:
        bias = torch.where(torch.rand((b, lk), generator=gen, device="cuda") > 0.3, 0.0, -1e30)
        bias[0] = -1e30
    label = (f"B{b} Lq{lq} Lk{lk} H{h} d{d}{' bias' if with_bias else ''}"
             f"{' fused-qkv' if fused else ''} split {split or 'planned'}")
    out, lse = fa.flash_attention_blc_cuda(q, k, v, h, bias, return_lse=True)
    delta = fa.row_delta(out, do, h)
    args = (q, k, v, bias, do, lse, delta, h)
    got = (fa.flash_bwd_dq_cuda(*args),) + fa.flash_bwd_dkv_cuda(*args, need_dbias=True,
                                                                   split=split)
    torch.cuda.synchronize()
    check_bwd_repeats(torch, fa, args, got, label, split)
    plain = fa.flash_backward_plain(q, k, v, bias, out, do, lse, h)
    errs = {}
    for what, a, ref in zip(("dq", "dk", "dv", "dbias"), got, plain):
        err, rel, ok = _gate_bwd(a, ref, d, what, scaled=True)
        errs[what] = (err, rel)
        if not torch.isfinite(a).all() or not ok:
            fail(f"{label}: {what} disagrees with the plain backward (max abs {err:.3e}, "
                 f"rel L2 {rel:.3e})")
    return label, errs


def phase_backward_edges(torch, fa, card):
    """(4e) The backward at BWD_EDGE_SHAPES and, at BWD_SPLIT_SHAPES, at
    every split the plan can choose: agreement and repeats only. Then dk/dv's
    device time (profiler) at each split at BWD_SPLIT_TIMED, beside the
    plan's choice."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b, lq, lk, h, d, with_bias, fused in BWD_EDGE_SHAPES:
        label, errs = _bwd_case(torch, fa, gen, b, lq, lk, h, d, with_bias, fused)
        say(f"[backward-edge] {label:48s} " + " ".join(
            f"{w} {e:.2e}/{r:.2e}" for w, (e, r) in errs.items())
            + f" (max abs / rel L2); {fa.bwd_launch_plan(b, h, lq, lk, d, sms)}")
    for b, lq, lk, h, d in BWD_SPLIT_SHAPES:
        worst = 0.0
        for split in range(1, fa.BWD_MAX_SPLIT + 1):
            _, errs = _bwd_case(torch, fa, gen, b, lq, lk, h, d, True, False, split)
            worst = max([worst] + [r for _, r in errs.values()])
        say(f"[backward-edge] B{b} Lq{lq} Lk{lk} H{h} d{d} bias: splits 1-{fa.BWD_MAX_SPLIT} "
            f"agree, worst rel L2 {worst:.2e}")
    for b, lq, lk, h, d in BWD_SPLIT_TIMED:
        inner = h * d
        q, do = (torch.randn((b, lq, inner), generator=gen, device="cuda").bfloat16()
                 for _ in range(2))
        k, v = (torch.randn((b, lk, inner), generator=gen, device="cuda").bfloat16()
                for _ in range(2))
        bias = torch.zeros((b, lk), device="cuda")
        out, lse = fa.flash_attention_blc_cuda(q, k, v, h, bias, return_lse=True)
        delta = fa.row_delta(out, do, h)
        plan = fa.bwd_launch_plan(b, h, lq, lk, d, sms)
        times = [device_ms(torch, lambda: fa.flash_bwd_dkv_cuda(
            q, k, v, bias, do, lse, delta, h, split=split))
            for split in range(1, min(fa.BWD_MAX_SPLIT, -(-lq // fa.BWD_TILE)) + 1)]
        say(f"[backward-split] B{b} Lq{lq} Lk{lk} H{h} d{d} bias: dk/dv device ms at split 1.."
            f"{len(times)}: " + " ".join(f"{t:.4f}" for t in times)
            + f"; the plan takes {plan.split} ({plan.key_ctas} key CTAs) [{card}]")
        del q, do, k, v, out, lse, delta
    fa.launches_by_shape.clear()
    torch.cuda.empty_cache()


def _fused_ops():
    from adaface_tpu_torch.ops import fused_ff, fused_norm
    return fused_norm, fused_ff


def gn_bound(b, n, c, exp2_rate, itemsize=2):
    """Least time of K8: x read once and out written once (`itemsize`
    bytes an element each), or one exp per element at the MUFU rate,
    whichever is larger."""
    t_bytes = 2 * itemsize * b * n * c / PEAK_HBM_BYTES
    t_exp = b * n * c / exp2_rate
    return max(t_bytes, t_exp) * 1e3, "bytes" if t_bytes >= t_exp else "operations"


def ff_bound(b, l, c, itemsize=2, peak=None):
    """Least time of K9: 24 * M * C^2 flops at `peak` (the tensor cores'
    bf16 rate by default), or x, out, w1, w2 and the vectors moved once
    (`itemsize` bytes an element), whichever is larger."""
    m, f = b * l, 4 * c
    t_mma = 24 * m * c * c / (peak or PEAK_BF16_FLOPS)
    t_bytes = itemsize * (2 * m * c + 3 * f * c + 3 * c + 2 * f) / PEAK_HBM_BYTES
    return max(t_mma, t_bytes) * 1e3, "bytes" if t_bytes >= t_mma else "operations"


def gn_fault_rows(fn, b, n, c, sms):
    """Rows of the planted fault "row chunk 0 left out": the earlier
    kernel's first stats chunk (GN_FAULT_CHUNK_ELEMS), or CTA 0's rows where
    the plan gives a CTA more."""
    chunk = (-(-GN_FAULT_CHUNK_ELEMS // c) + 7) // 8 * 8
    return max(chunk, fn.cta_rows(n, fn.launch_plan(b, n, c, sms).cluster, 0)[1])


def gn_chunk_fault(torch, x, scale, bias, rows):
    """K8 with the stats of rows [0, rows) (its first chunk) left out of the
    sums but not of the count, in plain fp32."""
    xf = x.float()
    b, n, c = xf.shape
    cg = c // 32
    part = xf[:, rows:]
    mean = part.sum(1).view(b, 32, cg).sum(-1) / (n * cg)
    msq = (part * part).sum(1).view(b, 32, cg).sum(-1) / (n * cg)
    rstd = torch.rsqrt(torch.clamp_min(msq - mean * mean, 0.0) + 1e-5)
    sc = scale.float() * rstd.repeat_interleave(cg, 1)
    sh = bias.float() - mean.repeat_interleave(cg, 1) * sc
    out = xf * sc[:, None] + sh[:, None]
    return out * torch.sigmoid(out)


def ff_errors(out, plain, x):
    """(max abs error of out, relative L2 error of its feed-forward part)."""
    o, po = out.float() - x.float(), plain - x.float()
    return (out.float() - plain).abs().max().item(), ((o - po).norm() / po.norm()).item()


def _check_fused_gate(label, err, rel, faults, tol_abs, tol_rel, errors):
    """Fail unless (err, rel) is inside the gate and every planted fault is
    outside it."""
    for name, wrong in faults.items():
        ferr, frel = errors(wrong)
        say(f"[fused-kernel]   planted fault, {name}: max abs err {ferr:.3e} rel L2 {frel:.3e}")
        if ferr <= tol_abs and frel <= tol_rel:
            fail(f"{label}: the gate passes a planted fault ({name})")
    if not (err <= tol_abs and rel <= tol_rel):
        fail(f"{label}: kernel disagrees with plain (max abs {err:.3e}, rel L2 {rel:.3e})")


def gn_inputs(torch, randn, b, n, c, dtype=None):
    """K8's inputs: x with per-channel offsets and a ramp of -4..4 over the
    rows (see GN_REL_TOL), scale and bias, in `dtype` (bf16 by default)."""
    dtype = dtype or torch.bfloat16
    x = (randn(b, n, c) * 1.5 + randn(c)
         + torch.linspace(-4, 4, n, device="cuda")[None, :, None]).to(dtype)
    return x, (1 + 0.2 * randn(c)).to(dtype), (0.2 * randn(c)).to(dtype)


def gn_tail_inputs(torch, gen, b, n, c):
    """K8's inputs with every pre-activation in about [-12, -3]: x uniform
    in [-1, 1] (normalised, within +-sqrt(3)), scale 4.5 / sqrt(3), bias
    -7.5; bf16."""
    x = (torch.rand((b, n, c), generator=gen, device="cuda") * 2 - 1).bfloat16()
    full = lambda v: torch.full((c,), v, device="cuda").bfloat16()
    return x, full(4.5 / 3 ** 0.5), full(-7.5)


def gn_tail_error(out, plain):
    """The largest relative error of one output element."""
    return ((out.float() - plain).abs() / plain.abs()).max().item()


def gn_tanh_fault(torch, fn, lib, x, scale, bias):
    """K8 built with the tanh.approx SiLU (`GN_TANH_PATCHES`), launched
    through its C entry with the wrapper's plan."""
    b, n, c = x.shape
    plan = fn.launch_plan(b, n, c, torch.cuda.get_device_properties(0).multi_processor_count)
    out = torch.empty_like(x)
    err = lib.gn_silu_fwd(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), b, n,
                          c, 32, plan.cluster, plan.threads, 1e-5, 1,
                          torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    if err:
        fail(f"the tanh SiLU fault's kernel failed: CUDA error {err}")
    return out


def build_gn_tanh_fault():
    """The planted fault's kernel: `csrc/gn_silu.cu` with GN_TANH_PATCHES,
    built into `_variants/fault_gn_tanh/`."""
    import ctypes

    import kernel_variants as kv
    try:
        lib, _ = kv.build({"gn_tanh": (kv.CSRC, "gn_silu.cu", GN_TANH_PATCHES)},
                          prefix="fault_")["gn_tanh"]
    except (ValueError, RuntimeError) as e:
        fail(f"the tanh SiLU fault did not build: {e}")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gn_silu_fwd.argtypes = [p] * 4 + [i] * 6 + [ctypes.c_float, i, p]
    lib.gn_silu_fwd.restype = i
    return lib


def phase_fused_kernels(torch, card, exp2_rate):
    """K8 and K9 against their plain fp32 versions at every shape of the
    fused paths (generate, recon and compos training), planted faults,
    repeatability, and times: kernel, bound, plain, the default arm (the
    unfused torch ops the knob replaces) and, for K8, F.group_norm + F.silu;
    then both at their edge shapes, agreement and repeats only."""
    import torch.nn.functional as F

    fn, ff = _fused_ops()
    gen = torch.Generator(device="cuda").manual_seed(9)
    randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = {}
    for b, n, c in sorted(set(GN_SHAPES) | set(GN_TRAIN_SHAPES) | set(GN_COMPOS_SHAPES),
                          key=lambda k: (-k[0], -k[1], k[2])):
        x, scale, bias = gn_inputs(torch, randn, b, n, c)
        xf, sf, bf = x.float(), scale.float(), bias.float()
        fn.launches_by_shape.clear()
        out = fn.group_norm_silu_cuda(x, scale, bias)
        again = fn.group_norm_silu_cuda(x, scale, bias)
        torch.cuda.synchronize()
        label = f"gn_silu B{b} N{n} C{c}"
        if fn.launches_by_shape != {("bf16", b, n, c): 2}:
            fail(f"{label}: the wrapper counted {fn.launches_by_shape} for two calls")
        if not torch.isfinite(out).all() or not torch.equal(out, again):
            fail(f"{label}: non-finite output, or two launches disagree")
        plain = fn.group_norm_silu_plain(xf, sf, bf)
        err, rel = kernel_errors(out, plain)
        call = lambda: fn.group_norm_silu_cuda(x, scale, bias)
        ms = time_ms(torch, call)
        dev_ms = device_ms(torch, call)
        plain_ms = time_ms(torch, lambda: fn.group_norm_silu_plain(xf, sf, bf), reps=2, rounds=3)
        default_ms = time_ms(torch, lambda: fn._plain(x, scale, bias, 32, 1e-5, True))
        xt = x.transpose(1, 2).contiguous()  # [B, C, N] for F.group_norm
        library_ms = time_ms(torch, lambda: F.silu(F.group_norm(xt, 32, scale, bias, 1e-5)))
        bound_ms, bound_by = gn_bound(b, n, c, exp2_rate)
        plan = fn.launch_plan(b, n, c, sms)
        say(f"[fused-kernel] {label:26s}: max abs err {err:.3e} (tol {GN_ABS_TOL}) rel L2 "
            f"{rel:.3e} (tol {GN_REL_TOL}) kernel {ms:.4f} ms device {dev_ms:.4f} ms bound "
            f"{bound_ms:.4f} ms ({bound_by}) plain {plain_ms:.4f} ms default arm "
            f"{default_ms:.4f} ms F.group_norm+F.silu {library_ms:.4f} ms; {plan} [{card}]")
        # the last CTA's partial (the cluster's ragged end) left out of the
        # combine, the count kept
        parts = fn.cluster_partials(xf, plan.cluster)
        parts[:, -1] = 0
        faults = {"SiLU omitted": fn.group_norm_silu_plain(xf, sf, bf, apply_silu=False),
                  "row chunk 0 left out of the stats":
                      gn_chunk_fault(torch, x, scale, bias, gn_fault_rows(fn, b, n, c, sms)),
                  f"cluster peer {plan.cluster - 1} of {plan.cluster} left out of the combine":
                      fn.group_norm_silu_from_partials(xf, sf, bf, parts)}
        _check_fused_gate(label, err, rel, {k: v.bfloat16() for k, v in faults.items()},
                          GN_ABS_TOL, GN_REL_TOL, lambda w: kernel_errors(w, plain))
        rows[("gn", b, n, c)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                     bound_ms=bound_ms, bound_by=bound_by,
                                     library_ms=library_ms, default_arm_ms=default_ms,
                                     device_ms=dev_ms)
        del x, xt, xf, out, again, plain, faults, parts
    for b, n, c in GN_EDGE_SHAPES:
        x, scale, bias = gn_inputs(torch, randn, b, n, c)
        out, again = fn.group_norm_silu_cuda(x, scale, bias), fn.group_norm_silu_cuda(x, scale, bias)
        torch.cuda.synchronize()
        err, rel = kernel_errors(out, fn.group_norm_silu_plain(x.float(), scale.float(),
                                                               bias.float()))
        label = f"gn_silu B{b} N{n} C{c}"
        say(f"[fused-kernel] {label:26s}: max abs err {err:.3e} rel L2 {rel:.3e}; "
            f"{fn.launch_plan(b, n, c, sms)}")
        if not torch.equal(out, again) or not (err <= GN_ABS_TOL and rel <= GN_REL_TOL):
            fail(f"{label}: kernel disagrees with plain, or two launches disagree")
        del x, out, again
    tanh_lib = build_gn_tanh_fault()
    for b, n, c in GN_TAIL_SHAPES:
        x, scale, bias = gn_tail_inputs(torch, gen, b, n, c)
        plain = fn.group_norm_silu_plain(x.float(), scale.float(), bias.float())
        tail = gn_tail_error(fn.group_norm_silu_cuda(x, scale, bias), plain)
        fault = gn_tail_error(gn_tanh_fault(torch, fn, tanh_lib, x, scale, bias), plain)
        label = f"gn_silu B{b} N{n} C{c}"
        say(f"[fused-kernel] {label:26s}: SiLU tail (pre-activations in [-12, -3]): largest "
            f"element relative error {tail:.3e} (tol {GN_TAIL_REL_TOL:.3e}); planted fault, "
            f"tanh.approx SiLU: {fault:.3e}")
        if fault <= GN_TAIL_REL_TOL:
            fail(f"{label}: the SiLU tail gate passes a planted fault (tanh.approx SiLU)")
        if not tail <= GN_TAIL_REL_TOL:
            fail(f"{label}: the kernel's SiLU tail disagrees with plain ({tail:.3e})")
        del x, plain
    for b, l, c in list(FF_SHAPES) + list(FF_TRAIN_SHAPES) + list(FF_COMPOS_SHAPES):
        f = 4 * c
        x = randn(b, l, c).bfloat16()
        w1 = (randn(2 * f, c) / c ** 0.5).bfloat16()  # nn.Linear layouts, as in the UNet
        w2 = (randn(c, f) / f ** 0.5).bfloat16()
        args = (x, (1 + 0.2 * randn(c)).bfloat16(), (0.2 * randn(c)).bfloat16(), w1.t(),
                (0.2 * randn(2 * f)).bfloat16(), w2.t(), (0.2 * randn(c)).bfloat16())
        fargs = [a.float() for a in args]
        ff.launches_by_shape.clear()
        out = ff.ln_geglu_ff_cuda(*args)
        again = ff.ln_geglu_ff_cuda(*args)
        torch.cuda.synchronize()
        label = f"ln_geglu_ff B{b} L{l} C{c}"
        if ff.launches_by_shape != {("bf16", b, l, c): 2}:
            fail(f"{label}: the wrapper counted {ff.launches_by_shape} for two calls")
        if not torch.isfinite(out).all() or not torch.equal(out, again):
            fail(f"{label}: non-finite output, or two launches disagree")
        plain = ff.ln_geglu_ff_plain(*fargs)
        err, rel = ff_errors(out, plain, x)
        ms = time_ms(torch, lambda: ff.ln_geglu_ff_cuda(*args))
        plain_ms = time_ms(torch, lambda: ff.ln_geglu_ff_plain(*fargs), reps=2, rounds=3)
        default_ms = time_ms(torch, lambda: ff.ln_geglu_ff_unfused(*args))
        # the yardstick of K9's GEMMs: cuBLAS's two products alone
        y = torch.nn.functional.layer_norm(x, (c,), args[1], args[2])
        h = torch.randn((b, l, f), device="cuda").bfloat16()  # not from gen: inputs as before
        library_ms = time_ms(torch, lambda: (torch.nn.functional.linear(y, w1),
                                             torch.nn.functional.linear(h, w2)))
        bound_ms, bound_by = ff_bound(b, l, c)
        plan = ff.launch_plan(b * l, c, f, sms)
        say(f"[fused-kernel] {label:26s}: max abs err {err:.3e} (tol {FF_ABS_TOL}) rel L2 "
            f"{rel:.3e} (tol {FF_REL_TOL}) kernel {ms:.4f} ms bound {bound_ms:.4f} ms "
            f"({bound_by}) plain {plain_ms:.4f} ms default arm {default_ms:.4f} ms cuBLAS "
            f"GEMMs {library_ms:.4f} ms; {plan} [{card}]")
        w2_skip = fargs[5].clone()
        w2_skip[:64] = 0  # the first 64 columns of h contribute nothing
        # GEMM2's last split-K partial (the whole product when unsplit) left out
        k0 = (plan.split - 1) * (f // 64) // plan.split * 64
        w2_part = fargs[5].clone()
        w2_part[k0:] = 0
        w1_stage = fargs[3].clone()
        w1_stage[c - 64:] = 0  # GEMM1's last K stage (64 channels of y) skipped
        swap = lambda t: torch.cat([t[..., f:], t[..., :f]], dim=-1)
        faults = {"F-chunk 0 skipped": ff.ln_geglu_ff_plain(*fargs[:5], w2_skip, fargs[6]),
                  "value and gate halves swapped": ff.ln_geglu_ff_plain(
                      *fargs[:3], swap(fargs[3]), swap(fargs[4]), *fargs[5:]),
                  f"GEMM2 split {plan.split - 1} of {plan.split} left out":
                      ff.ln_geglu_ff_plain(*fargs[:5], w2_part, fargs[6]),
                  "GEMM1's last K stage skipped":
                      ff.ln_geglu_ff_plain(*fargs[:3], w1_stage, *fargs[4:])}
        _check_fused_gate(label, err, rel, {k: v.bfloat16() for k, v in faults.items()},
                          FF_ABS_TOL, FF_REL_TOL, lambda w: ff_errors(w, plain, x))
        rows[("ff", b, l, c)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                     bound_ms=bound_ms, bound_by=bound_by,
                                     library_ms=library_ms, default_arm_ms=default_ms)
        del x, args, fargs, out, again, plain, faults, y, h, w2_part, w1_stage
    for b, l, c, f in FF_EDGE_SHAPES:
        args = (randn(b, l, c).bfloat16(), (1 + 0.2 * randn(c)).bfloat16(),
                (0.2 * randn(c)).bfloat16(), (randn(2 * f, c) / c ** 0.5).bfloat16().t(),
                (0.2 * randn(2 * f)).bfloat16(), (randn(c, f) / f ** 0.5).bfloat16().t(),
                (0.2 * randn(c)).bfloat16())
        out, again = ff.ln_geglu_ff_cuda(*args), ff.ln_geglu_ff_cuda(*args)
        torch.cuda.synchronize()
        err, rel = ff_errors(out, ff.ln_geglu_ff_plain(*[a.float() for a in args]), args[0])
        label = f"ln_geglu_ff B{b} L{l} C{c} F{f}"
        say(f"[fused-kernel] {label:26s}: max abs err {err:.3e} rel L2 {rel:.3e}; "
            f"{ff.launch_plan(b * l, c, f, sms)}")
        if not torch.equal(out, again) or not (err <= FF_ABS_TOL and rel <= FF_REL_TOL):
            fail(f"{label}: kernel disagrees with plain, or two launches disagree")
    fn.launches_by_shape.clear()
    ff.launches_by_shape.clear()
    torch.cuda.empty_cache()
    return rows


def rel_err(a, b):
    b = b.float().cpu()
    return ((a.float().cpu() - b).norm() / b.norm()).item()


def cpu_fp32_copy(torch, m, build=None):
    """m's weights in fp32 on the CPU, in a module from `build()` (by
    default `type(m)(m.cfg)`)."""
    with torch.device("meta"):
        c = build() if build is not None else type(m)(m.cfg)
    c = c.to_empty(device="cpu")
    c.load_state_dict({k: v.float().cpu() for k, v in m.state_dict().items()})
    return c.eval()


def phase_reference(torch, pipe):
    """SD-width models, bf16 on the card vs fp32 on the CPU, same weights;
    the UNet twice, with the default knobs and with `FUSED_KNOBS` (kernels
    on the card, their plain versions on the CPU)."""
    from adaface_tpu_torch.models.unet import precompute_cross_kv

    fn, ff = _fused_ops()
    cpu_copy = lambda m: cpu_fp32_copy(torch, m)

    gen = torch.Generator().manual_seed(1)
    ids = pipe.tokenizer(["a photo of a z , , , , , , , , person", "a red car"])
    x = torch.randn((1, 16, 16, 4), generator=gen)  # level 0 self-attention: L 256
    t = torch.tensor([501], dtype=torch.int32)
    z = torch.randn((1, 16, 16, 4), generator=gen)
    with torch.inference_mode():
        ctx_gpu = pipe.clip(torch.as_tensor(ids, device="cuda").long(), skip_weights=(0.5, 0.5))
        clip_cpu = cpu_copy(pipe.clip)
        ctx_cpu = clip_cpu(torch.as_tensor(ids).long(), skip_weights=(0.5, 0.5))
        del clip_cpu
        ctx = ctx_cpu[None]  # [1, 2B, 77, 768]: (cond; uncond) for B = 1
        unet_cpu = cpu_copy(pipe.unet)
        kv_cpu = precompute_cross_kv(unet_cpu, ctx)
        eps_cpu = unet_cpu(x, t, ctx, cfg_dedup=True, cross_kv=kv_cpu)
        with knobs_set(FUSED_KNOBS):
            eps_cpu_fused = unet_cpu(x, t, ctx, cfg_dedup=True, cross_kv=kv_cpu)
        del unet_cpu, kv_cpu
        ctx_d = ctx.cuda().to(torch.bfloat16)
        kv_d = precompute_cross_kv(pipe.unet, ctx_d)
        fa_launches = n_launches(_fa())
        fn.launches_by_shape.clear()
        ff.launches_by_shape.clear()
        eps_gpu = pipe.unet(x.cuda(), t.cuda(), ctx_d, cfg_dedup=True, cross_kv=kv_d)
        if n_launches(_fa()) - fa_launches != 5:
            fail("the small-input UNet call did not take the kernel 5 times")
        if fn.launches_by_shape or ff.launches_by_shape:
            fail("the default knobs launched a fused kernel")
        with knobs_set(FUSED_KNOBS):
            eps_gpu_fused = pipe.unet(x.cuda(), t.cuda(), ctx_d, cfg_dedup=True, cross_kv=kv_d)
        # at this 16x16 latent the 14 sites of level 3 (2x2, N = 4) fail the
        # N % 8 gate and take the plain arm; all 16 feed-forwards fuse
        n_gn, n_ff = (sum(m.launches_by_shape.values()) for m in (fn, ff))
        say(f"[reference] fused configuration: {n_gn} GroupNorm+SiLU and {n_ff} "
            f"feed-forward kernel launches in the small-input UNet call")
        if (n_gn, n_ff) != (31, 16):
            fail(f"the fused small-input UNet call launched {n_gn} K8 and {n_ff} K9, "
                 f"not 31 and 16")
        vae_cpu = cpu_copy(pipe.vae)
        img_cpu = vae_cpu.decode(z)
        del vae_cpu
        img_gpu = pipe.vae.decode(z.cuda())
    for name, a, b in (("clip", ctx_gpu, ctx_cpu), ("unet eps", eps_gpu, eps_cpu),
                       ("unet eps, fused", eps_gpu_fused, eps_cpu_fused),
                       ("vae decode", img_gpu, img_cpu)):
        e = rel_err(a, b)
        tol = REFERENCE_TOL[name.split(",")[0]]
        say(f"[reference] {name}: bf16 card vs fp32 cpu relative L2 error {e:.3e} "
            f"(tol {tol})")
        if not torch.isfinite(a).all() or not e <= tol:
            fail(f"{name} on the card disagrees with the CPU reference ({e:.3e})")


def _fa():
    from adaface_tpu_torch.ops import flash_attention
    return flash_attention


def phase_main_path(torch, pipe, card):
    fa = _fa()
    finite = []
    hooks = [m.register_forward_hook(lambda mod, inp, out: finite.append(torch.isfinite(out).all()))
             for m in (pipe.unet, pipe.vae.decoder, pipe.clip)]
    prompts = [PROMPT] * BATCH
    kw = dict(num_steps=STEPS, guidance_scale=(10.0, 4.0), height=SIZE, width=SIZE)
    t0 = time.time()
    pipe.generate(prompts, seed=0, **kw)
    say(f"[main] warm-up request {time.time() - t0:.3f} s [{card}]")
    times = []
    for i in range(3):
        fa.launches_by_shape.clear()
        torch.cuda.synchronize()
        t0 = time.time()
        imgs = pipe.generate(prompts, seed=i + 1, **kw)
        times.append(time.time() - t0)
        counts = {(b, lq, h, d): n for (kind, arm, b, lq, lk, h, d), n
                  in fa.launches_by_shape.items() if kind == "fwd"}
        arms = launches_by_arm(fa)
        launches = n_launches(fa)
        say(f"[main] request {i}: {times[-1]:.3f} s, {BATCH / times[-1]:.4f} img/s, "
            f"kernel launches {launches} {sorted(counts.items())} by arm {arms} [{card}]")
        if (launches != 750 or counts != {s: n for s, (_, n) in MAIN_SHAPES.items()}
                or arms != {"K1": 500, "K4": 250}):
            fail(f"expected 750 launches ({MAIN_SHAPES}; K1 500, K4 250), got {launches} "
                 f"{counts} {arms}")
        if i == 0:
            first_imgs = imgs
        if imgs.shape != (BATCH, SIZE, SIZE, 3) or str(imgs.dtype) != "uint8":
            fail(f"images {imgs.shape} {imgs.dtype}")
        if imgs.std() < 1.0 or imgs.reshape(BATCH, -1).std(axis=1).min() < 1.0:
            fail("constant images")
    for h in hooks:
        h.remove()
    if not bool(torch.stack(finite).all()):
        fail("NaN or Inf in a CLIP, UNet or VAE output during the main path")
    say(f"[main] {len(finite)} model outputs finite; images uint8 {imgs.shape}, "
        f"mean {imgs.mean():.2f} std {imgs.std():.2f}")
    med = statistics.median(times)
    say(f"[main] batch {BATCH} 512x512 DDIM-{STEPS} CFG 10->4 bf16: median "
        f"{med:.3f} s/request, {BATCH / med:.4f} img/s, best {min(times):.3f} s "
        f"[{card}]")
    return counts, med, first_imgs


def phase_fused_main_path(torch, pipe, card, default_med):
    """`generate` under FUSED_KNOBS: one warm-up and 2 timed requests, each
    with exactly 750 flash forwards, 2,250 K8 and 800 K9 launches by shape;
    then one request under the profiler. Returns the last request's K8 and
    K9 launches by shape."""
    fa = _fa()
    fn, ff = _fused_ops()
    prompts = [PROMPT] * BATCH
    kw = dict(num_steps=STEPS, guidance_scale=(10.0, 4.0), height=SIZE, width=SIZE)
    want_fa = {s: n for s, (_, n) in MAIN_SHAPES.items()}
    want_gn = _typed({s: STEPS * n for s, n in GN_SHAPES.items()})
    want_ff = _typed({s: STEPS * n for s, n in FF_SHAPES.items()})
    times = []
    with knobs_set(FUSED_KNOBS):
        t0 = time.time()
        pipe.generate(prompts, seed=0, **kw)
        say(f"[fused] warm-up request {time.time() - t0:.3f} s [{card}]")
        for i in range(2):
            for m in (fa, fn, ff):
                m.launches_by_shape.clear()
            torch.cuda.synchronize()
            t0 = time.time()
            imgs = pipe.generate(prompts, seed=i + 1, **kw)
            times.append(time.time() - t0)
            got_fa = {(b, lq, h, d): n for (kind, arm, b, lq, lk, h, d), n
                      in fa.launches_by_shape.items() if kind == "fwd"}
            got_gn, got_ff = dict(fn.launches_by_shape), dict(ff.launches_by_shape)
            say(f"[fused] request {i}: {times[-1]:.3f} s, {BATCH / times[-1]:.4f} img/s, "
                f"launches: flash {sum(got_fa.values())}, gn_silu {sum(got_gn.values())}, "
                f"ln_geglu_ff {sum(got_ff.values())} [{card}]")
            if (got_fa, got_gn, got_ff) != (want_fa, want_gn, want_ff):
                fail(f"fused request {i}: expected the launches {want_fa} {want_gn} "
                     f"{want_ff}, got {got_fa} {got_gn} {got_ff}")
            if imgs.shape != (BATCH, SIZE, SIZE, 3) or imgs.std() < 1.0:
                fail(f"fused request {i}: images {imgs.shape}, std {imgs.std():.3f}")
        med = statistics.median(times)
        say(f"[fused] batch {BATCH} 512x512 DDIM-{STEPS} bf16 under {FUSED_KNOBS}: median "
            f"{med:.3f} s/request, {BATCH / med:.4f} img/s; default knobs {default_med:.3f} "
            f"s/request, {BATCH / default_med:.4f} img/s [{card}]")
        profile_breakdown(torch, lambda: pipe.generate(prompts, seed=4, **kw), "fused-profile",
                          "one request under the fused knobs", card)
    return got_gn, got_ff


def _category(name):
    if "gn_silu_kernel" in name:  # the fp32 instance: T = float
        fp32 = "gn_silu_kernel<float" in name or "gn_silu_kernelIf" in name
        return f"gn_silu{' fp32' if fp32 else ''} (this port's kernel)"
    if "ff32_" in name:  # ff32_ln_kernel, ff32_gemm_kernel, ff32_split_sum_kernel
        return "ln_geglu_ff fp32 (this port's kernel)"
    if "ln_kernel" in name or "gemm_kernel" in name or "splitk_reduce" in name:
        return "ln_geglu_ff (this port's kernel)"
    if "flash_fp32_fwd" in name:
        return "flash_attn_fp32 forward (this port's kernel)"
    if "flash_fp32_dq" in name:
        return "flash_attn_fp32 dq (this port's kernel)"
    if "flash_fp32_dkv" in name or "flash_fp32_bwd_sum" in name:
        return "flash_attn_fp32 dk/dv, split sums (this port's kernel)"
    if "wino_" in name:
        return f"winograd{' fp32' if 'fp32' in name else ''} (this port's kernel)"
    if "flash_fwd_packed" in name:
        return "flash_attn_packed forward (this port's kernel)"
    if "flash_bwd_dq" in name:
        return "flash_attn_bwd dq (this port's kernel)"
    if "flash_bwd_dkv" in name or "dkv_sum_kernel" in name:
        return "flash_attn_bwd dk/dv (this port's kernel)"
    if "fprop" in name or "conv" in name.lower() or "dgrad" in name:
        return "convolutions (cuDNN)"
    if "gemm" in name.lower() or "nvjet" in name or "cutlass" in name:
        return "matrix products (cuBLAS)"
    if "at::native" in name:
        return "elementwise, reductions, norms (PyTorch)"
    return "other"


def phase_profile(torch, pipe, card):
    """Stage times, then one whole request under torch.profiler: device
    kernel time by category and the device's idle share of the request."""
    from adaface_tpu_torch.models.unet import precompute_cross_kv

    prompts = [PROMPT] * BATCH
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((BATCH, SIZE // 8, SIZE // 8, 4), generator=gen, device="cuda")
    t = torch.full((BATCH,), 501, dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        encode = lambda: (pipe.encode_prompts(prompts), pipe.encode_negative("", BATCH))
        ctx = pipe.encode_prompts(prompts)
        ctx = torch.cat([ctx, pipe.encode_negative("", BATCH).expand_as(ctx)], dim=1)
        kv = precompute_cross_kv(pipe.unet, ctx)
        unet_ms = time_ms(torch, lambda: pipe.unet(x, t, ctx, cfg_dedup=True, cross_kv=kv),
                          reps=5, rounds=3)
        encode_ms = time_ms(torch, encode, reps=5, rounds=3)
        vae_ms = time_ms(torch, lambda: pipe.vae.decode(x), reps=3, rounds=3)
    say(f"[profile] stages (CUDA events, mean of back-to-back calls): text encode {encode_ms:.3f} ms, "
        f"one UNet call (B{2 * BATCH} 64x64) {unet_ms:.3f} ms, VAE decode (B{BATCH}) "
        f"{vae_ms:.3f} ms [{card}]")
    kw = dict(num_steps=STEPS, guidance_scale=(10.0, 4.0), height=SIZE, width=SIZE)
    profile_breakdown(torch, lambda: pipe.generate(prompts, seed=4, **kw), "profile",
                      "one request", card)


def profile_breakdown(torch, fn, tag, what, card):
    """Run fn() once under torch.profiler: device kernel time by category,
    the top kernels, and the device's idle share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    dev = lambda e: getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
    kernels = [e for e in prof.key_averages() if dev(e) > 0
               and str(getattr(e, "device_type", "")).endswith("CUDA")]
    total_ms = sum(dev(e) for e in kernels) / 1e3
    if total_ms == 0:
        say(f"[{tag}] the profiler reported no device time: breakdown not measured")
        return
    say(f"[{tag}] {what} under the profiler: wall {wall_ms:.1f} ms, device "
        f"kernel time {total_ms:.1f} ms, device idle share {1 - total_ms / wall_ms:.3f} "
        f"[{card}]")
    by_cat = {}
    for e in kernels:
        c = by_cat.setdefault(_category(e.key), [0.0, 0])
        c[0] += dev(e) / 1e3
        c[1] += e.count
    for cat, (ms, n) in sorted(by_cat.items(), key=lambda kv: -kv[1][0]):
        say(f"[{tag}]   {ms:9.1f} ms {100 * ms / total_ms:5.1f}% {n:7d} launches  {cat}")
    for e in sorted(kernels, key=dev, reverse=True)[:10]:
        say(f"[{tag}]   top {dev(e) / 1e3:9.1f} ms x{e.count:<6d} {e.key[:100]}")


def add_training_placeholders(torch, pipe):
    """`z` (9 vectors) and background `y` (4), rank 10, initialized from the
    CLIP token embeddings of "person" and "unknown" as the JAX training
    script does; fp32 on the pipeline's device."""
    tok, mgr = pipe.tokenizer, pipe.embedding_manager
    table = pipe.clip.token_embedding.weight.detach().float().cpu().numpy()
    gen = torch.Generator(device=pipe.device).manual_seed(11)
    for s, k, bg, word in (("z", 9, False, "person"), ("y", 4, True, "unknown")):
        tid = tok.extra_tokens.get(s) or tok.add_placeholder(s)
        mgr.add_placeholder(s, token_id=tid, num_vectors=k, is_background=bg,
                            init_vecs=table[tok.encode(word)], rank=10,
                            emb_dim=table.shape[1], generator=gen, device=pipe.device)


def make_dataset(folder, size=SIZE, subjects=1, dark=(), **kw):
    """A `PersonalizedDataset` whose images and fg masks are made from a
    seed instead of read from files (the card's machine has no PIL);
    augmentation and prompts are the port's own. `subjects` > 1 makes that
    many subjects of 4 images, each in a subfolder; image i of subject j is
    drawn below ZS_DARK_LEVEL where (j, i) is in `dark`; `kw` goes to the
    dataset."""
    import numpy as np

    from adaface_tpu_torch.data.personalized import PersonalizedDataset, SubjectSpec

    specs = []
    for j in range(subjects):
        sub = folder if subjects == 1 else os.path.join(folder, f"s{j}")
        os.makedirs(sub, exist_ok=True)
        for i in range(4):
            for name in (f"{i}.png", f"{i}_mask.png"):
                open(os.path.join(sub, name), "wb").close()
        specs.append(SubjectSpec("subject" if subjects == 1 else f"subject{j}", sub))

    class SeededImages(PersonalizedDataset):
        def _load(self, rec):
            i = int(os.path.basename(rec.path).split(".")[0])
            j = rec.subject_idx
            g = np.random.default_rng(100 + i + 10 * j)
            top = ZS_DARK_LEVEL if (j, i) in dark else 256
            image = g.integers(0, top, (size, size, 3), dtype=np.uint8)
            mask = np.zeros((size, size), np.uint8)
            mask[size // 5 + 8 * i: size - size // 5, size // 4: size - size // 4 + 8 * i] = 255
            return image, mask, True

    return SeededImages(specs, size=size, seed=0, **kw)


def train_configs(logdir, gap=COMPOS_GAP):
    """`configs/finetune-static-layerwise.yaml`'s trainer and iter_plan
    values, read by the port's own YAML reader (the card's machine has no
    pyyaml), for TRAIN_STEPS micro-steps without checkpoints or logging on
    the way, and without zero-shot; `gap` 0 makes a recon-only run."""
    import dataclasses

    from adaface_tpu_torch.config import load_config
    from adaface_tpu_torch.training.iter_plan import IterPlanConfig
    from adaface_tpu_torch.training.trainer import TrainerConfig

    cfg = load_config(os.path.join(CONFIG_DIR, "finetune-static-layerwise.yaml"))
    fields = lambda cls, section: {k: v for k, v in cfg[section].items()
                                   if k in {f.name for f in dataclasses.fields(cls)}}
    return (TrainerConfig(**dict(fields(TrainerConfig, "trainer"), max_steps=TRAIN_STEPS,
                                 log_every_steps=10 ** 6, ckpt_every_steps=10 ** 6,
                                 logdir=logdir)),
            IterPlanConfig(**dict(fields(IterPlanConfig, "iter_plan"),
                                  composition_regs_iter_gap=gap, do_zero_shot=False)))


def upsample_path():
    """The Upsample path that ADAFACE_SUBPIXEL_UP selects, for the logs."""
    return "naive" if os.environ.get("ADAFACE_SUBPIXEL_UP") == "0" else "phase fold"


@contextlib.contextmanager
def bf16_upsample_reference(torch):
    """Within the block the UNet's Upsample computes, in an fp32 model, the
    function of the bf16 model's: under the default knobs (JAX's phase
    fold, which sums the taps in the weight's dtype) the taps are folded in
    bf16 and the rest runs in fp32; under ADAFACE_SUBPIXEL_UP=0 the naive
    path is left as it is (its weights are the bf16 ones either way)."""
    from adaface_tpu_torch.models import unet as unet_mod
    from adaface_tpu_torch.ops import subpixel

    plain = unet_mod.upsample_conv
    if upsample_path() == "phase fold":
        unet_mod.upsample_conv = lambda x, w, b=None: subpixel.upsample2x_conv(
            x, w.to(torch.bfloat16), b)
    try:
        yield
    finally:
        unet_mod.upsample_conv = plain


@contextlib.contextmanager
def first_output(module, store):
    """Within the block, store[0] is the first output of `module` (for a
    UNet its eps), in fp32 on the CPU."""
    def hook(mod, inp, out):
        if not store:
            store.append((out[0] if isinstance(out, tuple) else out).detach().float().cpu())

    handle = module.register_forward_hook(hook)
    try:
        yield store
    finally:
        handle.remove()


def loss_tol():
    """The loss gate of 8 and 8b on the Upsample path the knob selects."""
    return FOLD_LOSS_TOL if upsample_path() == "phase fold" else TRAIN_LOSS_TOL


def phase_train_reference(torch, pipe, trainer_cls, tmp):
    """One recon loss and its embedder gradients at SD widths on a 32x32
    latent (batch 1): bf16 on the card vs the same weights in fp32 on the
    CPU, the reference's Upsample as `bf16_upsample_reference` sets it,
    through the trainer's own batch preparation and step. Gates the loss
    (`loss_tol`), the gradients and the UNet's eps; returns eps's relative
    L2 error."""
    import dataclasses

    from adaface_tpu_torch.personalization.static_embedding import embedder_leaves
    from adaface_tpu_torch.training.iter_plan import IterPlan
    from adaface_tpu_torch.training.train_step import make_recon_train_step

    tag = "ref_" + upsample_path().replace(" ", "_")
    tcfg, pcfg = train_configs(os.path.join(tmp, tag))
    tcfg = dataclasses.replace(tcfg, batch_size=1)
    ds_dir = os.path.join(tmp, f"{tag}_subject")
    os.makedirs(ds_dir)
    trainer = trainer_cls(pipe, make_dataset(ds_dir, size=256), tcfg, pcfg)
    plan = IterPlan(use_background_token=True)
    batch = trainer.build_recon_batch(plan)  # 32x32 latents from the card's VAE
    step = trainer._get_recon_step(True)

    def copy_embedders(mgr, device):
        return {s: dataclasses.replace(p, **{n: t.detach().float().to(device)
                                             .clone().requires_grad_(True)
                                             for n, t in embedder_leaves(p)})
                for s, p in mgr.embedders.items()}

    cpu_copy = lambda m: cpu_fp32_copy(torch, m).requires_grad_(False)

    emb_gpu = copy_embedders(pipe.embedding_manager, pipe.device)
    eps_gpu, eps_cpu = [], []
    with first_output(pipe.unet, eps_gpu):
        loss_gpu, m_gpu = step.loss_fn(emb_gpu, batch)
    loss_gpu.backward()
    unet_cpu = cpu_copy(pipe.unet)
    cpu_step = make_recon_train_step(
        cpu_copy(pipe.clip), unet_cpu, pipe.base_sched, None,
        skip_weights=pipe.skip_weights,
        bg_weight=tcfg.bg_recon_weight, emb_reg_weight=trainer._emb_reg_w,
        prompt_delta_weight=trainer._delta_w,
        complem_weight=tcfg.fg_bg_complementary_loss_weight,
        xlayer_weight=tcfg.fg_bg_xlayer_consist_loss_weight, use_bg_token=True,
        do_zero_shot=False, bg_placeholders=frozenset({"y"}))
    to_cpu = lambda t: None if t is None else t.detach().float().cpu()
    batch_cpu = batch._replace(**{f: to_cpu(getattr(batch, f)) for f in
                                  ("latents", "fg_mask", "noise", "img_mask", "have_fg_mask")},
                               timesteps=batch.timesteps.cpu())
    emb_cpu = copy_embedders(pipe.embedding_manager, "cpu")
    t0 = time.time()
    with bf16_upsample_reference(torch), first_output(unet_cpu, eps_cpu):
        loss_cpu, m_cpu = cpu_step.loss_fn(emb_cpu, batch_cpu)
        loss_cpu.backward()
    say(f"[train-ref] fp32 CPU loss and gradients in {time.time() - t0:.1f} s")
    trainer.close()
    worst = 0.0
    for k in sorted(m_cpu):
        a, b = m_gpu[k].item(), m_cpu[k].item()
        say(f"[train-ref] {k:22s} card {a:.6e} cpu {b:.6e} relative error "
            f"{abs(a - b) / max(abs(b), 1e-12):.3e}")
        if not torch.isfinite(m_gpu[k]):
            fail(f"training reference: non-finite {k} on the card")
    loss_err = abs(loss_gpu.item() - loss_cpu.item()) / abs(loss_cpu.item())
    eps_err = rel_err(eps_gpu[0], eps_cpu[0])
    if not loss_err <= loss_tol() or not eps_err <= TRAIN_EPS_TOL:
        fail(f"training reference: loss off by {loss_err:.3e} (tol {loss_tol()}), eps by "
             f"{eps_err:.3e} (tol {TRAIN_EPS_TOL})")
    for s in sorted(emb_cpu):
        for (n, g), (_, c) in zip(embedder_leaves(emb_gpu[s]), embedder_leaves(emb_cpu[s])):
            e = rel_err(g.grad, c.grad)
            worst = max(worst, e)
            say(f"[train-ref] grad {s}.{n:18s} relative L2 error {e:.3e} (|g| {c.grad.norm():.3e})")
            if not torch.isfinite(g.grad).all() or not e <= TRAIN_GRAD_TOL:
                fail(f"training reference: gradient {s}.{n} off by {e:.3e} "
                     f"(tol {TRAIN_GRAD_TOL})")
    say(f"[train-ref] loss relative error {loss_err:.3e} (tol {loss_tol()}); eps relative L2 "
        f"error {eps_err:.3e} (tol {TRAIN_EPS_TOL}); worst gradient relative L2 error "
        f"{worst:.3e} (tol {TRAIN_GRAD_TOL}) [Upsample: {upsample_path()}]")
    return eps_err


def phase_compos_reference(torch, pipe, trainer_cls, tmp):
    """(8b) One compos loss and its embedder gradients at SD widths on a
    64x64 latent (512x512 images, one block: 4 UNet rows), through the
    trainer's own batch preparation (bg token, fg-initialized x_start) and
    step: bf16 against an fp32 copy of CLIP and the UNet on the card, built
    with `use_flash_attention=False` (einsum attention) while the fused
    knobs are off and TF32 is off (an fp32 UNet on the CPU is too slow at
    this size), its Upsample as `bf16_upsample_reference` sets it. Gates
    the loss (`loss_tol`), the gradients and the UNet's eps; returns eps's
    relative L2 error."""
    import dataclasses

    from adaface_tpu_torch.personalization.static_embedding import embedder_leaves
    from adaface_tpu_torch.training.iter_plan import COMPOS_DISTILL, IterPlan
    from adaface_tpu_torch.training.train_step import make_compos_distill_step

    tag = "compos_ref_" + upsample_path().replace(" ", "_")
    tcfg, pcfg = train_configs(os.path.join(tmp, tag))
    ds_dir = os.path.join(tmp, f"{tag}_subject")
    os.makedirs(ds_dir)
    trainer = trainer_cls(pipe, make_dataset(ds_dir), tcfg, pcfg)
    plan = IterPlan(iter_type=COMPOS_DISTILL, use_background_token=True,
                    comp_init_fg_from_training_image=True, training_percent=0.3)
    batch = trainer.build_compos_batch(plan)
    if tuple(batch.latents.shape) != (1, SIZE // 8, SIZE // 8, 4) or not batch.preserve_loss_scale:
        fail(f"compos reference: latents {tuple(batch.latents.shape)}, preserve scale "
             f"{batch.preserve_loss_scale}: not the fg-initialized 64x64 block")
    step = trainer._get_compos_step()

    def copy_embedders(mgr):
        return {s: dataclasses.replace(p, **{n: t.detach().float().clone().requires_grad_(True)
                                             for n, t in embedder_leaves(p)})
                for s, p in mgr.embedders.items()}

    def fp32_copy(m, **cfg_kw):
        with torch.device("meta"):
            c = type(m)(dataclasses.replace(m.cfg, **cfg_kw))
        c = c.to_empty(device=pipe.device)
        c.load_state_dict({k: v.float() for k, v in m.state_dict().items()})
        return c.eval().requires_grad_(False)

    emb_bf16 = copy_embedders(pipe.embedding_manager)
    eps_bf16, eps_ref = [], []
    with first_output(pipe.unet, eps_bf16):
        loss_bf16, m_bf16 = step.loss_fn(emb_bf16, batch)
    loss_bf16.backward()
    unet_ref = fp32_copy(pipe.unet, use_flash_attention=False)
    ref_step = make_compos_distill_step(
        fp32_copy(pipe.clip), unet_ref, pipe.base_sched,
        None, skip_weights=pipe.skip_weights, prompt_delta_weight=trainer._delta_w,
        mix_prompt_distill_weight=pcfg.mix_prompt_distill_weight, do_zero_shot=False,
        bg_placeholders=trainer._bg_placeholders)
    emb_ref = copy_embedders(pipe.embedding_manager)
    t0 = time.time()
    with bf16_upsample_reference(torch), first_output(unet_ref, eps_ref):
        loss_ref, m_ref = ref_step.loss_fn(emb_ref, batch)
        loss_ref.backward()
    torch.cuda.synchronize()
    say(f"[compos-ref] fp32 loss and gradients on the card in {time.time() - t0:.1f} s")
    trainer.close()
    for k in sorted(m_ref):
        a, b = m_bf16[k].item(), m_ref[k].item()
        say(f"[compos-ref] {k:22s} bf16 {a:.6e} fp32 {b:.6e} relative error "
            f"{abs(a - b) / max(abs(b), 1e-12):.3e}")
        if not torch.isfinite(m_bf16[k]):
            fail(f"compos reference: non-finite {k} in bf16")
        if b == 0:
            fail(f"compos reference: the fp32 {k} is zero (a term is not wired)")
    loss_err = abs(loss_bf16.item() - loss_ref.item()) / abs(loss_ref.item())
    eps_err = rel_err(eps_bf16[0], eps_ref[0])
    if not loss_err <= loss_tol() or not eps_err <= TRAIN_EPS_TOL:
        fail(f"compos reference: loss off by {loss_err:.3e} (tol {loss_tol()}), eps by "
             f"{eps_err:.3e} (tol {TRAIN_EPS_TOL})")
    worst = 0.0
    for s in sorted(emb_ref):
        for (n, g), (_, c) in zip(embedder_leaves(emb_bf16[s]), embedder_leaves(emb_ref[s])):
            e = rel_err(g.grad, c.grad)
            worst = max(worst, e)
            say(f"[compos-ref] grad {s}.{n:18s} relative L2 error {e:.3e} (|g| {c.grad.norm():.3e})")
            if not torch.isfinite(g.grad).all() or not e <= TRAIN_GRAD_TOL:
                fail(f"compos reference: gradient {s}.{n} off by {e:.3e} (tol {TRAIN_GRAD_TOL})")
    say(f"[compos-ref] loss relative error {loss_err:.3e} (tol {loss_tol()}); eps relative L2 "
        f"error {eps_err:.3e} (tol {TRAIN_EPS_TOL}); worst gradient relative L2 error "
        f"{worst:.3e} (tol {TRAIN_GRAD_TOL}) [Upsample: {upsample_path()}]")
    del ref_step, unet_ref, emb_ref, emb_bf16, loss_ref, loss_bf16
    torch.cuda.empty_cache()
    return eps_err


def launches_between(before, after):
    """kind -> (B, L, H, d) -> flash launches between two snapshots of
    `launches_by_shape`."""
    out = {}
    for (kind, arm, b, lq, lk, h, d), n in after.items():
        n -= before.get((kind, arm, b, lq, lk, h, d), 0)
        if n:
            out.setdefault(kind, {})[(b, lq, h, d)] = n
    return out


def flash_want(shapes):
    """kind -> (B, L, H, d) -> flash launches of one micro-step."""
    want = {"fwd": {s: n for s, (_, n, _) in shapes.items()}}
    want["dq"] = want["dkv"] = {s: n for s, (_, _, n) in shapes.items()}
    return want


def is_compos_step(i):
    return i % COMPOS_GAP == 0


def kind_medians(times):
    """(recon, compos) median seconds a micro-step, each kind's first
    micro-step (its warm-up) left out."""
    recon = [t for i, t in enumerate(times) if not is_compos_step(i)]
    compos = [t for i, t in enumerate(times) if is_compos_step(i)]
    return statistics.median(recon[1:]), statistics.median(compos[1:])


def phase_fold_eps_ratio(torch, pipe, trainer_cls, tmp):
    """(8, 8b) under the default Upsample fold, then under
    ADAFACE_SUBPIXEL_UP=0; each phase's eps error under the fold within
    FOLD_EPS_RATIO of its eps error under the naive path."""
    errs = {}
    for values in ({}, SUBPIXEL_NAIVE):
        with knobs_set(values):
            errs[upsample_path()] = (phase_train_reference(torch, pipe, trainer_cls, tmp),
                                     phase_compos_reference(torch, pipe, trainer_cls, tmp))
    for what, fold, naive in zip(("recon", "compos"), errs["phase fold"], errs["naive"]):
        say(f"[train-ref] {what} eps relative L2 error under the fold {fold:.3e}, naive "
            f"{naive:.3e} ({fold / naive:.3f}x; limit {FOLD_EPS_RATIO}x)")
        if not fold <= FOLD_EPS_RATIO * naive:
            fail(f"{what} reference: the fold's eps error {fold:.3e} exceeds "
                 f"{FOLD_EPS_RATIO} x the naive path's {naive:.3e}")


def phase_train(torch, pipe, fa, trainer_cls, tmp, card):
    """`Trainer.fit` at SD width on the shipped config (gap 3): TRAIN_STEPS
    micro-steps, each timed and each checked for its launches (a recon one
    TRAIN_SHAPES', a compos one COMPOS_SHAPES': 15 forward, 14 dq and 14
    dk/dv); then one more micro-step of each kind under the profiler.
    Returns (launch totals, recon median s, compos median s, peak GiB)."""
    import numpy as np

    from adaface_tpu_torch.personalization.embedding_manager import EmbeddingManager
    from adaface_tpu_torch.personalization.static_embedding import embedder_leaves

    tcfg, pcfg = train_configs(os.path.join(tmp, "run"))
    ds_dir = os.path.join(tmp, "subject")
    os.makedirs(ds_dir)
    trainer = trainer_cls(pipe, make_dataset(ds_dir), tcfg, pcfg)
    mgr = pipe.embedding_manager
    leaves = lambda: {(s, n): t.detach().clone() for s, p in mgr.embedders.items()
                      for n, t in embedder_leaves(p)}
    start = leaves()
    wants = {False: flash_want(TRAIN_SHAPES), True: flash_want(COMPOS_SHAPES)}
    totals = {}
    times = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches_by_shape.clear()
    for i in range(TRAIN_STEPS):
        before = dict(fa.launches_by_shape)
        torch.cuda.synchronize()
        t0 = time.time()
        trainer.fit(i + 1)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        step_counts = launches_between(before, fa.launches_by_shape)
        what = "compos" if is_compos_step(i) else "recon"
        say(f"[train] micro-step {i} ({what}): {times[-1]:.3f} s, launches "
            f"{ {k: sorted(v.items()) for k, v in sorted(step_counts.items())} } [{card}]")
        if step_counts != wants[is_compos_step(i)]:
            fail(f"micro-step {i} ({what}): expected the launches "
                 f"{wants[is_compos_step(i)]}, got {step_counts}")
        if i == 1:  # the first optimizer update
            moved = max(float((t - start[key]).abs().max()) for key, t in leaves().items())
            finite = all(bool(torch.isfinite(t).all()) for t in leaves().values())
            say(f"[train] after the first update: embedders moved by up to {moved:.3e}, "
                f"finite {finite}")
            if not finite or not moved > 0:
                fail("the first optimizer update left the embedders unchanged or non-finite")
    for (kind, arm, b, lq, lk, h, d), n in fa.launches_by_shape.items():
        totals[(kind, b, lq, h, d)] = n
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    recs = [json.loads(l) for l in open(os.path.join(tcfg.logdir, "metrics.jsonl"))]
    steps = [r for r in recs if "loss" in r]
    kinds = [r["iter_type"] for r in steps]
    if kinds != ["compos_distill" if is_compos_step(i) else "recon" for i in range(TRAIN_STEPS)]:
        fail(f"the micro-steps ran as {kinds}, not compos every {COMPOS_GAP}")
    if len(steps) != TRAIN_STEPS or not all(
            np.isfinite(v) for r in steps for v in r.values() if isinstance(v, float)):
        fail(f"metrics: {len(steps)} step records, or a non-finite value")
    for kind in ("recon", "compos_distill"):
        last = [r for r in steps if r["iter_type"] == kind][-1]
        say(f"[train] metrics of the last {kind} micro-step: "
            f"{ {k: round(v, 6) for k, v in last.items() if isinstance(v, float)} }")
    reloaded = EmbeddingManager.load_native(os.path.join(tcfg.logdir, "embeddings_last.npz"))
    for s, p in mgr.embedders.items():
        for n, t in embedder_leaves(p):
            if not np.array_equal(getattr(reloaded.embedders[s], n).numpy(),
                                  t.detach().cpu().numpy()):
                fail(f"checkpoint reload: {s}.{n} differs")
    med, compos_med = kind_medians(times)
    say(f"[train] recon micro-step, batch 3 512x512, bf16: median {med:.3f} s after the "
        f"first recon one ({times[1]:.3f} s), {3 / med:.3f} images/s; compos micro-step, "
        f"one block (4 UNet rows) 512x512: median {compos_med:.3f} s after the first "
        f"({times[0]:.3f} s); peak memory {peak:.2f} GiB; checkpoint reloads [{card}]")
    profile_breakdown(torch, lambda: trainer.fit(TRAIN_STEPS + 1), "train-profile",
                      "one recon micro-step", card)
    profile_breakdown(torch, lambda: trainer.fit(TRAIN_STEPS + 2), "compos-profile",
                      "one compos micro-step", card)
    train_stages(torch, trainer, card)
    trainer.close()
    return totals, med, compos_med, peak


def phase_fused_train(torch, pipe, trainer_cls, tmp, card, default_med, default_compos_med,
                      default_peak):
    """A fresh Trainer (gap 3) under FUSED_KNOBS for FUSED_TRAIN_STEPS
    micro-steps, each with the flash launches of the default run plus 45 K8
    and 4 K9 (GN_TRAIN_SHAPES and FF_TRAIN_SHAPES on a recon micro-step,
    GN_COMPOS_SHAPES and FF_COMPOS_SHAPES on a compos one); metrics finite,
    embedders moved by the first update; then one micro-step under the
    profiler. Returns the K8 and K9 launches of the timed micro-steps by
    shape."""
    import numpy as np

    from adaface_tpu_torch.personalization.static_embedding import embedder_leaves

    fa = _fa()
    fn, ff = _fused_ops()
    tcfg, pcfg = train_configs(os.path.join(tmp, "fused"))
    ds_dir = os.path.join(tmp, "fused_subject")
    os.makedirs(ds_dir)
    mgr = pipe.embedding_manager
    leaves = lambda: {(s, n): t.detach().clone() for s, p in mgr.embedders.items()
                      for n, t in embedder_leaves(p)}
    wants = {}
    for compos, shapes, gn, ff_shapes in ((False, TRAIN_SHAPES, GN_TRAIN_SHAPES, FF_TRAIN_SHAPES),
                                          (True, COMPOS_SHAPES, GN_COMPOS_SHAPES,
                                           FF_COMPOS_SHAPES)):
        wants[compos] = dict(flash_want(shapes), gn=_typed(gn), ff=_typed(ff_shapes))
    counters = {"gn": fn.launches_by_shape, "ff": ff.launches_by_shape}
    times = []
    with knobs_set(FUSED_KNOBS):
        trainer = trainer_cls(pipe, make_dataset(ds_dir), tcfg, pcfg)
        start = leaves()
        for m in (fa, fn, ff):
            m.launches_by_shape.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i in range(FUSED_TRAIN_STEPS):
            before = {k: dict(c) for k, c in counters.items()}
            before_fa = dict(fa.launches_by_shape)
            torch.cuda.synchronize()
            t0 = time.time()
            trainer.fit(i + 1)
            torch.cuda.synchronize()
            times.append(time.time() - t0)
            got = {}
            for (kind, arm, b, lq, lk, h, d), n in fa.launches_by_shape.items():
                n -= before_fa.get((kind, arm, b, lq, lk, h, d), 0)
                if n:
                    got.setdefault(kind, {})[(b, lq, h, d)] = n
            for kind, c in counters.items():
                got[kind] = {k: n - before[kind].get(k, 0) for k, n in c.items()
                             if n - before[kind].get(k, 0)}
            what = "compos" if is_compos_step(i) else "recon"
            say(f"[fused-train] micro-step {i} ({what}): {times[-1]:.3f} s, launches "
                f"{ {k: sum(v.values()) for k, v in sorted(got.items())} } [{card}]")
            if got != wants[is_compos_step(i)]:
                fail(f"fused micro-step {i} ({what}): expected the launches "
                     f"{wants[is_compos_step(i)]}, got {got}")
            if i == 1:  # the first optimizer update
                moved = max(float((t - start[key]).abs().max()) for key, t in leaves().items())
                finite = all(bool(torch.isfinite(t).all()) for t in leaves().values())
                say(f"[fused-train] after the first update: embedders moved by up to "
                    f"{moved:.3e}, finite {finite}")
                if not finite or not moved > 0:
                    fail("fused training: the first update left the embedders unchanged "
                         "or non-finite")
        totals = {k: dict(c) for k, c in counters.items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        recs = [json.loads(l) for l in open(os.path.join(tcfg.logdir, "metrics.jsonl"))]
        steps = [r for r in recs if "loss" in r]
        if len(steps) != FUSED_TRAIN_STEPS or not all(
                np.isfinite(v) for r in steps for v in r.values() if isinstance(v, float)):
            fail(f"fused metrics: {len(steps)} step records, or a non-finite value")
        recon = [t for i, t in enumerate(times) if not is_compos_step(i)]
        compos = [t for i, t in enumerate(times) if is_compos_step(i)]
        say(f"[fused-train] under {FUSED_KNOBS}, bf16 512x512: recon micro-step (batch 3) "
            f"median {statistics.median(recon[1:]):.3f} s after the first ({recon[0]:.3f} s), "
            f"compos micro-step (4 rows) {compos[1]:.3f} s after the first ({compos[0]:.3f} "
            f"s), peak memory {peak:.2f} GiB; default knobs {default_med:.3f} s recon, "
            f"{default_compos_med:.3f} s compos, {default_peak:.2f} GiB [{card}]")
        profile_breakdown(torch, lambda: trainer.fit(FUSED_TRAIN_STEPS + 1),
                          "fused-train-profile", "one recon micro-step under the fused knobs",
                          card)
        trainer.close()
    return totals["gn"], totals["ff"]


def train_stages(torch, trainer, card):
    """Where a micro-step's wall time goes, one more micro-step of each kind
    taken apart: drawing and augmenting the examples (host numpy), the whole
    batch preparation (that, tokenizing, the VAE encode and the host RNG
    draws; for a compos one the x_start too), and the step (loss, backward,
    optimizer), each ended by a synchronize."""
    from adaface_tpu_torch.training.iter_plan import COMPOS_DISTILL, RECON, plan_iteration

    for kind, step in ((RECON, trainer.global_step + 1), (COMPOS_DISTILL, 0)):
        # a plan of this kind, as `fit` would roll it at that step
        plan = plan_iteration(trainer.rng, step, trainer.plan_cfg)
        if plan.iter_type != kind:
            fail(f"train stages: step {step} rolled {plan.iter_type}, not {kind}")
        compos = kind == COMPOS_DISTILL
        t0 = time.time()
        trainer._draw_examples(1 if compos else trainer.cfg.batch_size)
        t1 = time.time()
        if compos:
            batch = trainer.build_compos_batch(plan)
            run = trainer._get_compos_step()
        else:
            batch = trainer.build_recon_batch(plan)
            run = trainer._get_recon_step(plan.use_background_token)
        torch.cuda.synchronize()
        t2 = time.time()
        run(trainer.mgr.embedders, batch)
        torch.cuda.synchronize()
        t3 = time.time()
        say(f"[train] stages of one {kind} micro-step: examples drawn and augmented on the "
            f"host {(t1 - t0) * 1e3:.1f} ms, whole batch preparation with the VAE encode "
            f"{(t2 - t1) * 1e3:.1f} ms, step (loss, backward, optimizer) "
            f"{(t3 - t2) * 1e3:.1f} ms [{card}]")


# ----------------------------------------------------------------- slice 13
# fp32 pipelines: the hand-written fp32 flash kernel (4g), and the port's
# training entry point on the shipped per-subject configs (9d).
FP32_SOURCE = "adaface_tpu_torch/csrc/flash_attn_fp32.cu"
# H100 SXM data sheet: float32 outside the tensor cores
PEAK_FP32_FLOPS = 67e12
# (B, L, H, d) of 4g: the recon (B3) and compos (B4) training shapes with
# and without key bias, and the generate shapes (forward only; an fp32
# request runs them, [fp32-main])
FP32_TRAIN_SHAPES = {**TRAIN_SHAPES, **COMPOS_SHAPES}
FP32_GENERATE_SHAPES = tuple(MAIN_SHAPES)
# the fp32 forward's edge cases in 4g: (B, Lq, Lk, H, d, key bias, K1 flags,
# offset of each row's start in floats: 1 leaves rows unaligned, the 4-byte
# copies); with a key bias and B > 1, batch row 0 is fully masked. Lk 20
# gives the split plan a key range with no key.
FP32_FWD_EDGES = [(2, 200, 77, 3, 40, True, 0, 0), (2, 200, 77, 3, 80, False, 0, 0),
                  (2, 200, 77, 3, 160, True, 0, 0), (1, 4095, 4095, 2, 160, False, 0, 0),
                  (1, 4095, 333, 2, 40, True, 0, 0), (24, 1024, 1024, 1, 40, True, 0, 0),
                  (1, 64, 20, 2, 80, True, 0, 0), (1, 64, 33, 2, 160, True, 0, 0),
                  (2, 300, 300, 2, 40, True, 0, 1), (2, 300, 300, 2, 160, False, 0, 1),
                  (2, 1024, 1024, 8, 40, True, 1, 0), (2, 1024, 1024, 8, 80, True, 2, 0),
                  (2, 1024, 1024, 8, 160, True, 3, 0), (3, 256, 256, 8, 160, False, 1, 0)]
# the fp32 backward's edge cases in 4g: (B, Lq, Lk, H, d, key bias, offset
# of each row's start in floats: 1 leaves rows unaligned, the 4-byte copies
# and stores); with a key bias and B > 1, batch row 0 is fully masked. Lq !=
# Lk, lengths that are not multiples of the tiles or of a CTA's rows, the K6
# one-head fold (B24 H1), Lk 20 and Lq 20 (a tile, and CTAs of the plan,
# with rows or keys past the end).
FP32_BWD_EDGES = [(1, 4095, 333, 2, 40, True, 0), (1, 333, 4095, 2, 80, False, 0),
                  (2, 200, 77, 3, 160, True, 0), (2, 300, 300, 2, 40, True, 1),
                  (2, 300, 300, 2, 160, False, 1), (1, 130, 200, 2, 80, True, 1),
                  (24, 1024, 1024, 1, 40, True, 0), (1, 64, 20, 2, 80, True, 0),
                  (1, 20, 64, 2, 160, True, 0), (2, 4095, 4095, 1, 160, True, 0)]
# fp32 kernel vs its plain fp32 version on the same fp32 inputs: both sum
# fp32 products in other orders, so they agree to fp32 rounding (measured
# on an H100: relative L2 1e-8..7e-7 for o, dq, dk, dv and dbias, lse within
# 2e-6 of values up to ~12). Gates: relative L2 and max abs relative to the
# largest plain value (1 for lse), each 1e-5; planted faults (a key tile
# skipped, a wrong scale, delta omitted, ...) must fail them.
FP32_REL_TOL = 1e-5
FP32_ABS_TOL = 1e-5
FP32_KINDS = {"fwd": "fwd_fp32", "dq": "dq_fp32", "dkv": "dkv_fp32"}
# 9d: micro-steps of each entry-point run (gap 3: compos at 0 and 3), and of
# the uninterrupted run that the resumed one continues from its step 3
CLI_STEPS = 4
CLI_RESUME_STEPS, CLI_RESUME_AT = 6, 3


def fp32_bound(b, lq, lk, h, d, exp2_rate, kind, with_bias):
    """Least time of an fp32 flash kernel: its products as FFMA flops at the
    fp32 non-tensor peak (4 x B*H*Lq*Lk*d for the forward, 6 for dq, 8 for
    dk/dv, as the bf16 bounds count them), B*H*Lq*Lk exp2, or its fp32
    inputs read once and outputs written once, whichever is largest."""
    flops = {"fwd": 4, "dq": 6, "dkv": 8}[kind] * b * h * lq * lk * d
    t_ops = max(flops / PEAK_FP32_FLOPS, b * h * lq * lk / exp2_rate)
    if kind == "fwd":
        nbytes = 4 * (b * h * d * (2 * lq + 2 * lk) + b * h * lq)
    else:
        outs = b * lq * h * d if kind == "dq" else 2 * b * lk * h * d
        nbytes = 4 * (b * h * d * (2 * lq + 2 * lk) + outs + 2 * b * h * lq)
    nbytes += 4 * b * lk if with_bias else 0
    t_bytes = nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _gate_fp32(got, ref, what):
    """(max abs, rel L2, passes) of one fp32 kernel output against its plain
    version: FP32_REL_TOL, and FP32_ABS_TOL of the largest plain value (of 1
    for the lse)."""
    err, rel = kernel_errors(got, ref)
    scale = 1.0 if what == "lse" else max(ref.abs().max().item(), 1e-30)
    return err, rel, err <= FP32_ABS_TOL * scale and rel <= FP32_REL_TOL


def phase_fp32_kernels(torch, fa, card, exp2_rate):
    """(4g) The fp32 flash kernel (`csrc/flash_attn_fp32.cu`) through the
    wrappers on fp32 tensors: the forward with its lse, dq and dk/dv/dbias
    at the training shapes (B3 and B4; with and without key bias), the
    forward at the generate shapes, against the plain versions; planted
    faults must fail the gates (the forward's also as its patched source,
    FP32_FAULTS["flash_fwd"], and dq's and dk/dv's, FP32_FAULTS["flash_dq"],
    ["flash_dkv"]); the backward and the forward repeat bit for bit; kernel
    (CUDA events, and the profiler's device time), plain and SDPA times
    (SDPA on the same fp32 inputs, TF32 off), and the bound; then the forward
    at FP32_FWD_EDGES and the backward at FP32_BWD_EDGES. Returns the
    rows of the path's configurations (bias on B3, none on B4; the generate
    shapes without bias, as a request runs them)."""
    import torch.nn.functional as F

    t_phase = time.time()
    gen = torch.Generator(device="cuda").manual_seed(13)
    rows = {}
    cases = [(shape, wb) for shape in FP32_TRAIN_SHAPES for wb in (True, False)]
    cases += [(shape, None) for shape in FP32_GENERATE_SHAPES]  # forward only
    planted = build_fp32_faults()
    fwd_fault = planted["flash_fwd"]
    for (b, l, h, d), with_bias in cases:
        inner = h * d
        rand = lambda: torch.randn((b, l, inner), generator=gen, device="cuda")
        q, k, v, do = rand(), rand(), rand(), rand()
        bias = None
        if with_bias:
            bias = torch.where(torch.rand((b, l), generator=gen, device="cuda") > 0.3,
                               0.0, -1e30)
            bias[0] = -1e30  # a fully masked batch row
        label = (f"fp32 B{b} L{l} H{h} d{d} "
                 f"{'generate' if with_bias is None else ('bias' if with_bias else 'no bias')}")
        fa.launches_by_shape.clear()
        out, lse = fa.flash_attention_blc_cuda(q, k, v, h, bias, return_lse=True)
        torch.cuda.synchronize()
        plain_out = fa.flash_attention_blc_plain(q, k, v, h, bias)
        plain_lse = fa.row_lse_plain(q, k, h, bias)
        checks = [("o", out, plain_out), ("lse", lse, plain_lse)]
        again = fa.flash_attention_blc_cuda(q, k, v, h, bias, return_lse=True)
        if not (torch.equal(again[0], out) and torch.equal(again[1], lse)):
            fail(f"{label}: two forward launches disagree on o or lse")
        faults = [("key tile 0 skipped", "o", fa.flash_attention_blc_plain(
                      q, k[:, 64:], v[:, 64:], h, None if bias is None else bias[:, 64:]),
                   plain_out),
                  (f"scale of d{d + 8}", "o", fa.flash_attention_blc_plain(
                      q, k, v, h, bias, scale=(d + 8) ** -0.5), plain_out),
                  ("key tile 0 skipped", "lse", fa.row_lse_plain(
                      q, k[:, 64:], h, None if bias is None else bias[:, 64:]), plain_lse)]
        if with_bias is not None:
            delta = fa.row_delta(out, do, h)
            dq = fa.flash_bwd_dq_cuda(q, k, v, bias, do, lse, delta, h)
            dk, dv, dbias = fa.flash_bwd_dkv_cuda(q, k, v, bias, do, lse, delta, h,
                                                  need_dbias=True)
            torch.cuda.synchronize()
            check_bwd_repeats(torch, fa, (q, k, v, bias, do, lse, delta, h),
                              (dq, dk, dv, dbias), label)
            pdq, pdk, pdv, pdb = fa.flash_backward_plain(q, k, v, bias, out, do, lse, h)
            checks += [("dq", dq, pdq), ("dk", dk, pdk), ("dv", dv, pdv)]
            if bias is not None:
                checks.append(("dbias", dbias, pdb))
            last = (l - 1) // 64 * 64
            no_delta = fa.flash_backward_plain(q, k, v, bias, torch.zeros_like(out), do, lse, h)
            no_last = fa.flash_backward_plain(q[:, :last], k, v, bias, out[:, :last],
                                              do[:, :last], lse[:, :, :last], h)
            faults += [("key tile 0 skipped", "dq", fa.flash_backward_plain(
                            q, k[:, 64:], v[:, 64:], None if bias is None else bias[:, 64:],
                            out, do, lse, h)[0], pdq),
                       ("delta omitted", "dq", no_delta[0], pdq),
                       ("delta omitted", "dk", no_delta[1], pdk),
                       ("dk without its scale", "dk", pdk / d ** -0.5, pdk),
                       ("last query tile skipped", "dk", no_last[1], pdk),
                       ("last query tile skipped", "dv", no_last[2], pdv)]
        counted = {kind: n_launches(fa, kind) for kind in FP32_KINDS.values()}
        want = {"fwd_fp32": 2, "dq_fp32": 0 if with_bias is None else 2,
                "dkv_fp32": 0 if with_bias is None else 2}
        if counted != want or n_launches(fa) != sum(want.values()):
            fail(f"{label}: the wrappers counted {dict(fa.launches_by_shape)}, want {want} "
                 "fp32 launches")
        # the planted faults: patched sources through the wrappers
        with entry_replaced(fa, FP32_FAULTS["flash_fwd"][1], fwd_fault):
            faults.insert(0, (FP32_FAULTS["flash_fwd"][2], "o",
                              fa.flash_attention_blc_cuda(q, k, v, h, bias), plain_out))
        if with_bias is not None:
            faults[1:1] = fp32_bwd_faults(fa, planted, (q, k, v, bias, do, lse, delta, h),
                                          pdq, pdk)
        errs = {}
        for what, got, ref in checks:
            if got.dtype != torch.float32 or not torch.isfinite(got).all():
                fail(f"{label}: {what} is {got.dtype} or non-finite")
            err, rel, ok = _gate_fp32(got, ref, what)
            errs[what] = err
            say(f"[fp32-kernel] {label:30s} {what:5s}: max abs err {err:.3e} rel L2 {rel:.3e}"
                f"{'' if ok else '  FAILS THE GATE'}")
            if not ok:
                fail(f"{label}: fp32 {what} disagrees with its plain version")
        for name, what, wrong, ref in faults:
            err, rel, ok = _gate_fp32(wrong, ref, what)
            say(f"[fp32-kernel]   planted fault, {name} ({what}): max abs err {err:.3e} rel "
                f"L2 {rel:.3e}")
            if ok:
                fail(f"{label}: the fp32 gate passes a planted fault ({name}, {what})")
        if with_bias is False and (b, l, h, d) in TRAIN_SHAPES:
            continue  # B3 trains with its key mask: times at the path's configuration
        if with_bias is True and (b, l, h, d) in COMPOS_SHAPES:
            continue  # B4 trains without one
        # times: the kernels, the plain versions, SDPA (fp32, TF32 off)
        fwd_ms = time_ms(torch, lambda: fa.flash_attention_blc_cuda(q, k, v, h, bias,
                                                                   return_lse=True))
        fwd_plain_ms = time_ms(torch, lambda: (fa.flash_attention_blc_plain(q, k, v, h, bias),
                                               fa.row_lse_plain(q, k, h, bias)),
                               reps=1, rounds=3, warmup=1)
        qh, kh, vh = (t.unflatten(-1, (h, d)).transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        mask = None if bias is None else bias[:, None, None, :]
        sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                      scale=d ** -0.5)
        fwd_lib_ms = time_ms(torch, lambda: sdpa().detach())
        fwd_dev_ms = device_ms(torch, lambda: fa.flash_attention_blc_cuda(
            q, k, v, h, bias, return_lse=True))
        fb = fp32_bound(b, l, l, h, d, exp2_rate, "fwd", bias is not None)
        rows[("fwd", b, l, h, d)] = dict(  # a request's forward records no lse
            replaces=(MAIN_SHAPES[(b, l, h, d)][0] if with_bias is None
                      else f"{K4 if d == 160 else K1} (+ {K3A} as the lse output)"),
            max_abs_err=max(errs["o"], errs["lse"]), ms=fwd_ms, plain_ms=fwd_plain_ms,
            bound_ms=fb[0], bound_by=fb[1], library_ms=fwd_lib_ms, device_ms=fwd_dev_ms)
        msg = (f"[fp32-kernel] {label}: fwd+lse {fwd_ms:.4f} ms, device {fwd_dev_ms:.4f} (bound "
               f"{fb[0]:.4f} {fb[1]}, sdpa fp32 {fwd_lib_ms:.4f}, plain {fwd_plain_ms:.3f})")
        if with_bias is not None:
            dq_ms = time_ms(torch, lambda: fa.flash_bwd_dq_cuda(q, k, v, bias, do, lse,
                                                                delta, h))
            dkv_ms = time_ms(torch, lambda: fa.flash_bwd_dkv_cuda(q, k, v, bias, do, lse,
                                                                  delta, h))
            dq_dev = device_ms(torch, lambda: fa.flash_bwd_dq_cuda(q, k, v, bias, do, lse,
                                                                   delta, h))
            dkv_dev = device_ms(torch, lambda: fa.flash_bwd_dkv_cuda(q, k, v, bias, do, lse,
                                                                     delta, h))
            bwd_plain_ms = time_ms(torch, lambda: fa.flash_backward_plain(
                q, k, v, bias, out, do, lse, h), reps=1, rounds=3, warmup=1)
            o_lib = sdpa()
            g_lib = do.unflatten(-1, (h, d)).transpose(1, 2)
            bwd_lib_ms = time_ms(torch, lambda: torch.autograd.grad(
                o_lib, (qh, kh, vh), g_lib, retain_graph=True))
            del o_lib
            plan = fa.bwd_fp32_launch_plan(b, h, l, l, d, torch.cuda.get_device_properties(0)
                                           .multi_processor_count)
            for kind, ms, dev, err, rep, launch in (
                    ("dq", dq_ms, dq_dev, errs["dq"], K3B, plan.dq),
                    ("dkv", dkv_ms, dkv_dev, max(errs["dk"], errs["dv"]), K3C, plan.dkv)):
                bb = fp32_bound(b, l, l, h, d, exp2_rate, kind, bias is not None)
                rows[(kind, b, l, h, d)] = dict(
                    replaces=rep, max_abs_err=err, ms=ms, plain_ms=bwd_plain_ms,
                    bound_ms=bb[0], bound_by=bb[1], library_ms=bwd_lib_ms, device_ms=dev)
                msg += (f", {kind} {ms:.4f} ms, device {dev:.4f} (bound {bb[0]:.4f} {bb[1]}, "
                        f"{bb[0] / ms:.1%} of it; rows {launch.rows}, threads {launch.threads})")
            msg += f", sdpa fp32 backward {bwd_lib_ms:.4f} ms, plain backward {bwd_plain_ms:.3f}"
        say(msg + f" [{card}]")
        del q, k, v, do, out, lse, qh, kh, vh
    for case in FP32_FWD_EDGES:
        fp32_fwd_edge(torch, fa, gen, fwd_fault, *case)
    for case in FP32_BWD_EDGES:
        fp32_bwd_edge(torch, fa, gen, planted, *case)
    say(f"[fp32-kernel] phase 4g {time.time() - t_phase:.1f} s")
    fa.launches_by_shape.clear()
    torch.cuda.empty_cache()
    return rows


def fp32_fwd_edge(torch, fa, gen, fwd_fault, b, lq, lk, h, d, with_bias, flags, offset):
    """One of 4g's edge cases of the fp32 forward (FP32_FWD_EDGES): o against
    the plain version with the same K1 flags, the lse against the unflagged
    row lse (the kernel's lse is the unflagged function's under every flag),
    both at the fp32 gates; two launches agree bit for bit; the planted
    fault fails the gate where the row maximum can grow after the first
    tile."""
    inner = h * d

    def rand(l):
        base = torch.randn((b, l, inner + offset), generator=gen, device="cuda")
        return base[:, :, offset:]

    q, k, v = rand(lq), rand(lk), rand(lk)
    bias = None
    if with_bias:
        bias = torch.where(torch.rand((b, lk), generator=gen, device="cuda") > 0.3, 0.0, -1e30)
        if b > 1:
            bias[0] = -1e30  # a fully masked batch row
    plan = fa.fwd_fp32_launch_plan(b, h, lq, lk, d, torch.cuda.get_device_properties(0)
                                   .multi_processor_count)
    label = (f"fp32 edge B{b} Lq{lq} Lk{lk} H{h} d{d} {'bias' if with_bias else 'no bias'} "
             f"flags {flags}{' unaligned' if offset else ''} (rows {plan.rows}, threads "
             f"{plan.threads}, key split {plan.key_split})")
    call = lambda: fa.flash_attention_blc_cuda(q, k, v, h, bias, return_lse=True, flags=flags)
    out, lse = call()
    again = call()
    torch.cuda.synchronize()
    if not (torch.equal(again[0], out) and torch.equal(again[1], lse)):
        fail(f"{label}: two forward launches disagree on o or lse")
    plain_out = fa.flash_attention_blc_plain(q, k, v, h, bias, flags=flags)
    plain_lse = fa.row_lse_plain(q, k, h, bias)
    for what, got, ref in (("o", out, plain_out), ("lse", lse, plain_lse)):
        if not torch.isfinite(got).all():
            fail(f"{label}: {what} is not finite")
        err, rel, ok = _gate_fp32(got, ref, what)
        say(f"[fp32-edge] {label}: {what} max abs err {err:.3e} rel L2 {rel:.3e}"
            f"{'' if ok else '  FAILS THE GATE'}")
        if not ok:
            fail(f"{label}: fp32 {what} disagrees with its plain version")
    if lk > 64:
        with entry_replaced(fa, FP32_FAULTS["flash_fwd"][1], fwd_fault):
            wrong = fa.flash_attention_blc_cuda(q, k, v, h, bias, flags=flags)
        err, rel, ok = _gate_fp32(wrong, plain_out, "o")
        say(f"[fp32-edge]   planted fault, {FP32_FAULTS['flash_fwd'][2]}: max abs err "
            f"{err:.3e} rel L2 {rel:.3e}")
        if ok:
            fail(f"{label}: the fp32 gate passes the forward's planted fault")


def fp32_bwd_faults(fa, planted, args, pdq, pdk):
    """dq and dk under the backward's planted faults (FP32_FAULTS
    "flash_dq", "flash_dkv"), their patched sources launched through the
    wrappers on `args` (q, k, v, bias, dO, lse, delta, heads): (fault, what,
    wrong, plain) rows for the gate."""
    with entry_replaced(fa, FP32_FAULTS["flash_dq"][1], planted["flash_dq"]):
        dq = fa.flash_bwd_dq_cuda(*args)
    with entry_replaced(fa, FP32_FAULTS["flash_dkv"][1], planted["flash_dkv"]):
        dk = fa.flash_bwd_dkv_cuda(*args)[0]
    return [(FP32_FAULTS["flash_dq"][2], "dq", dq, pdq),
            (FP32_FAULTS["flash_dkv"][2], "dk", dk, pdk)]


def forced_fp32_bwd(fa, kind, d, launch, warps=None, split=None):
    """(rows, threads, split) of an fp32 backward launch as its C entry takes
    them: the plan's `launch` ("dq" or "dkv" at head dim d) with its warps a
    CTA or its split of the streamed tiles replaced where given."""
    w = warps or launch.threads // 32
    return w * fa.BWD_FP32_WARP_ROWS[kind][d], 32 * w, split or launch.split


def fp32_backward_split(torch, fa, args, splits):
    """dq, dk, dv and dbias of the fp32 backward on `args` (q, k, v, bias,
    dO, lse, delta, heads) through its C entries, launched as the wrappers
    launch them but with the streamed tiles split splits[0] (dq) and
    splits[1] (dk/dv) ways."""
    q, k, v, key_bias, do, lse, delta, h = args
    b, lq, lk, d, bias, lse, delta, scale = fa._check_backward(q, k, v, key_bias, do, lse,
                                                               delta, h, None)
    plan = fa.bwd_fp32_launch_plan(b, h, lq, lk, d, torch.cuda.get_device_properties(0)
                                   .multi_processor_count)
    dq = torch.empty((b, lq, h * d), device="cuda")
    dk, dv = torch.empty((b, lk, h * d), device="cuda"), torch.empty((b, lk, h * d), device="cuda")
    dbias = torch.empty((b, h, lk), device="cuda")
    # dq's slices, or dk/dv's with dbias rounded up to 4 floats a slice
    ws = torch.empty(max(splits) * (2 * dk.numel() + dq.numel() + dbias.numel() + 4),
                     device="cuda")
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), None if bias is None else bias.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream
    st = fa._strides(q, k, v, do, dq)
    err = fa._fn("flash_attn_fp32_bwd_dq")(
        *ptrs, dq.data_ptr(), b, h, lq, lk, d, *forced_fp32_bwd(fa, "dq", d, plan.dq,
                                                                 split=splits[0]),
        ctypes.addressof(st), scale * fa.LOG2E, scale, ws.data_ptr(), stream)
    torch.cuda.synchronize()
    st = fa._strides(q, k, v, do, dk, dv)
    err = err or fa._fn("flash_attn_fp32_bwd_dkv")(
        *ptrs, dk.data_ptr(), dv.data_ptr(), dbias.data_ptr(), b, h, lq, lk, d,
        *forced_fp32_bwd(fa, "dkv", d, plan.dkv, split=splits[1]), ctypes.addressof(st),
        scale * fa.LOG2E, scale, ws.data_ptr(), stream)
    torch.cuda.synchronize()
    if err:
        fail(f"fp32 backward split {splits} at B{b} Lq{lq} Lk{lk} H{h} d{d}: CUDA error {err}")
    return dq, dk, dv, dbias


def fp32_bwd_edge(torch, fa, gen, planted, b, lq, lk, h, d, with_bias, offset):
    """One of 4g's edge cases of the fp32 backward (FP32_BWD_EDGES): dq, dk,
    dv and dbias against `flash_backward_plain` at the fp32 gates, from the
    kernel's forward (o, lse), with the plan's split and with a split of 3
    (fewer where a side has fewer tiles); two launches agree bit for bit;
    dq's and dk/dv's planted faults fail the gate."""
    inner = h * d

    def rand(l):
        base = torch.randn((b, l, inner + offset), generator=gen, device="cuda")
        return base[:, :, offset:]

    q, k, v, do = rand(lq), rand(lk), rand(lk), rand(lq)
    bias = None
    if with_bias:
        bias = torch.where(torch.rand((b, lk), generator=gen, device="cuda") > 0.3, 0.0, -1e30)
        if b > 1:
            bias[0] = -1e30  # a fully masked batch row
    plan = fa.bwd_fp32_launch_plan(b, h, lq, lk, d, torch.cuda.get_device_properties(0)
                                   .multi_processor_count)
    label = (f"fp32 bwd edge B{b} Lq{lq} Lk{lk} H{h} d{d} {'bias' if with_bias else 'no bias'}"
             f"{' unaligned' if offset else ''} (dq rows {plan.dq.rows} threads "
             f"{plan.dq.threads} split {plan.dq.split}, dk/dv keys {plan.dkv.rows} threads "
             f"{plan.dkv.threads} split {plan.dkv.split})")
    out, lse = fa.flash_attention_blc_cuda(q, k, v, h, bias, return_lse=True)
    delta = fa.row_delta(out, do, h)
    args = (q, k, v, bias, do, lse, delta, h)
    plain = fa.flash_backward_plain(q, k, v, bias, out, do, lse, h)
    forced = min(3, -(-lk // 64)), min(3, -(-lq // 64))
    for splits in ((None, None), forced):
        if splits[0] is None:
            got = ((fa.flash_bwd_dq_cuda(*args),)
                   + fa.flash_bwd_dkv_cuda(*args, need_dbias=True))
        else:
            got = fp32_backward_split(torch, fa, args, splits)
        torch.cuda.synchronize()
        if splits[0] is None:
            check_bwd_repeats(torch, fa, args, got, label)
        for what, g, ref in zip(("dq", "dk", "dv", "dbias"), got, plain):
            if what == "dbias" and bias is None:
                continue
            if not torch.isfinite(g).all():
                fail(f"{label}: {what} is not finite")
            err, rel, ok = _gate_fp32(g, ref, what)
            say(f"[fp32-edge] {label}{'' if splits[0] is None else f' split {splits}'}: "
                f"{what} max abs err {err:.3e} rel L2 {rel:.3e}"
                f"{'' if ok else '  FAILS THE GATE'}")
            if not ok:
                fail(f"{label}: fp32 {what} disagrees with its plain version")
    for name, what, wrong, ref in fp32_bwd_faults(fa, planted, args, plain[0], plain[1]):
        err, rel, ok = _gate_fp32(wrong, ref, what)
        say(f"[fp32-edge]   planted fault, {name} ({what}): max abs err {err:.3e} rel L2 "
            f"{rel:.3e}")
        if ok:
            fail(f"{label}: the fp32 gate passes a planted fault ({name}, {what})")


def _fp32_want(shapes):
    return {FP32_KINDS[kind]: want for kind, want in flash_want(shapes).items()}


def _remat_want(shapes):
    """A micro-step's flash launches with `use_remat`: the recompute runs
    the forward of every non-capturing SpatialTransformer's self-attention a
    second time (layers 1, 2 at L4096 and 4, 5 at L1024; the L256 ones, 7
    and 8, capture); the backward launches are unchanged."""
    want = flash_want(shapes)
    want["fwd"] = {s: n + (2 if s[1] in (4096, 1024) else 0) for s, n in want["fwd"].items()}
    return want


def _cli_run(torch, fa, trainer_cls, tmp, name, argv, wants, card, counters=None):
    """`adaface_tpu_torch.train.main(argv)` in-process on a seeded dataset at
    full SD width on the card, the launch counters cleared just before it.
    Each micro-step (`Trainer._run_recon` / `_run_compos`, batch preparation
    included) is timed and its flash launches by kind and shape (and those
    of `counters`, name -> a `launches_by_shape` keyed by shape) must equal
    wants[is compos]. Returns a record: times, kinds, per-step launches,
    the trainer, peak GiB, logdir."""
    counters = counters or {}
    import gc

    import numpy as np

    from adaface_tpu_torch import train

    logdir = os.path.join(tmp, f"cli_{name}")
    ds_dir = os.path.join(tmp, f"cli_{name}_subject")
    os.makedirs(ds_dir)
    rec = dict(times=[], kinds=[], launches=[], trainer=None, logdir=logdir)
    real = {k: getattr(trainer_cls, k) for k in ("_run_recon", "_run_compos")}

    def timed(kind, run):
        def wrapper(self, plan):
            rec["trainer"] = self
            before = dict(fa.launches_by_shape)
            before_extra = {k: dict(c) for k, c in counters.items()}
            torch.cuda.synchronize()
            t0 = time.time()
            metrics = run(self, plan)
            torch.cuda.synchronize()
            rec["times"].append(time.time() - t0)
            rec["kinds"].append(kind)
            got = launches_between(before, fa.launches_by_shape)
            for k, c in counters.items():
                delta = {shape: n - before_extra[k].get(shape, 0) for shape, n in c.items()
                         if n - before_extra[k].get(shape, 0)}
                if delta:
                    got[k] = delta
            rec["launches"].append(got)
            return metrics
        return wrapper

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in [fa.launches_by_shape, *counters.values()]:
        c.clear()
    trainer_cls._run_recon = timed("recon", real["_run_recon"])
    trainer_cls._run_compos = timed("compos", real["_run_compos"])
    try:
        rc = train.main(argv + ["--logdir", logdir], dataset=make_dataset(ds_dir),
                        device="cuda")
    finally:
        for k, f in real.items():
            setattr(trainer_cls, k, f)
    rec["peak"] = torch.cuda.max_memory_allocated() / 2 ** 30
    if rc != 0:
        fail(f"[cli {name}] main returned {rc}")
    for i, (kind, got) in enumerate(zip(rec["kinds"], rec["launches"])):
        want = wants[kind == "compos"]
        say(f"[cli] {name} micro-step {i} ({kind}): {rec['times'][i]:.3f} s, launches "
            f"{ {k: sorted(v.items()) for k, v in sorted(got.items())} } [{card}]")
        if got != want:
            fail(f"[cli {name}] micro-step {i} ({kind}): expected the launches {want}, "
                 f"got {got}")
    recs = [json.loads(line) for line in open(os.path.join(logdir, "metrics.jsonl"))]
    rec["metrics"] = [r for r in recs if "loss" in r]
    if len(rec["metrics"]) != len(rec["times"]) or not all(
            np.isfinite(v) for r in rec["metrics"] for v in r.values()
            if isinstance(v, float)):
        fail(f"[cli {name}] {len(rec['metrics'])} step records for {len(rec['times'])} "
             "micro-steps, or a non-finite metric")
    recon = [t for t, k in zip(rec["times"], rec["kinds"]) if k == "recon"]
    compos = [t for t, k in zip(rec["times"], rec["kinds"]) if k == "compos"]
    rec["recon_med"] = statistics.median(recon[1:] or recon)
    rec["compos_med"] = statistics.median(compos[1:] or compos)
    say(f"[cli] {name}: {len(rec['times'])} micro-steps {rec['kinds']}; median recon "
        f"{rec['recon_med']:.3f} s (first {recon[0]:.3f}), median compos "
        f"{rec['compos_med']:.3f} s (first {compos[0]:.3f}); peak memory {rec['peak']:.2f} GiB "
        f"[{card}]")
    return rec


def phase_entry_point(torch, fa, trainer_cls, tmp, card):
    """(9d) `adaface_tpu_torch.train.main` in-process at full SD width with
    random weights on the seeded dataset, on the shipped per-subject configs:
    `finetune-static-layerwise.yaml` in fp32 (exact fp32-kernel launches; the
    checkpoint reloads), `finetune-ti.yaml --bf16` (AdamW, K=1, no
    background token; 6 micro-steps keeping the state of step 3), a run
    resumed from that state to step 6 (metrics within TRAIN_LOSS_TOL of the
    uninterrupted run's), and `finetune-ada.yaml` (bf16 from the file,
    compel 0.5) with `model_options.use_remat=true` (exact launches, the
    recompute's forwards included) and without it (peak memory beside it),
    and with it under FUSED_KNOBS (K9 launched again by the recompute, K8
    not). (9e) The fp32 run again under FUSED_KNOBS: exact fp32 flash, K8
    and K9 launches and no bf16 K8 or K9 one, each micro-step's loss within
    TRAIN_LOSS_TOL of the fp32 run's. Returns the fp32 run's flash launches
    by (kind, B, L, H, d) and 9e's K8 and K9 launches by (dtype, shape)."""
    import shutil

    import numpy as np

    from adaface_tpu_torch.personalization.embedding_manager import EmbeddingManager
    from adaface_tpu_torch.personalization.static_embedding import embedder_leaves

    t_phase = time.time()
    base = lambda cfg: ["--base", os.path.join(CONFIG_DIR, f"{cfg}.yaml"),
                        "--data_root", "seeded", "--seed", "0"]
    runs = {}
    # fp32: the config has no model.params.dtype, so no --bf16 means fp32
    runs["static fp32"] = _cli_run(
        torch, fa, trainer_cls, tmp, "static_fp32",
        base("finetune-static-layerwise") + ["--max_steps", str(CLI_STEPS)],
        {False: _fp32_want(TRAIN_SHAPES), True: _fp32_want(COMPOS_SHAPES)}, card)
    tr = runs["static fp32"]["trainer"]
    if tr.pipe.unet.in_conv.weight.dtype != torch.float32:
        fail("[cli static fp32] the pipeline is not fp32")
    reloaded = EmbeddingManager.load_native(os.path.join(runs["static fp32"]["logdir"],
                                                         "embeddings_last.npz"))
    for s, p in tr.mgr.embedders.items():
        for n, t in embedder_leaves(p):
            if not np.array_equal(getattr(reloaded.embedders[s], n).numpy(),
                                  t.detach().cpu().numpy()):
                fail(f"[cli static fp32] checkpoint reload: {s}.{n} differs")
    say("[cli] static fp32: the checkpoint reloads equal to the live embedders")
    del tr
    runs["static fp32"]["trainer"] = None

    # 9e: the same fp32 run under the fused knobs: the fp32 instances of K8
    # and K9 beside the same fp32 flash launches, no bf16 K8 or K9 launch;
    # each micro-step's loss within TRAIN_LOSS_TOL of 9d's on the same draws
    fn, ff = _fused_ops()
    fp32_fused_wants = {compos: dict(_fp32_want(shapes), gn=_typed(gn, "fp32"),
                                     ff=_typed(ff_shapes, "fp32"))
                        for compos, shapes, gn, ff_shapes in (
                            (False, TRAIN_SHAPES, GN_TRAIN_SHAPES, FF_TRAIN_SHAPES),
                            (True, COMPOS_SHAPES, GN_COMPOS_SHAPES, FF_COMPOS_SHAPES))}
    with knobs_set(FUSED_KNOBS):
        runs["static fp32 fused"] = _cli_run(
            torch, fa, trainer_cls, tmp, "static_fp32_fused",
            base("finetune-static-layerwise") + ["--max_steps", str(CLI_STEPS)],
            fp32_fused_wants, card, counters={"gn": fn.launches_by_shape,
                                              "ff": ff.launches_by_shape})
    fused, plain = runs["static fp32 fused"], runs["static fp32"]
    if fused["trainer"].pipe.unet.in_conv.weight.dtype != torch.float32:
        fail("[cli static fp32 fused] the pipeline is not fp32")
    fused["trainer"] = None
    worst = max(abs(a["loss"] - b["loss"]) / max(abs(b["loss"]), 1e-12)
                for a, b in zip(fused["metrics"], plain["metrics"]))
    say(f"[cli] 9e, fp32 under {FUSED_KNOBS}: losses of micro-steps "
        f"{[round(r['loss'], 6) for r in fused['metrics']]} within {worst:.3e} relative of 9d's "
        f"fp32 run without the knobs (tol {TRAIN_LOSS_TOL}); median recon "
        f"{fused['recon_med']:.3f} s / {plain['recon_med']:.3f} s without, compos "
        f"{fused['compos_med']:.3f} s / {plain['compos_med']:.3f} s, peak memory "
        f"{fused['peak']:.2f} GiB / {plain['peak']:.2f} GiB [{card}]")
    if len(fused["metrics"]) != len(plain["metrics"]) or not worst <= TRAIN_LOSS_TOL:
        fail(f"[cli static fp32 fused] losses off by {worst:.3e} (tol {TRAIN_LOSS_TOL})")

    # ti, bf16: AdamW; the state of step 3 kept for the resume run
    real_save = trainer_cls.save_state

    def keep_each_state(self, path=None):
        path = real_save(self, path)
        shutil.copy(path, os.path.join(self.cfg.logdir, f"state_{self.global_step}.pt"))
        return path

    bf16_wants = {False: flash_want(TRAIN_SHAPES), True: flash_want(COMPOS_SHAPES)}
    trainer_cls.save_state = keep_each_state
    try:
        runs["ti bf16"] = _cli_run(
            torch, fa, trainer_cls, tmp, "ti_bf16",
            base("finetune-ti") + ["--bf16", "--max_steps", str(CLI_RESUME_STEPS),
                                   "--ckpt_every_steps", str(CLI_RESUME_AT)], bf16_wants, card)
    finally:
        trainer_cls.save_state = real_save
    tr = runs["ti bf16"]["trainer"]
    inner = tr.optimizer.inner
    if (type(inner).__name__ != "AdamW" or abs(inner.lr - 4e-3 * 2 * 3) > 1e-12
            or sorted(tr.mgr.placeholders) != ["z"] or tr.mgr.placeholders["z"].num_vectors != 1):
        fail(f"[cli ti bf16] not AdamW at 2.4e-2 with one 1-vector placeholder: "
             f"{type(inner).__name__} {getattr(inner, 'lr', None)} {tr.mgr.placeholders}")
    del tr, inner
    runs["ti bf16"]["trainer"] = None
    state = os.path.join(runs["ti bf16"]["logdir"], f"state_{CLI_RESUME_AT}.pt")
    runs["ti resumed"] = _cli_run(
        torch, fa, trainer_cls, tmp, "ti_resumed",
        base("finetune-ti") + ["--bf16", "--max_steps", str(CLI_RESUME_STEPS),
                               "--ckpt_every_steps", str(CLI_RESUME_AT), "--resume", state],
        bf16_wants, card)
    whole = runs["ti bf16"]["metrics"][CLI_RESUME_AT:]
    resumed = runs["ti resumed"]["metrics"]
    if [r["step"] for r in resumed] != [r["step"] for r in whole]:
        fail(f"[cli resume] resumed steps {[r['step'] for r in resumed]}, uninterrupted "
             f"{[r['step'] for r in whole]}")
    worst, exact = 0.0, True
    for a, b in zip(resumed, whole):
        for k, v in b.items():
            if isinstance(v, float):
                exact &= a[k] == v
                worst = max(worst, abs(a[k] - v) / max(abs(v), 1e-12))
    say(f"[cli] resume at step {CLI_RESUME_AT} to {CLI_RESUME_STEPS}: metrics of steps "
        f"{[r['step'] for r in resumed]} within {worst:.3e} relative of the uninterrupted "
        f"run's (tol {TRAIN_LOSS_TOL}; {'bit for bit' if exact else 'not bit for bit'}; "
        f"cuDNN benchmark {torch.backends.cudnn.benchmark}, deterministic "
        f"{torch.backends.cudnn.deterministic}, TF32 off) [{card}]")
    if not worst <= TRAIN_LOSS_TOL:
        fail(f"[cli resume] metrics off by {worst:.3e} (tol {TRAIN_LOSS_TOL})")
    for name in ("ti bf16", "ti resumed"):
        runs[name].pop("trainer", None)

    # ada: bf16 from the file, compel 0.5; with and without remat
    for name, remat in (("ada remat", True), ("ada", False)):
        wants = ({False: _remat_want(TRAIN_SHAPES), True: _remat_want(COMPOS_SHAPES)}
                 if remat else bf16_wants)
        runs[name] = _cli_run(
            torch, fa, trainer_cls, tmp, name.replace(" ", "_"),
            base("finetune-ada") + ["--max_steps", str(CLI_STEPS),
                                    f"model_options.use_remat={str(remat).lower()}"],
            wants, card)
        tr = runs[name]["trainer"]
        if (tr.pipe.unet.in_conv.weight.dtype != torch.bfloat16
                or tr.pipe.unet.cfg.use_remat != remat or tr.cfg.apply_compel_cfg_prob != 0.5):
            fail(f"[cli {name}] not bf16 / use_remat={remat} / compel 0.5")
        runs[name]["trainer"] = None
        del tr
    # the fused knobs with remat: the recompute runs K9 again in each
    # non-capturing block (FF_*_SHAPES twice); K8 sits in the ResBlocks,
    # which are not rematerialized, and runs as often as without remat
    fn, ff = _fused_ops()
    fused_wants = {compos: dict(_remat_want(shapes), gn=_typed(gn),
                                ff=_typed({k: 2 * n for k, n in ff_shapes.items()}))
                   for compos, shapes, gn, ff_shapes in (
                       (False, TRAIN_SHAPES, GN_TRAIN_SHAPES, FF_TRAIN_SHAPES),
                       (True, COMPOS_SHAPES, GN_COMPOS_SHAPES, FF_COMPOS_SHAPES))}
    with knobs_set(FUSED_KNOBS):
        runs["ada remat fused"] = _cli_run(
            torch, fa, trainer_cls, tmp, "ada_remat_fused",
            base("finetune-ada") + ["--max_steps", str(CLI_STEPS),
                                    "model_options.use_remat=true"],
            fused_wants, card, counters={"gn": fn.launches_by_shape,
                                         "ff": ff.launches_by_shape})
    runs["ada remat fused"]["trainer"] = None
    say(f"[cli] ada peak memory with remat {runs['ada remat']['peak']:.2f} GiB, without "
        f"{runs['ada']['peak']:.2f} GiB; median recon {runs['ada remat']['recon_med']:.3f} / "
        f"{runs['ada']['recon_med']:.3f} s, compos {runs['ada remat']['compos_med']:.3f} / "
        f"{runs['ada']['compos_med']:.3f} s [{card}]")
    say(f"[cli] phase 9d {time.time() - t_phase:.1f} s")
    totals = {}
    for got in runs["static fp32"]["launches"]:
        for kind, by_shape in got.items():
            for (b, l, h, d), n in by_shape.items():
                key = (kind, b, l, h, d)
                totals[key] = totals.get(key, 0) + n
    fused_totals = {"gn": {}, "ff": {}}
    for got in runs["static fp32 fused"]["launches"]:
        for kind in fused_totals:
            for key, n in got[kind].items():
                fused_totals[kind][key] = fused_totals[kind].get(key, 0) + n
    return totals, fused_totals


# ----------------------------------------------------------------- slice 14
# fp32 instances of K8, K9 and K10 (4h), fp32 training through the entry
# point under the fused knobs (9e), and fp32 requests under the default and
# the fused knobs ([fp32-main]).
FF_FP32_SOURCE = "adaface_tpu_torch/csrc/ln_geglu_ff_fp32.cu"
WINO_FP32_SOURCE = "adaface_tpu_torch/csrc/winograd_fp32.cu"
# 4g's and 4h's planted faults: text patches of each fp32 kernel's source,
# built by kernel_variants.build and launched through the wrapper in place of
# the kernel at every shape of the path; each must fail the gate
# (FP32_REL_TOL, FP32_ABS_TOL of the largest plain value). key -> (source, C
# entry, fault, patches)
FP32_FAULTS = {
    "flash_fwd": ("flash_attn_fp32.cu", "flash_attn_fp32_fwd",
                  "the rescale by alpha skipped",
                  [("        for (int e = 0; e < NO; ++e) o[c][i][e] *= alpha;",
                    "        for (int e = 0; e < NO; ++e) (void)alpha;")]),
    "flash_dq": ("flash_attn_fp32.cu", "flash_attn_fp32_bwd_dq",
                 "the last key tile left out of dq's ds K product",
                 [("      pv_chunk<TR, BK, CW / 32, CW % 32 / 8, LDC>(g[c], pr, kt, cg);",
                   "      if (t + 1 < ntiles) pv_chunk<TR, BK, CW / 32, CW % 32 / 8, LDC>"
                   "(g[c], pr, kt, cg);")]),
    "flash_dkv": ("flash_attn_fp32.cu", "flash_attn_fp32_bwd_dkv", "delta left out of ds",
                  [("        const float ds = *pp * (acc[i][j] - dj[j]);",
                    "        const float ds = *pp * acc[i][j];")]),
    "gn": ("gn_silu.cu", "gn_silu_fwd_fp32",
           "the last cluster peer's partial left out of the combine",
           [("    for (int r = 0; r < cs; ++r) {", "    for (int r = 0; r + 1 < cs; ++r) {")]),
    "ff": ("ln_geglu_ff_fp32.cu", "ln_geglu_ff_fp32_fwd",
           "F chunk 1 (h columns 64-127) skipped in GEMM2",
           [("        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(fa[i], fb[j], acc[i][j]);",
             "        for (int j = 0; j < NJ; ++j)\n"
             "          if (EPI == EPI_GEGLU || kt * BK / 64 != 1)\n"
             "            acc[i][j] = fmaf(fa[i], fb[j], acc[i][j]);")]),
    "wino": ("winograd_fp32.cu", "winograd_conv3x3_fp32_fwd",
             "position 5 left out of the general path's quadrants",
             [("      if (coef == 0) continue;\n#pragma unroll\n      for (int i = 0; i < MI; ++i)",
               "      if (coef == 0 || ij == 5) continue;\n#pragma unroll\n"
               "      for (int i = 0; i < MI; ++i)")]),
    "wino_narrow": ("winograd_fp32.cu", "winograd_conv3x3_fp32_fwd",
                    "position 5 left out of the narrow paths' products",
                    [("    if (coef == 0) continue;  // position ij adds nothing to quadrant q",
                      "    if (coef == 0 || ij == 5) continue;  // position ij adds nothing to "
                      "quadrant q"),
                     ("      const float4 tv = input_position(d, i, j);",
                      "      const float4 tv = ij == 5 ? float4{} : input_position(d, i, j);")]),
}
# [fp32-main]: DDIM steps of each fp32 request (the generate path's STEPS
# cut so that the script keeps its time; the only cut)
FP32_REQUEST_STEPS = 10


_fp32_fault_libs = {}


def build_fp32_faults():
    """The planted faults' libraries, built side by side into
    `_variants/fault_fp32_<key>/` at the first call (4g): key -> library."""
    import kernel_variants as kv
    if not _fp32_fault_libs:
        try:
            built = kv.build({k: (kv.CSRC, src, patches)
                              for k, (src, _, _, patches) in FP32_FAULTS.items()},
                             prefix="fault_fp32_")
        except (ValueError, RuntimeError) as e:
            fail(f"a planted fp32 fault did not build: {e}")
        _fp32_fault_libs.update({k: lib for k, (lib, _) in built.items()})
    return _fp32_fault_libs


@contextlib.contextmanager
def entry_replaced(module, name, lib):
    """The wrapper module's C entry `name` taken from `lib` (a planted
    fault's build) for the block, so that the fault runs through the
    wrapper with its plan, scratch and checks."""
    import ctypes

    from adaface_tpu_torch import kernels

    fn = getattr(lib, name)
    fn.argtypes = module.C_ENTRIES[name][1]
    fn.restype = ctypes.c_int
    old = kernels.entries.get(name)
    kernels.entries[name] = fn
    try:
        yield
    finally:
        if old is None:
            kernels.entries.pop(name, None)
        else:
            kernels.entries[name] = old


def fused_fp32_errors(out, plain, x=None):
    """(max abs error over the largest plain value, relative L2 error) of an
    fp32 kernel output against its plain version; for K9 (x given) both of
    the feed-forward part out - x."""
    if x is not None:
        out, plain = out - x, plain - x
    diff = out - plain
    return (diff.abs().max().item() / max(plain.abs().max().item(), 1e-30),
            (diff.norm() / plain.norm()).item())


def _gate_fused_fp32(torch, label, out, again, plain, wrong=None, x=None):
    """Fail unless `out` is finite fp32, equals `again` bit for bit and is
    within FP32_ABS_TOL (of the largest plain value) and FP32_REL_TOL of
    `plain`, and the planted fault's output `wrong` is not. Returns (max
    abs error, relative L2)."""
    if out.dtype != torch.float32 or not torch.isfinite(out).all():
        fail(f"{label}: output {out.dtype}, or non-finite")
    if not torch.equal(out, again):
        fail(f"{label}: two launches disagree")
    err, rel = fused_fp32_errors(out, plain, x)
    if wrong is not None:
        ferr, frel = fused_fp32_errors(wrong, plain, x)
        say(f"[fp32-fused]   planted fault: max abs err {ferr:.3e} of the largest value, rel L2 "
            f"{frel:.3e}")
        if ferr <= FP32_ABS_TOL and frel <= FP32_REL_TOL:
            fail(f"{label}: the fp32 gate passes its planted fault")
    if not (err <= FP32_ABS_TOL and rel <= FP32_REL_TOL):
        fail(f"{label}: kernel disagrees with plain (max abs {err:.3e} of the largest value, "
             f"rel L2 {rel:.3e})")
    return err, rel


# K9 fp32 shapes (on-path (B, L, C), edge (B, L, C, F)) that 4h also runs
# through the C entry under every GEMM2 width that divides C and every split
FF_FP32_FORCED = {(16, 64, 1280), (3, 1024, 640), (1, 129, 640, 2560), (2, 33, 64, 192)}


def ff_fp32_forced_plans(torch, ff, label, args, plain):
    """K9 fp32 through its C entry under every GEMM2 width that divides C,
    every split of F (1..FP32_MAX_SPLIT): each within the fp32 gate of
    `plain`, and each split's repeat bit for bit."""
    x, ln_g, ln_b, w1, b1, w2, b2 = args
    b, l, c = x.shape
    m, f = b * l, w2.shape[0]
    w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
    y, h, out = torch.empty_like(x), x.new_empty((m, f)), torch.empty_like(x)
    ws = x.new_empty((ff.FP32_MAX_SPLIT, m, c))
    fn = ff._fn("ln_geglu_ff_fp32_fwd")
    stream = torch.cuda.current_stream().cuda_stream
    worst = (0.0, 0.0)
    plans = [ff.FP32Plan(bn, s) for bn in ff.FP32_BN2 if c % bn == 0
             for s in range(1, min(ff.FP32_MAX_SPLIT, f // ff.FP32_BK) + 1)]
    for plan in plans:
        got = []
        for _ in range(2):
            out.fill_(float("nan"))
            rc = fn(x.data_ptr(), ln_g.data_ptr(), ln_b.data_ptr(), w1t.data_ptr(), b1.data_ptr(),
                    w2t.data_ptr(), b2.data_ptr(), y.data_ptr(), h.data_ptr(), ws.data_ptr(),
                    out.data_ptr(), m, c, f, 1e-5, *plan, stream)
            torch.cuda.synchronize()
            if rc:
                fail(f"{label} under {plan}: CUDA error {rc}")
            got.append(out.clone())
        err, rel = _gate_fused_fp32(torch, f"{label} under {plan}", got[0], got[1], plain, x=x)
        worst = (max(worst[0], err), max(worst[1], rel))
    say(f"[fp32-fused] {label:30s}: {len(plans)} forced plans (widths, splits 1.."
        f"{ff.FP32_MAX_SPLIT}) through the C entry: worst max abs err {worst[0]:.3e}, "
        f"rel L2 {worst[1]:.3e}; repeats bit for bit")


# K10 fp32 shapes (B, H, W, Cin, Cout) that 4h also runs through its C
# entry under every path the shape takes and every split; edge shapes
# through the wrapper (ragged M, Cin and Cout off 16, B1; every path)
WINO_FP32_FORCED = {(16, 8, 8, 1280, 1280), (8, 64, 64, 4, 320), (16, 64, 64, 320, 4)}
WINO_FP32_EDGE_SHAPES = [(1, 18, 22, 20, 70), (1, 12, 10, 3, 17), (3, 10, 12, 8, 100),
                         (1, 34, 30, 36, 4), (2, 14, 18, 44, 8), (1, 8, 8, 1280, 1280)]


def wino_fp32_forced_plans(torch, tw, label, x, ut, bias, plain):
    """K10 fp32 through its C entry under every plan it takes at this shape
    (the general path under every split, and the narrow path of the shape):
    each within the fp32 gate of `plain`, each repeat bit for bit."""
    b, h, w, cin = x.shape
    cout = bias.shape[0]
    m = b * h * w // 4
    cin_p = ut.shape[2]
    plans = [tw.FP32Plan(tw.FP32_GENERAL, s)
             for s in range(1, min(tw.FP32_MAX_SPLIT, tw.fp32_steps(cin)) + 1)]
    narrow = tw.fp32_path(cin, cout)
    if narrow != tw.FP32_GENERAL:
        plans.append(tw.FP32Plan(narrow, 1))
    v = x.new_empty((16, m, cin_p))
    ws = x.new_empty((tw.FP32_MAX_SPLIT, 4, m, cout))
    out = x.new_empty((b, h, w, cout))
    fn = tw._fn("winograd_conv3x3_fp32_fwd")
    stream = torch.cuda.current_stream().cuda_stream
    worst = (0.0, 0.0)
    for plan in plans:
        got = []
        for _ in range(2):
            out.fill_(float("nan"))
            rc = fn(x.data_ptr(), ut.data_ptr(), bias.data_ptr(), v.data_ptr(), ws.data_ptr(),
                    out.data_ptr(), b, h, w, cin, cout, cin_p, *plan, stream)
            torch.cuda.synchronize()
            if rc:
                fail(f"{label} under {plan}: CUDA error {rc}")
            got.append(out.clone())
        err, rel = _gate_fused_fp32(torch, f"{label} under {plan}", got[0], got[1], plain)
        worst = (max(worst[0], err), max(worst[1], rel))
    say(f"[fp32-fused] {label:40s}: {len(plans)} forced plans (paths, splits) "
        f"through the C entry: worst max abs err {worst[0]:.3e}, rel L2 {worst[1]:.3e}; repeats "
        f"bit for bit")


def phase_fused_fp32_kernels(torch, card, exp2_rate, wino_shapes):
    """(4h) K8, K9 and K10 in fp32 (`csrc/gn_silu.cu`'s fp32 instance,
    `csrc/ln_geglu_ff_fp32.cu`, `csrc/winograd_fp32.cu`) through their
    wrappers on fp32 tensors, against their plain fp32 versions on the same
    inputs, at every shape of the fused paths (K8, K9: generate B16/B8,
    recon B3, compos B4) and of the UNet's Winograd convs (`wino_shapes`,
    shape -> count a UNet call): relative L2 and max abs (of the largest
    value) gates of FP32_REL_TOL / FP32_ABS_TOL, K9 on its feed-forward part;
    each kernel's planted fault (FP32_FAULTS) must fail them; two launches
    agree bit for bit; kernel, plain, library (TF32 off) and bound times.
    K8 and K9 also at their edge shapes (agreement and repeats). Then
    `conv3x3_same` in fp32 under ADAFACE_WINOGRAD=1 as often as a UNet call
    has each shape: the fp32 gate (itemsize 4) sends some shapes to the
    direct conv, as in JAX. Returns (rows, K10 fp32 launches by (dtype,
    shape))."""
    import torch.nn.functional as F

    fn, ff = _fused_ops()
    tw = _winograd()
    faults = build_fp32_faults()
    gen = torch.Generator(device="cuda").manual_seed(21)
    randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = {}
    t_phase = time.time()
    for b, n, c in sorted(set(GN_SHAPES) | set(GN_TRAIN_SHAPES) | set(GN_COMPOS_SHAPES),
                          key=lambda k: (-k[0], -k[1], k[2])):
        x, scale, bias = gn_inputs(torch, randn, b, n, c, torch.float32)
        label = f"gn_silu fp32 B{b} N{n} C{c}"
        fn.launches_by_shape.clear()
        call = lambda: fn.group_norm_silu_cuda(x, scale, bias)
        out, again = call(), call()
        torch.cuda.synchronize()
        if fn.launches_by_shape != {("fp32", b, n, c): 2}:
            fail(f"{label}: the wrapper counted {fn.launches_by_shape} for two calls")
        with entry_replaced(fn, FP32_FAULTS["gn"][1], faults["gn"]):
            wrong = call()
        plain = fn.group_norm_silu_plain(x, scale, bias)
        err, rel = _gate_fused_fp32(torch, label, out, again, plain, wrong)
        ms, dev_ms = time_ms(torch, call), device_ms(torch, call)
        plain_ms = time_ms(torch, lambda: fn.group_norm_silu_plain(x, scale, bias), reps=2,
                           rounds=3)
        xt = x.transpose(1, 2).contiguous()  # [B, C, N] for F.group_norm
        library_ms = time_ms(torch, lambda: F.silu(F.group_norm(xt, 32, scale, bias, 1e-5)))
        bound_ms, bound_by = gn_bound(b, n, c, exp2_rate, itemsize=4)
        say(f"[fp32-fused] {label:30s}: max abs err {err:.3e} of the largest value, rel L2 "
            f"{rel:.3e} (tols {FP32_ABS_TOL}, {FP32_REL_TOL}); kernel {ms:.4f} ms device "
            f"{dev_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}) plain {plain_ms:.4f} ms "
            f"F.group_norm+F.silu {library_ms:.4f} ms; {fn.launch_plan(b, n, c, sms, 4)} "
            f"[{card}]")
        rows[("gn", b, n, c)] = dict(max_abs_err=err * plain.abs().max().item(), ms=ms,
                                     plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                     library_ms=library_ms, device_ms=dev_ms)
        del x, xt, out, again, wrong, plain
    for b, n, c in GN_EDGE_SHAPES:
        x, scale, bias = gn_inputs(torch, randn, b, n, c, torch.float32)
        label = f"gn_silu fp32 B{b} N{n} C{c}"
        out = fn.group_norm_silu_cuda(x, scale, bias)
        again = fn.group_norm_silu_cuda(x, scale, bias)
        err, rel = _gate_fused_fp32(torch, label, out, again,
                                    fn.group_norm_silu_plain(x, scale, bias))
        say(f"[fp32-fused] {label:30s}: max abs err {err:.3e} rel L2 {rel:.3e}; "
            f"{fn.launch_plan(b, n, c, sms, 4)}")
        del x, out, again
    ff_cases = [(b, l, c, 4 * c, True) for b, l, c in
                list(FF_SHAPES) + list(FF_TRAIN_SHAPES) + list(FF_COMPOS_SHAPES)]
    ff_cases += [(b, l, c, f, False) for b, l, c, f in FF_EDGE_SHAPES]
    for b, l, c, f, on_path in ff_cases:
        x = randn(b, l, c)
        w1 = randn(2 * f, c) / c ** 0.5  # nn.Linear layouts, as in the UNet
        w2 = randn(c, f) / f ** 0.5
        args = (x, 1 + 0.2 * randn(c), 0.2 * randn(c), w1.t(), 0.2 * randn(2 * f), w2.t(),
                0.2 * randn(c))
        label = f"ln_geglu_ff fp32 B{b} L{l} C{c}" + ("" if on_path else f" F{f}")
        ff.launches_by_shape.clear()
        call = lambda: ff.ln_geglu_ff_cuda(*args)
        out, again = call(), call()
        torch.cuda.synchronize()
        if ff.launches_by_shape != {("fp32", b, l, c): 2}:
            fail(f"{label}: the wrapper counted {ff.launches_by_shape} for two calls")
        plain = ff.ln_geglu_ff_plain(*args)
        if not on_path:
            err, rel = _gate_fused_fp32(torch, label, out, again, plain, x=x)
            say(f"[fp32-fused] {label:30s}: max abs err {err:.3e} rel L2 {rel:.3e}; "
                f"{ff.fp32_launch_plan(b * l, c, f, sms)}")
            if (b, l, c, f) in FF_FP32_FORCED:
                ff_fp32_forced_plans(torch, ff, label, args, plain)
            continue
        with entry_replaced(ff, FP32_FAULTS["ff"][1], faults["ff"]):
            wrong = call()
        err, rel = _gate_fused_fp32(torch, label, out, again, plain, wrong, x=x)
        ms, dev_ms = time_ms(torch, call), device_ms(torch, call)
        plain_ms = time_ms(torch, lambda: ff.ln_geglu_ff_plain(*args), reps=2, rounds=3)
        default_ms = time_ms(torch, lambda: ff.ln_geglu_ff_unfused(*args))
        # the yardstick of K9's GEMMs: cuBLAS's two fp32 products alone
        y = F.layer_norm(x, (c,), args[1], args[2])
        h = randn(b, l, f)
        library_ms = time_ms(torch, lambda: (F.linear(y, w1), F.linear(h, w2)))
        sgemm_ms = [time_ms(torch, lambda: F.linear(y, w1)),
                    time_ms(torch, lambda: F.linear(h, w2))]
        bound_ms, bound_by = ff_bound(b, l, c, itemsize=4, peak=PEAK_FP32_FLOPS)
        say(f"[fp32-fused] {label:30s}: max abs err {err:.3e} of the largest value, rel L2 "
            f"{rel:.3e} of out - x (tols {FP32_ABS_TOL}, {FP32_REL_TOL}); kernel {ms:.4f} ms "
            f"device {dev_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}) plain "
            f"{plain_ms:.4f} ms unfused fp32 chain "
            f"{default_ms:.4f} ms cuBLAS SGEMMs {library_ms:.4f} ms (GEMM1 {sgemm_ms[0]:.4f}, "
            f"GEMM2 {sgemm_ms[1]:.4f}); {ff.fp32_launch_plan(b * l, c, f, sms)} [{card}]")
        if (b, l, c) in FF_FP32_FORCED:
            ff_fp32_forced_plans(torch, ff, label, args, plain)
        rows[("ff", b, l, c)] = dict(max_abs_err=err * (plain - x).abs().max().item(), ms=ms,
                                     plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                     library_ms=library_ms, default_arm_ms=default_ms,
                                     device_ms=dev_ms)
        del x, args, w1, w2, out, again, wrong, plain, y, h
    cases = {}
    for key in sorted(wino_shapes):
        b, h, w, cin, cout = key
        x = randn(b, h, w, cin)
        kern = randn(3, 3, cin, cout) / (9 * cin) ** 0.5
        bias = 0.2 * randn(cout)
        cases[key] = (x, kern, bias)
        label = f"winograd fp32 B{b} {h}x{w} Cin{cin} Cout{cout}"
        u = tw.transform_weights(kern)
        ut = tw.padded_weights_fp32(u)  # the kernel's layout, made outside the timed call
        call = lambda: tw.winograd_conv3x3_cuda(x, ut, bias)
        tw.launches_by_shape.clear()
        out, again = call(), call()
        torch.cuda.synchronize()
        if tw.launches_by_shape != {("fp32",) + key: 2}:
            fail(f"{label}: the wrapper counted {tw.launches_by_shape} for two calls")
        plan = tw.fp32_launch_plan(b * h * w // 4, cin, cout, sms)
        fault = "wino" if plan.path == tw.FP32_GENERAL else "wino_narrow"
        with entry_replaced(tw, FP32_FAULTS[fault][1], faults[fault]):
            wrong = call()
        plain = tw.winograd_conv3x3_plain(x, u, bias)
        err, rel = _gate_fused_fp32(torch, label, out, again, plain, wrong)
        ms, dev_ms = time_ms(torch, call), device_ms(torch, call)
        plain_ms = time_ms(torch, lambda: tw.winograd_conv3x3_plain(x, u, bias), reps=2,
                           rounds=3)
        xc = x.permute(0, 3, 1, 2)  # NHWC memory is channels_last NCHW
        wc = kern.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        library_ms = time_ms(torch, lambda: F.conv2d(xc, wc, bias, padding=1))
        bound_ms, bound_by = wino_bound(b, h, w, cin, cout, itemsize=4, peak=PEAK_FP32_FLOPS)
        # the public op, its weight layout kept (the default) and made anew
        # every call; the direct conv where the fp32 gate sends the shape
        with knobs_set({"ADAFACE_WINOGRAD": "1"}):
            op = "" if tw.winograd_eligible(x.shape, cout, 4) else " (direct conv)"
            op_ms = time_ms(torch, lambda: tw.conv3x3_same(x, kern, bias))

            def anew():
                tw._layouts.clear()
                return tw.conv3x3_same(x, kern, bias)
            anew_ms = time_ms(torch, anew, reps=3, rounds=5)
        say(f"[fp32-fused] {label:40s}: max abs err {err:.3e} of the largest value, rel L2 "
            f"{rel:.3e} (fault: {FP32_FAULTS[fault][2]}); kernel {ms:.4f} ms device "
            f"{dev_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}) plain {plain_ms:.4f} ms "
            f"F.conv2d fp32 {library_ms:.4f} ms; conv3x3_same{op} {op_ms:.4f} ms, layout made "
            f"every call {anew_ms:.4f} ms; {plan} [{card}]")
        if key in WINO_FP32_FORCED:
            wino_fp32_forced_plans(torch, tw, label, x, ut, bias, plain)
        rows[("wino",) + key] = dict(max_abs_err=err * plain.abs().max().item(), ms=ms,
                                     plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                     library_ms=library_ms, device_ms=dev_ms,
                                     conv3x3_same_ms=op_ms)
        del out, again, wrong, plain, ut, u
    for b, h, w, cin, cout in WINO_FP32_EDGE_SHAPES:
        x = randn(b, h, w, cin)
        kern = randn(3, 3, cin, cout) / (9 * cin) ** 0.5
        bias = 0.2 * randn(cout)
        label = f"winograd fp32 B{b} {h}x{w} Cin{cin} Cout{cout}"
        u = tw.transform_weights(kern)
        ut = tw.padded_weights_fp32(u)
        out = tw.winograd_conv3x3_cuda(x, ut, bias)
        again = tw.winograd_conv3x3_cuda(x, ut, bias)
        err, rel = _gate_fused_fp32(torch, label, out, again, tw.winograd_conv3x3_plain(x, u, bias))
        say(f"[fp32-fused] {label:40s}: max abs err {err:.3e} rel L2 {rel:.3e}; "
            f"{tw.fp32_launch_plan(b * h * w // 4, cin, cout, sms)}")
        del x, out, again, ut, u
    # conv3x3_same in fp32: the gates at itemsize 4 decide, as in JAX
    tw.launches_by_shape.clear()
    with knobs_set({"ADAFACE_WINOGRAD": "1"}):
        want = _typed({s: n for s, n in wino_shapes.items()
                       if tw.winograd_eligible(s[:4], s[4], 4)}, "fp32")
        for key, n in wino_shapes.items():
            for _ in range(n):
                tw.conv3x3_same(*cases[key])
    torch.cuda.synchronize()
    launches = dict(tw.launches_by_shape)
    say(f"[fp32-fused] conv3x3_same fp32 under ADAFACE_WINOGRAD=1: {sum(launches.values())} "
        f"kernel launches {sorted(launches.items())}; the direct conv at "
        f"{sorted(set(wino_shapes) - {k[1:] for k in want})} (VMEM budget at 4 bytes)")
    if launches != want:
        fail(f"fp32 winograd launches {launches}, expected {want}")
    del cases
    for m in (fn, ff, tw):
        m.launches_by_shape.clear()
    torch.cuda.empty_cache()
    say(f"[fp32-fused] phase 4h {time.time() - t_phase:.1f} s")
    return rows, launches


def phase_fp32_main_path(torch, card):
    """([fp32-main]) An fp32 pipeline at SD-v1.5 width (random weights,
    seed 0, one 9-vector placeholder z) serves `generate` once under the
    default knobs and once under FUSED_KNOBS after a warm-up: PROMPT x
    BATCH, 512x512, CFG 10->4, DDIM cut to FP32_REQUEST_STEPS (printed).
    Each request makes exactly the fp32 flash forwards of the bf16 request's
    UNet calls (MAIN_SHAPES per call); the fused one also GN_SHAPES and
    FF_SHAPES fp32 launches per call, and no bf16 K8 or K9 launch. The two
    requests' images (same seed) must agree within ARM_UINT8_MEAN_TOL.
    Returns the default request's fp32 flash launches by (B, L, H, d) and
    the fused request's K8 and K9 launches by (dtype, shape)."""
    import gc

    import numpy as np

    from adaface_tpu_torch.data.tokenizer import HashTokenizer
    from adaface_tpu_torch.pipeline import StableDiffusionPipeline

    fa = _fa()
    fn, ff = _fused_ops()
    tok = HashTokenizer()
    pipe = StableDiffusionPipeline.from_random(0, tok, dtype=torch.float32, device="cuda")
    tid = tok.add_placeholder("z")
    pipe.embedding_manager.add_placeholder(
        "z", token_id=tid, num_vectors=9, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(7))
    prompts = [PROMPT] * BATCH
    kw = dict(num_steps=FP32_REQUEST_STEPS, guidance_scale=(10.0, 4.0), height=SIZE, width=SIZE)
    calls = FP32_REQUEST_STEPS  # UNet calls a request
    want_fa = {s: n * calls // STEPS for s, (_, n) in MAIN_SHAPES.items()}
    say(f"[fp32-main] fp32 pipeline, batch {BATCH} 512x512 CFG 10->4: DDIM cut from {STEPS} "
        f"to {FP32_REQUEST_STEPS} steps (the only cut)")
    t0 = time.time()
    pipe.generate(prompts, seed=0, **kw)
    say(f"[fp32-main] warm-up request {time.time() - t0:.3f} s [{card}]")
    imgs, secs = {}, {}
    for name, values in (("default", {}), ("fused", FUSED_KNOBS)):
        with knobs_set(values):
            for m in (fa, fn, ff):
                m.launches_by_shape.clear()
            torch.cuda.synchronize()
            t0 = time.time()
            imgs[name] = pipe.generate(prompts, seed=1, **kw)
            secs[name] = time.time() - t0
        got_fa = {}
        for (kind, arm, b, lq, lk, h, d), n in fa.launches_by_shape.items():
            if kind != "fwd_fp32":
                fail(f"[fp32-main] {name}: a {kind} flash launch in an fp32 request")
            got_fa[(b, lq, h, d)] = got_fa.get((b, lq, h, d), 0) + n
        got_gn, got_ff = dict(fn.launches_by_shape), dict(ff.launches_by_shape)
        fused = name == "fused"
        want_gn = _typed({s: calls * n for s, n in GN_SHAPES.items()}, "fp32") if fused else {}
        want_ff = _typed({s: calls * n for s, n in FF_SHAPES.items()}, "fp32") if fused else {}
        say(f"[fp32-main] {name} knobs request: {secs[name]:.3f} s, {BATCH / secs[name]:.4f} "
            f"img/s, launches: flash fp32 {sum(got_fa.values())}, gn_silu fp32 "
            f"{sum(got_gn.values())}, ln_geglu_ff fp32 {sum(got_ff.values())} [{card}]")
        if (got_fa, got_gn, got_ff) != (want_fa, want_gn, want_ff):
            fail(f"[fp32-main] {name}: expected the launches {want_fa} {want_gn} {want_ff}, "
                 f"got {got_fa} {got_gn} {got_ff}")
        a = imgs[name]
        if a.shape != (BATCH, SIZE, SIZE, 3) or str(a.dtype) != "uint8" or a.std() < 1.0:
            fail(f"[fp32-main] {name}: images {a.shape} {a.dtype}, std {a.std():.3f}")
        if fused:
            gn_launches, ff_launches = got_gn, got_ff
        else:
            fa_launches = got_fa
    diff = np.abs(imgs["fused"].astype(np.int32) - imgs["default"].astype(np.int32))
    say(f"[fp32-main] fused vs default images (same seed): mean {diff.mean():.4f} uint8 levels "
        f"(tol {ARM_UINT8_MEAN_TOL}), max {diff.max()}; fp32 request {secs['default']:.3f} s "
        f"default, {secs['fused']:.3f} s fused, DDIM-{FP32_REQUEST_STEPS} [{card}]")
    if not diff.mean() <= ARM_UINT8_MEAN_TOL:
        fail(f"[fp32-main] the fused request's images differ by {diff.mean():.3f} levels")
    # [fp32-profile]: where each request's device time goes
    for name, values in (("default", {}), ("fused", FUSED_KNOBS)):
        with knobs_set(values):
            profile_breakdown(torch, lambda: pipe.generate(prompts, seed=1, **kw), "fp32-profile",
                              f"one fp32 DDIM-{FP32_REQUEST_STEPS} request under the {name} knobs",
                              card)
    for m in (fa, fn, ff):
        m.launches_by_shape.clear()
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return fa_launches, gn_launches, ff_launches


# ------------------------------------------------------------------ slice 4
# The knob arms of the flash dispatch and the Winograd conv. Every arm of the
# packed entry (K1, K2, K4, K5) and of the [B, H, L, D] entry (K6, K7) runs
# csrc/flash_attn_packed.cu; the launch counters key each launch by the TPU
# kernel it stands for.
WINO_SOURCE = "adaface_tpu_torch/csrc/winograd.cu"
K2 = "adaface_tpu/ops/flash_attention.py:639"  # _flash_kernel_heads_pvt2
K5 = "adaface_tpu/ops/flash_attention.py:467"  # _flash_kernel_heads
K6 = "adaface_tpu/ops/flash_attention.py:59"  # _flash_kernel
K7 = "adaface_tpu/ops/flash_attention.py:129"  # _flash_row_kernel
K10 = "adaface_tpu/ops/winograd.py:81"  # _wino_kernel
ARM_REPLACES = {"K1": K1, "K2": K2, "K4": K4, "K5": K5, "K6": K6, "K7": K7,
                "K1+exp_bf16": K1, "K1+mxu_sum": K1, "K1+exp_bf16+mxu_sum": K1}
CROSS_LK = 77
# (B, Lq, H, d) of the cross-attentions at Lq >= 256 of a generate UNet call
# (5 at each shape, 250 per request); of the non-capturing ones of a recon
# micro-step (layers 1, 2 and 4, 5); of the [B*H, L, d] fold and the flags
CROSS_SHAPES = [(16, 4096, 8, 40), (16, 1024, 8, 80), (16, 256, 8, 160)]
CROSS_TRAIN_SHAPES = [(3, 4096, 8, 40), (3, 1024, 8, 80)]
FOLD_SHAPES = [(16, 4096, 8, 40), (8, 4096, 8, 40), (16, 1024, 8, 80), (16, 256, 8, 160)]
FLAG_SHAPES = [(16, 4096, 8, 40), (8, 4096, 8, 40), (16, 1024, 8, 80)]
FLAG_NAMES = {1: "EXP_BF16", 2: "MXU_SUM", 3: "EXP_BF16+MXU_SUM"}
# generate under each arm configuration: (name, knobs, fuse_qkv, images
# bit-identical to the default request's on the same seed)
ARM_CONFIGS = [
    ("K2", {"ADAFACE_FLASH_PVT2": "1", "ADAFACE_FLASH_SHORT": "0"}, False, True),
    ("K5", {"ADAFACE_FLASH_MAXFREE": "0", "ADAFACE_FLASH_CROSS": "1"}, False, False),
    ("K4 cross", {"ADAFACE_FLASH_CROSS": "1"}, False, False),
    ("K6", {"ADAFACE_FLASH_PACKED": "0"}, False, True),
    ("K7", {"ADAFACE_FLASH_PACKED": "0", "ADAFACE_FLASH_MODE": "row"}, False, True),
    ("K1 flags", {"ADAFACE_FLASH_EXP_BF16": "1", "ADAFACE_FLASH_MXU_SUM": "1"}, False, False),
    ("fuse_qkv", {}, True, False),
    # the pipeline's A/B arms: the UNet at batch 2B without the CFG stem
    # dedup, and the cross-attention K/V projected every step
    ("no dedup", {"ADAFACE_CFG_DEDUP": "0"}, False, False),
    ("no kv hoist", {"ADAFACE_CROSS_KV": "0"}, False, False),
]
TRAIN_ARM_CONFIGS = [("K6", {"ADAFACE_FLASH_PACKED": "0"}),
                     ("K4 cross", {"ADAFACE_FLASH_CROSS": "1"})]
ARM_TRAIN_STEPS = 2
# Max abs gate of the cross-attention rows: with 77 keys the output is about
# 4x larger than at L4096 (std ~0.11), and so are the bf16 roundings of p and
# o (measured 7.4e-3 at d40 on an H100); the relative L2 gate is unchanged.
CROSS_ABS_TOL = 2e-2
CROSS_BWD_ABS_TOL = 2.0 ** -6  # two bf16 ulps at the top of the range
# Images of an arm that changes the arithmetic against the default request on
# the same seed: mean absolute uint8 difference over all pixels. bf16
# roundings in other places (the kernel rounds unnormalised p, the einsum
# path normalised p) grow through 50 guided DDIM steps; measured on an H100:
# 2.27 levels (max 68) for the cross-attention through the kernel.
ARM_UINT8_MEAN_TOL = 4.0
# K10 gate, kernel (bf16) vs its plain version on the same bf16 inputs: the
# plain version repeats the kernel's roundings, so only fp32 sums in another
# order and the final bf16 rounding differ (measured on an H100: relative L2
# 1.7e-7 to 8.6e-5, max abs up to 5.95e-3 of the largest value). Relative L2
# 5e-4, which the rounding faults (t_ij rounded once, or kept in fp32: a bf16
# ulp of t in about a third of the elements) must fail; max abs against the
# output's largest value 2^-7, one bf16 ulp at the top of the range.
WINO_REL_TOL = 5e-4
WINO_ABS_TOL = 2.0 ** -7


def _winograd():
    from adaface_tpu_torch.ops import winograd
    return winograd


def expected_generate_launches(name):
    """(arm, B, Lq, Lk, H, d) -> forward launches of one generate request
    under arm configuration `name` (or "default")."""
    want = {}

    def add(key, n):
        want[key] = want.get(key, 0) + n

    for (b, l, h, d), (replaces, n) in MAIN_SHAPES.items():
        arm = "K1" if replaces == K1 else "K4"
        if name == "no dedup":
            b = 2 * BATCH  # the stem's layer runs at batch 2B too
        if name in ("K2", "K5"):
            add((name, b, l, l, h, d), n)
        elif name in ("K6", "K7"):
            add((name, b * h, l, l, 1, d), n)
        elif name == "K1 flags" and arm == "K1":
            add(("K1+exp_bf16+mxu_sum", b, l, l, h, d), n)
        else:
            add((arm, b, l, l, h, d), n)
    if name in ("K5", "K4 cross"):
        for b, lq, h, d in CROSS_SHAPES:
            add(("K5" if name == "K5" else "K4", b, lq, 128, h, d), STEPS * 5)
    return want


def expected_train_launches(name):
    """kind -> (arm, B, Lq, Lk, H, d) -> launches of one recon micro-step
    under training arm configuration `name`."""
    want = {"fwd": {}, "dq": {}, "dkv": {}}
    for (b, l, h, d), (replaces, n_fwd, n_bwd) in TRAIN_SHAPES.items():
        arm, key = ("K1" if replaces == K1 else "K4"), (b, l, l, h, d)
        if name == "K6":
            arm, key = "K6", (b * h, l, l, 1, d)
        want["fwd"][(arm,) + key] = n_fwd
        want["dq"][("K3b",) + key] = n_bwd
        want["dkv"][("K3c",) + key] = n_bwd
    if name == "K4 cross":
        for b, lq, h, d in CROSS_TRAIN_SHAPES:
            key = (b, lq, 128, h, d)
            want["fwd"][("K4",) + key] = 2
            want["dq"][("K3b",) + key] = 2
            want["dkv"][("K3c",) + key] = 2
    return want


def _by_kind(fa, before=None):
    """The counter since `before` (a copy of it), as kind -> key -> n."""
    got = {}
    for (kind, *key), n in fa.launches_by_shape.items():
        n -= (before or {}).get((kind, *key), 0)
        if n:
            got.setdefault(kind, {})[tuple(key)] = n
    return got


def _fwd_row(torch, fa, label, out, plain, d, timed, plain_call, library, bound_ms_by,
             card, abs_tol=None, **extra):
    """Gate a forward output against its plain version, time the kernel,
    the plain version and the library call; returns the kernels-line row."""
    if not torch.isfinite(out).all():
        fail(f"{label}: non-finite kernel output")
    err, rel = kernel_errors(out, plain)
    abs_tol = abs_tol or KERNEL_ABS_TOL[d]
    ms = time_ms(torch, timed)
    plain_ms = time_ms(torch, plain_call, reps=2, rounds=3)
    library_ms = time_ms(torch, library) if library is not None else None
    extra_ms = {k: time_ms(torch, f) for k, f in extra.items()}
    say(f"[arm-kernel] {label:48s}: max abs err {err:.3e} (tol {abs_tol}) rel L2 "
        f"{rel:.3e} (tol {KERNEL_REL_TOL}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
        f"library {library_ms if library_ms is None else f'{library_ms:.4f}'} ms "
        + "".join(f"{k} {v:.4f} ms " for k, v in extra_ms.items())
        + f"bound {bound_ms_by[0]:.4f} ms ({bound_ms_by[1]}) [{card}]")
    if not gate_passes(out, plain, d, abs_tol):
        fail(f"{label}: kernel disagrees with plain (max abs {err:.3e}, rel L2 {rel:.3e})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms_by[0],
                bound_by=bound_ms_by[1], library_ms=library_ms, **extra_ms)


def _expect_one_launch(fa, key, label):
    if fa.launches_by_shape != {key: 1}:
        fail(f"{label}: expected the one launch {key}, counted {fa.launches_by_shape}")


def phase_arm_kernels(torch, fa, card, exp2_rate):
    """(4c) The forward kernel at the arms' new shapes against its plain
    version, through the public entries with the knobs set: cross-attention
    Lk 77 padded to 128 (K4, and K5 under MAXFREE=0), K2 and K5 at the
    generate self-attention shapes, the [B*H, L, d] fold (K6, K7), K1's
    EXP_BF16 and MXU_SUM arithmetic; then the backward
    kernels at the fold's and the cross-attention's training shapes.
    Returns the rows by (arm, B, Lq, Lk, H, d) and, for the backward, by
    (kind, arm, B, Lq, Lk, H, d)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(13)
    rand = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    heads4 = lambda t, h: t.unflatten(-1, (h, -1)).transpose(1, 2)
    rows = {}
    lkp = fa.cross_pad_len(CROSS_LK)
    for b, lq, h, d in CROSS_SHAPES:
        q, k, v = rand(b, lq, h * d), rand(b, CROSS_LK, h * d), rand(b, CROSS_LK, h * d)
        kp, vp = (F.pad(t, (0, 0, 0, lkp - CROSS_LK)) for t in (k, v))
        biasp = F.pad(torch.zeros((b, CROSS_LK), device="cuda"), (0, lkp - CROSS_LK),
                      value=-1e30)
        plain = fa.flash_attention_blc_plain(q, kp, vp, h, biasp)
        mask = biasp.to(torch.bfloat16)[:, None, None, :]
        for arm, knobs in (("K4", {"ADAFACE_FLASH_CROSS": "1"}),
                           ("K5", {"ADAFACE_FLASH_CROSS": "1", "ADAFACE_FLASH_MAXFREE": "0"})):
            label = f"{arm} cross B{b} Lq{lq} Lk{CROSS_LK}->{lkp} H{h} d{d}"
            with knobs_set(knobs):
                fa.launches_by_shape.clear()
                out = fa.flash_attention_blc(q, k, v, h)
                torch.cuda.synchronize()
                _expect_one_launch(fa, ("fwd", arm, b, lq, lkp, h, d), label)
                rows[(arm, b, lq, lkp, h, d)] = _fwd_row(
                    torch, fa, label, out, plain, d,
                    lambda: fa.flash_attention_blc_cuda(q, kp, vp, h, biasp, arm=arm),
                    lambda: fa.flash_attention_blc_plain(q, kp, vp, h, biasp),
                    lambda: F.scaled_dot_product_attention(
                        heads4(q, h), heads4(kp, h), heads4(vp, h), attn_mask=mask,
                        scale=d ** -0.5),
                    bound(b, lq, lkp, h, d, exp2_rate, True), card, abs_tol=CROSS_ABS_TOL,
                    default_arm_ms=lambda: fa.reference_attention(q, k, v, h))
            check_gate_rejects_faults(fa, q, kp, vp, h, d, biasp, plain, label,
                                      abs_tol=CROSS_ABS_TOL)
        if lq == 1024:  # a fully masked batch row: the average of all 128 padded keys
            kb = torch.zeros((b, CROSS_LK), device="cuda")
            kb[0] = -1e30
            with knobs_set({"ADAFACE_FLASH_CROSS": "1"}):
                out = fa.flash_attention_blc(q, k, v, h, key_bias=kb)
            padded_mean = v[0].float().sum(0) / lkp
            err_p = (out[0].float() - padded_mean).abs().max().item()
            err_77 = (out[0].float() - v[0].float().mean(0)).abs().max().item()
            say(f"[arm-kernel] cross, batch row 0 fully masked: max abs err against the "
                f"average over the {lkp} padded keys {err_p:.3e} (tol {MASKED_ROW_TOL}), "
                f"against the average over the {CROSS_LK} real keys {err_77:.3e}")
            if not err_p <= MASKED_ROW_TOL or not err_77 > 10 * MASKED_ROW_TOL:
                fail("the CROSS pad: a fully masked row must average all padded keys")
        del q, k, v, kp, vp, plain
    fa.launches_by_shape.clear()

    # K2 and K5 at the self-attention shapes of a generate call: the same
    # kernel as K1/K4 in phase 3, launched and timed here under each arm's knobs
    for b, l, h, d in MAIN_SHAPES:
        q, k, v = rand(b, l, h * d), rand(b, l, h * d), rand(b, l, h * d)
        plain = fa.flash_attention_blc_plain(q, k, v, h)
        for arm, knobs in (("K2", {"ADAFACE_FLASH_PVT2": "1", "ADAFACE_FLASH_SHORT": "0"}),
                           ("K5", {"ADAFACE_FLASH_MAXFREE": "0"})):
            label = f"{arm} self B{b} L{l} H{h} d{d}"
            with knobs_set(knobs):
                fa.launches_by_shape.clear()
                out = fa.flash_attention_blc(q, k, v, h)
                torch.cuda.synchronize()
                _expect_one_launch(fa, ("fwd", arm, b, l, l, h, d), label)
                rows[(arm, b, l, l, h, d)] = _fwd_row(
                    torch, fa, label, out, plain, d,
                    lambda: fa.flash_attention_blc_cuda(q, k, v, h, arm=arm),
                    lambda: fa.flash_attention_blc_plain(q, k, v, h),
                    lambda: F.scaled_dot_product_attention(
                        heads4(q, h), heads4(k, h), heads4(v, h), scale=d ** -0.5),
                    bound(b, l, l, h, d, exp2_rate, False), card)
            check_gate_rejects_faults(fa, q, k, v, h, d, None, plain, label)
        del q, k, v, plain
    fa.launches_by_shape.clear()

    for b, l, h, d in FOLD_SHAPES:
        q, k, v = (rand(b, h, l, d) for _ in range(3))
        fold = lambda t: t.reshape(b * h, l, d)
        plain = fa.flash_attention_blc_plain(fold(q), fold(k), fold(v), 1)
        for arm, knobs in (("K6", {}), ("K7", {"ADAFACE_FLASH_MODE": "row"})):
            label = f"{arm} fold B{b}xH{h} L{l} d{d}"
            with knobs_set(knobs):
                fa.launches_by_shape.clear()
                out = fa.flash_attention(q, k, v)
                torch.cuda.synchronize()
                _expect_one_launch(fa, ("fwd", arm, b * h, l, l, 1, d), label)
                rows[(arm, b * h, l, l, 1, d)] = _fwd_row(
                    torch, fa, label, fold(out), plain, d,
                    lambda: fa.flash_attention_blc_cuda(fold(q), fold(k), fold(v), 1, arm=arm),
                    lambda: fa.flash_attention_blc_plain(fold(q), fold(k), fold(v), 1),
                    lambda: F.scaled_dot_product_attention(q, k, v, scale=d ** -0.5),
                    bound(b, l, l, h, d, exp2_rate, False), card)
            check_gate_rejects_faults(fa, fold(q), fold(k), fold(v), 1, d, None, plain, label)
        del q, k, v, plain
    fa.launches_by_shape.clear()

    for b, l, h, d in FLAG_SHAPES:
        q, k, v = rand(b, l, h * d), rand(b, l, h * d), rand(b, l, h * d)
        default_out = fa.flash_attention_blc_cuda(q, k, v, h)
        for flags, name in FLAG_NAMES.items():
            arm = fa.arm_id("K1", flags)
            knobs = {f"ADAFACE_FLASH_{n}": "1" for n in name.split("+")}
            label = f"{arm} B{b} L{l} H{h} d{d}"
            plain = fa.flash_attention_blc_plain(q, k, v, h, flags=flags)
            with knobs_set(knobs):
                fa.launches_by_shape.clear()
                out = fa.flash_attention_blc(q, k, v, h)
                torch.cuda.synchronize()
                _expect_one_launch(fa, ("fwd", arm, b, l, l, h, d), label)
                rows[(arm, b, l, l, h, d)] = _fwd_row(
                    torch, fa, label, out, plain, d,
                    lambda: fa.flash_attention_blc_cuda(q, k, v, h, arm=arm, flags=flags),
                    lambda: fa.flash_attention_blc_plain(q, k, v, h, flags=flags),
                    lambda: F.scaled_dot_product_attention(
                        heads4(q, h), heads4(k, h), heads4(v, h), scale=d ** -0.5),
                    bound(b, l, l, h, d, exp2_rate, False), card,
                    default_arm_ms=lambda: fa.flash_attention_blc_cuda(q, k, v, h))
            check_gate_rejects_faults(fa, q, k, v, h, d, None, plain, label, flags=flags)
            differ = (out != default_out).sum().item()
            say(f"[arm-kernel]   {arm}: {differ} of {out.numel()} outputs differ from the "
                f"default arm's")
            if differ == 0:
                fail(f"{label}: the flags did not reach the kernel")
            if flags & fa.FLAG_EXP_BF16:
                # large scores, where bf16(s) moves p by up to 9%: the default
                # function is a planted fault the comparison must see
                q8 = (q.float() * 8).bfloat16()
                out8 = fa.flash_attention_blc_cuda(q8, k, v, h, arm=arm, flags=flags)
                plain8 = fa.flash_attention_blc_plain(q8, k, v, h, flags=flags)
                rel_k = kernel_errors(out8, plain8)[1]
                rel_f = kernel_errors(fa.flash_attention_blc_plain(q8, k, v, h).bfloat16(),
                                      plain8)[1]
                say(f"[arm-kernel]   {arm} at 8x scores: kernel rel L2 {rel_k:.3e}, planted "
                    f"fault (the flag ignored) rel L2 {rel_f:.3e}")
                if not (rel_k < 0.25 * rel_f and rel_f > KERNEL_REL_TOL):
                    fail(f"{label}: at 8x scores the kernel is not closer to its flag's "
                         f"function than the default function is")
        del q, k, v, default_out
    fa.launches_by_shape.clear()

    bwd_rows = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen_mask = torch.Generator(device="cuda").manual_seed(17)
    cases = []
    for b, l, h, d in TRAIN_SHAPES:
        bias = torch.where(torch.rand((b, l), generator=gen_mask, device="cuda") > 0.3, 0.0,
                           -1e30)
        bias[0] = -1e30
        cases.append(("K6", b * h, l, l, 1, d, bias.repeat_interleave(h, dim=0),
                      f"K6 fold B{b}xH{h} L{l} d{d}"))
    for b, lq, h, d in CROSS_TRAIN_SHAPES:
        biasp = F.pad(torch.zeros((b, CROSS_LK), device="cuda"), (0, lkp - CROSS_LK),
                      value=-1e30)
        cases.append(("K4", b, lq, lkp, h, d, biasp,
                      f"K4 cross B{b} Lq{lq} Lk{CROSS_LK}->{lkp} H{h} d{d}"))
    for arm, b, lq, lk, h, d, bias, label in cases:
        q, do = rand(b, lq, h * d), rand(b, lq, h * d)
        k, v = rand(b, lk, h * d), rand(b, lk, h * d)
        if arm == "K4":  # the pad rows are zeros, as the entry makes them
            k[:, CROSS_LK:] = 0
            v[:, CROSS_LK:] = 0
        fa.launches_by_shape.clear()
        out, lse = fa.flash_attention_blc_cuda(q, k, v, h, bias, return_lse=True, arm=arm)
        delta = fa.row_delta(out, do, h)
        dq = fa.flash_bwd_dq_cuda(q, k, v, bias, do, lse, delta, h)
        dk, dv, dbias = fa.flash_bwd_dkv_cuda(q, k, v, bias, do, lse, delta, h,
                                              need_dbias=True)
        torch.cuda.synchronize()
        counted = {key[:2]: n for key, n in fa.launches_by_shape.items()}
        if counted != {("fwd", arm): 1, ("dq", "K3b"): 1, ("dkv", "K3c"): 1}:
            fail(f"{label}: the wrappers counted {fa.launches_by_shape}")
        check_bwd_repeats(torch, fa, (q, k, v, bias, do, lse, delta, h), (dq, dk, dv, dbias),
                          label)
        plan = fa.bwd_launch_plan(b, h, lq, lk, d, sms)
        plain_lse = fa.row_lse_plain(q, k, h, bias)
        pdq, pdk, pdv, pdb = fa.flash_backward_plain(q, k, v, bias, out, do, lse, h)
        errs = {}
        for what, got, ref in (("lse", lse, plain_lse), ("dq", dq, pdq), ("dk", dk, pdk),
                               ("dv", dv, pdv), ("dbias", dbias.sum(1), pdb.sum(1))):
            if not torch.isfinite(got).all():
                fail(f"{label}: non-finite {what}")
            err, rel, ok = _gate_bwd(got, ref, d, what, scaled=arm == "K4")
            errs[what] = err
            say(f"[arm-backward] {label:40s} {what:5s}: max abs err {err:.3e} rel L2 "
                f"{rel:.3e}{'' if ok else '  FAILS THE GATE'}")
            if not ok:
                fail(f"{label}: {what} disagrees with the plain backward")
        no_delta = fa.flash_backward_plain(q, k, v, bias, torch.zeros_like(out), do, lse, h)
        faults = [("delta omitted", "dq", no_delta[0], pdq),
                  ("delta omitted", "dk", no_delta[1], pdk)]
        if plan.split > 1:  # the split's middle query slice left out of the sums
            parts = fa.dkv_slices_plain(q, k, v, bias, out, do, lse, h, split=plan.split)
            gone = plan.split // 2
            for i, what, ref in ((0, "dk", pdk), (1, "dv", pdv)):
                wrong = sum(p[i] for j, p in enumerate(parts) if j != gone)
                faults.append((f"query slice {gone} of {plan.split} left out", what, wrong, ref))
            del parts
        for name, what, wrong, ref in faults:
            err, rel, ok = _gate_bwd(wrong.bfloat16(), ref, d, what, scaled=arm == "K4")
            say(f"[arm-backward]   planted fault, {name} ({what}): max abs err "
                f"{err:.3e} rel L2 {rel:.3e}")
            if ok:
                fail(f"{label}: the gate passes a planted fault ({name}, {what})")
        del faults
        fwd_ms = time_ms(torch, lambda: fa.flash_attention_blc_cuda(q, k, v, h, bias,
                                                                    return_lse=True, arm=arm))
        fwd_plain_ms = time_ms(torch, lambda: (fa.flash_attention_blc_plain(q, k, v, h, bias),
                                               fa.row_lse_plain(q, k, h, bias)), reps=2, rounds=3)
        plain_out = fa.flash_attention_blc_plain(q, k, v, h, bias)
        if not gate_passes(out, plain_out, d, CROSS_ABS_TOL if arm == "K4" else None):
            fail(f"{label}: the forward disagrees with plain")
        dq_ms = time_ms(torch, lambda: fa.flash_bwd_dq_cuda(q, k, v, bias, do, lse, delta, h))
        dkv_ms = time_ms(torch, lambda: fa.flash_bwd_dkv_cuda(q, k, v, bias, do, lse, delta,
                                                              h))
        dq_dev = device_ms(torch, lambda: fa.flash_bwd_dq_cuda(q, k, v, bias, do, lse, delta, h))
        dkv_dev = device_ms(torch, lambda: fa.flash_bwd_dkv_cuda(q, k, v, bias, do, lse, delta,
                                                                 h))
        bwd_plain_ms = time_ms(torch, lambda: fa.flash_backward_plain(
            q, k, v, bias, out, do, lse, h), reps=2, rounds=3)
        qh, kh, vh = (heads4(t, h).detach().requires_grad_(True) for t in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=bias.to(torch.bfloat16)[:, None, None, :], scale=d ** -0.5)
        fwd_lib_ms = time_ms(torch, lambda: sdpa().detach())
        o_lib = sdpa()
        bwd_lib_ms = time_ms(torch, lambda: torch.autograd.grad(
            o_lib, (qh, kh, vh), heads4(do, h), retain_graph=True))
        bwd_lib_dev = device_ms(torch, lambda: torch.autograd.grad(
            o_lib, (qh, kh, vh), heads4(do, h), retain_graph=True))
        dq_b = bwd_bound(b, lq, lk, h, d, exp2_rate, "dq", True)
        dkv_b = bwd_bound(b, lq, lk, h, d, exp2_rate, "dkv", True)
        key = (b, lq, lk, h, d)
        fwd_b = bound(b, lq, lk, h, d, exp2_rate, True)
        bwd_rows[("fwd", arm) + key] = dict(
            max_abs_err=kernel_errors(out, plain_out)[0], ms=fwd_ms, plain_ms=fwd_plain_ms,
            bound_ms=fwd_b[0], bound_by=fwd_b[1], library_ms=fwd_lib_ms)
        bwd_rows[("dq", "K3b") + key] = dict(
            max_abs_err=errs["dq"], ms=dq_ms, plain_ms=bwd_plain_ms, bound_ms=dq_b[0],
            bound_by=dq_b[1], library_ms=bwd_lib_ms, device_ms=dq_dev)
        bwd_rows[("dkv", "K3c") + key] = dict(
            max_abs_err=max(errs["dk"], errs["dv"]), ms=dkv_ms, plain_ms=bwd_plain_ms,
            bound_ms=dkv_b[0], bound_by=dkv_b[1], library_ms=bwd_lib_ms, device_ms=dkv_dev,
            split=plan.split)
        say(f"[arm-backward] {label}: fwd+lse {fwd_ms:.4f} ms (bound {fwd_b[0]:.4f} "
            f"{fwd_b[1]}, sdpa {fwd_lib_ms:.4f}), dq {dq_ms:.4f} ms (bound {dq_b[0]:.4f} "
            f"{dq_b[1]}; device {dq_dev:.4f}), dk/dv {dkv_ms:.4f} ms (device {dkv_dev:.4f}) on "
            f"{plan.key_ctas} x {plan.split} CTAs (split {plan.split}; bound {dkv_b[0]:.4f} "
            f"{dkv_b[1]}), sdpa backward "
            f"{bwd_lib_ms:.4f} ms (device {bwd_lib_dev:.4f}), plain backward "
            f"{bwd_plain_ms:.3f} ms [{card}]")
        del q, k, v, do, out, lse, delta, dq, dk, dv, dbias, pdq, pdk, pdv, pdb, o_lib, plain_out
    fa.launches_by_shape.clear()
    torch.cuda.empty_cache()
    return rows, bwd_rows


def record_conv_shapes(torch, pipe):
    """(B, H, W, Cin, Cout) -> count of the 3x3 stride-1 convs of one
    generate UNet call (B16 at 64x64, the CFG stem at B8), recorded by
    forward pre-hooks: the Conv2d modules and the nearest-2x upsample
    convs."""
    from adaface_tpu_torch.models.unet import Upsample, precompute_cross_kv

    shapes = {}

    def add(key):
        shapes[key] = shapes.get(key, 0) + 1

    hooks = []
    for m in pipe.unet.modules():
        if isinstance(m, torch.nn.Conv2d) and m.kernel_size == (3, 3) and m.stride == (1, 1):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, inp: add((inp[0].shape[0], inp[0].shape[2], inp[0].shape[3],
                                      inp[0].shape[1], mod.out_channels))))
        elif isinstance(m, Upsample):  # a 3x3 SAME conv of the upsampled [B, 2H, 2W, C]
            hooks.append(m.register_forward_pre_hook(
                lambda mod, inp: add((inp[0].shape[0], 2 * inp[0].shape[1],
                                      2 * inp[0].shape[2], inp[0].shape[3],
                                      mod.conv.out_channels))))
    prompts = [PROMPT] * BATCH
    gen = torch.Generator(device="cuda").manual_seed(2)
    try:
        with torch.inference_mode():
            ctx = pipe.encode_prompts(prompts)
            ctx = torch.cat([ctx, pipe.encode_negative("", BATCH).expand_as(ctx)], dim=1)
            x = torch.randn((BATCH, SIZE // 8, SIZE // 8, 4), generator=gen, device="cuda")
            t = torch.full((BATCH,), 501, dtype=torch.int32, device="cuda")
            pipe.unet(x, t, ctx, cfg_dedup=True, cross_kv=precompute_cross_kv(pipe.unet, ctx))
    finally:
        for hk in hooks:
            hk.remove()
    return shapes


def wino_bound(b, h, w, cin, cout, itemsize=2, peak=None):
    """Least time of K10: 8*B*H*W*Cin*Cout flops (the 16 Winograd
    products) at `peak` (the tensor cores' bf16 rate by default), or x, U
    and y moved once (`itemsize` bytes an element), whichever is larger."""
    t_mma = 8 * b * h * w * cin * cout / (peak or PEAK_BF16_FLOPS)
    t_bytes = itemsize * (b * h * w * (cin + cout) + 16 * cin * cout) / PEAK_HBM_BYTES
    return max(t_mma, t_bytes) * 1e3, "bytes" if t_bytes >= t_mma else "operations"


def phase_winograd(torch, pipe, card):
    """(4d) K10 at every 3x3 stride-1 conv shape of one generate UNet call
    that `winograd_eligible` admits under ADAFACE_WINOGRAD=1: driven through
    `conv3x3_same` as often as the UNet call has the shape (counts cleared
    before, read after); against its plain version (relative L2 and max abs
    gates, planted faults: a position left out, a sign of A^T flipped, the
    bias dropped, the input transform rounded once or kept in fp32 instead
    of rounded after every add, one slice's fp32 partial dropped from the
    sum of a split launch's plain version), at `launch_plan`'s split and at
    another (1 where the plan splits, else 2), two launches bit for bit;
    kernel, bound, plain and F.conv2d (cuDNN, channels_last bf16) times;
    one backward through the op.
    Returns (rows, launches) by shape."""
    import torch.nn.functional as F

    tw = _winograd()
    shapes = record_conv_shapes(torch, pipe)
    with knobs_set({"ADAFACE_WINOGRAD": "1"}):
        eligible = {s: n for s, n in shapes.items()
                    if tw.winograd_eligible((s[0], s[1], s[2], s[3]), s[4], 2)}
    say(f"[winograd] {len(shapes)} distinct 3x3 stride-1 conv shapes in one UNet call, "
        f"{len(eligible)} admitted under ADAFACE_WINOGRAD=1: "
        f"{ {s: n for s, n in sorted(eligible.items())} }; not admitted (VMEM budget): "
        f"{sorted(set(shapes) - set(eligible))}")
    if not eligible:
        fail("no conv shape of the UNet call passes the Winograd gates")
    gen = torch.Generator(device="cuda").manual_seed(19)
    randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    cases = {}
    for (b, h, w, cin, cout) in sorted(eligible):
        cases[(b, h, w, cin, cout)] = (randn(b, h, w, cin).bfloat16(),
                                       (randn(3, 3, cin, cout) / (9 * cin) ** 0.5).bfloat16(),
                                       (0.2 * randn(cout)).bfloat16())
    tw.launches_by_shape.clear()
    with knobs_set({"ADAFACE_WINOGRAD": "1"}):
        for key, n in eligible.items():
            for _ in range(n):
                tw.conv3x3_same(*cases[key])
    torch.cuda.synchronize()
    launches = dict(tw.launches_by_shape)
    say(f"[winograd] conv3x3_same under ADAFACE_WINOGRAD=1: {sum(launches.values())} kernel "
        f"launches {sorted(launches.items())}")
    if launches != _typed(eligible):
        fail(f"winograd launches {launches}, expected {_typed(eligible)}")
    rows = {}
    for key, (x, kern, bias) in cases.items():
        b, h, w, cin, cout = key
        label = f"winograd B{b} {h}x{w} Cin{cin} Cout{cout}"
        u = tw.transform_weights(kern)
        ut = tw.padded_weights(u)  # the kernel's layout, made outside the timed call
        out = tw.winograd_conv3x3_cuda(x, ut, bias)
        again = tw.winograd_conv3x3_cuda(x, ut, bias)
        plan = tw.launch_plan(b * h * w // 4, cin, cout,
                              torch.cuda.get_device_properties(0).multi_processor_count)
        other = 1 if plan.split > 1 else 2
        resplit = tw.winograd_conv3x3_cuda(x, ut, bias, split=other)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all() or not torch.equal(out, again):
            fail(f"{label}: non-finite output, or two launches disagree")
        plain = tw.winograd_conv3x3_plain(x, u, bias).float()
        scale = plain.abs().max().item()
        errs = lambda y: ((y.float() - plain).abs().max().item() / scale,
                          ((y.float() - plain).norm() / plain.norm()).item())
        err, rel = errs(out)
        oerr, orel = errs(resplit)
        u5 = u.clone()
        u5[5] = 0
        nsplit = max(plan.split, 2)
        parts = tw.split_partials(x, u, nsplit)
        faults = {"position 5 left out": tw.winograd_conv3x3_plain(x, u5, bias),
                  "bias dropped": tw.winograd_conv3x3_plain(x, u, torch.zeros_like(bias)),
                  f"slice 0 of {nsplit} dropped from the sum": tw.winograd_conv3x3_split_plain(
                      x, parts[1:], bias)}
        del parts
        at, transform = tw.AT, tw._input_transform
        fp32_t = lambda tile, i, j: transform(lambda p, q: tile(p, q).float(), i, j)
        for name, attr, patch in (
                ("A^T[1][3] sign flipped", "AT", ((1, 1, 1, 0), (0, 1, -1, 1))),
                ("t_ij rounded once", "_input_transform",
                 lambda tile, i, j: fp32_t(tile, i, j).to(x.dtype)),
                ("t_ij kept in fp32", "_input_transform", fp32_t)):
            setattr(tw, attr, patch)
            try:
                faults[name] = tw.winograd_conv3x3_plain(x, u, bias)
            finally:
                tw.AT, tw._input_transform = at, transform
        for name, wrong in faults.items():
            ferr, frel = errs(wrong)
            say(f"[winograd]   planted fault, {name}: max abs err {ferr:.3e} of the output's "
                f"largest value, rel L2 {frel:.3e}")
            if ferr <= WINO_ABS_TOL and frel <= WINO_REL_TOL:
                fail(f"{label}: the gate passes a planted fault ({name})")
        ms = time_ms(torch, lambda: tw.winograd_conv3x3_cuda(x, ut, bias))
        plain_ms = time_ms(torch, lambda: tw.winograd_conv3x3_plain(x, u, bias), reps=2, rounds=3)
        xc = x.permute(0, 3, 1, 2)  # NHWC memory is channels_last NCHW
        wc = kern.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        library_ms = time_ms(torch, lambda: F.conv2d(xc, wc, bias, padding=1))
        bound_ms, bound_by = wino_bound(b, h, w, cin, cout)
        say(f"[winograd] {label:40s}: max abs err {err:.3e} of the largest value (tol "
            f"{WINO_ABS_TOL:.3e}) rel L2 {rel:.3e} (tol {WINO_REL_TOL}) at split {plan.split}"
            f"{' (rows fastest)' if plan.m_fastest else ''}, {oerr:.3e} / {orel:.3e} at split "
            f"{other}; kernel {ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}) plain "
            f"{plain_ms:.4f} ms F.conv2d {library_ms:.4f} ms [{card}]")
        for e, r, n in ((err, rel, plan.split), (oerr, orel, other)):
            if not (e <= WINO_ABS_TOL and r <= WINO_REL_TOL):
                fail(f"{label}: kernel at split {n} disagrees with plain (max abs {e:.3e}, "
                     f"rel L2 {r:.3e})")
        rows[key] = dict(max_abs_err=err * scale, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=library_ms)
        del out, again, resplit, plain, faults, ut
    # one backward through the op: the direct conv's VJP and the fp32 bias sum
    key = max(cases, key=lambda k: k[0] * k[1] * k[2] * k[3] * k[4])
    x, kern, bias = (t.detach().clone().requires_grad_(True) for t in cases[key])
    g = randn(*x.shape[:3], key[4]).bfloat16()
    with knobs_set({"ADAFACE_WINOGRAD": "1"}):
        y = tw.conv3x3_same(x, kern, bias)
    grads = torch.autograd.grad(y, (x, kern, bias), g)
    xr, kr, br = (t.detach().clone().requires_grad_(True) for t in cases[key])
    ref = torch.autograd.grad(tw.direct_conv3x3(xr, kr, br), (xr, kr, br), g)
    for name, a, r in zip(("dx", "dkernel", "dbias"), grads, ref):
        e = ((a.float() - r.float()).norm() / r.float().norm()).item()
        say(f"[winograd] backward at {key}: {name} relative L2 against the direct conv's "
            f"autograd {e:.3e}")
        if not torch.isfinite(a).all() or not e <= 1e-2:
            fail(f"winograd backward: {name} off by {e:.3e}")
    tw.launches_by_shape.clear()
    torch.cuda.empty_cache()
    return rows, launches


@contextlib.contextmanager
def fuse_qkv_set(torch, unet, on):
    """Set `fuse_qkv` on every attention module of the UNet for the block."""
    from adaface_tpu_torch.models.unet import UNetCrossAttention

    mods = [m for m in unet.modules() if isinstance(m, UNetCrossAttention)]
    old = [m.fuse_qkv for m in mods]
    for m in mods:
        m.fuse_qkv = on
    try:
        yield
    finally:
        for m, o in zip(mods, old):
            m.fuse_qkv = o


def phase_arm_generate(torch, pipe, card, default_imgs, default_med):
    """(6c) generate under each arm configuration: one warm-up and one timed
    request (seed 1, the default run's first), each with exactly the
    expected launches by (arm, shape); images bit for bit the default
    request's for the arms that change no arithmetic, within
    ARM_UINT8_MEAN_TOL otherwise. Returns name -> launches by key."""
    import numpy as np

    fa = _fa()
    prompts = [PROMPT] * BATCH
    kw = dict(num_steps=STEPS, guidance_scale=(10.0, 4.0), height=SIZE, width=SIZE)
    counts = {}
    for name, knobs, fuse, exact in ARM_CONFIGS:
        with knobs_set(knobs), fuse_qkv_set(torch, pipe.unet, fuse):
            pipe.generate(prompts, seed=0, **kw)
            fa.launches_by_shape.clear()
            torch.cuda.synchronize()
            t0 = time.time()
            imgs = pipe.generate(prompts, seed=1, **kw)
            dt = time.time() - t0
        got = _by_kind(fa).get("fwd", {})
        want = expected_generate_launches(name)
        diff = np.abs(imgs.astype(np.int16) - default_imgs.astype(np.int16))
        arms = {}
        for key, n in got.items():
            arms[key[0]] = arms.get(key[0], 0) + n
        say(f"[arms] {name:9s} {knobs or 'fuse_qkv=True'}: {dt:.3f} s ({BATCH / dt:.4f} img/s; "
            f"default {default_med:.3f} s), launches by arm {arms}; images against the default "
            f"request: {int((diff > 0).sum())} of {diff.size} uint8 values differ, mean "
            f"{diff.mean():.4f}, max {int(diff.max())} [{card}]")
        if got != want:
            fail(f"arm {name}: expected the launches {want}, got {got}")
        if imgs.shape != (BATCH, SIZE, SIZE, 3) or imgs.std() < 1.0:
            fail(f"arm {name}: images {imgs.shape}, std {imgs.std():.3f}")
        if exact and diff.max() != 0:
            fail(f"arm {name} changes no arithmetic, but its images differ from the default's")
        if not diff.mean() <= ARM_UINT8_MEAN_TOL:
            fail(f"arm {name}: images {diff.mean():.4f} uint8 levels from the default's on "
                 f"average (tol {ARM_UINT8_MEAN_TOL})")
        counts[name] = got
    fa.launches_by_shape.clear()
    return counts


def phase_arm_train(torch, pipe, trainer_cls, tmp, card):
    """(9c) a fresh recon-only Trainer under each training arm configuration
    for ARM_TRAIN_STEPS micro-steps, each with exactly the expected forward,
    dq and dk/dv launches by (arm, shape); metrics finite, embedders moved by
    the first update. Returns name -> kind -> launches of the last
    micro-step."""
    import numpy as np

    from adaface_tpu_torch.personalization.static_embedding import embedder_leaves

    fa = _fa()
    mgr = pipe.embedding_manager
    leaves = lambda: {(s, n): t.detach().clone() for s, p in mgr.embedders.items()
                      for n, t in embedder_leaves(p)}
    out = {}
    for name, knobs in TRAIN_ARM_CONFIGS:
        tag = name.replace(" ", "_")
        tcfg, pcfg = train_configs(os.path.join(tmp, f"arm_{tag}"), gap=0)
        ds_dir = os.path.join(tmp, f"arm_{tag}_subject")
        os.makedirs(ds_dir)
        want = expected_train_launches(name)
        with knobs_set(knobs):
            trainer = trainer_cls(pipe, make_dataset(ds_dir), tcfg, pcfg)
            start = leaves()
            before_all = dict(fa.launches_by_shape)
            for i in range(ARM_TRAIN_STEPS):
                before = dict(fa.launches_by_shape)
                torch.cuda.synchronize()
                t0 = time.time()
                trainer.fit(i + 1)
                torch.cuda.synchronize()
                got = _by_kind(fa, before)
                say(f"[arm-train] {name} {knobs}: micro-step {i} {time.time() - t0:.3f} s, "
                    f"launches { {k: sum(v.values()) for k, v in sorted(got.items())} } "
                    f"[{card}]")
                if got != want:
                    fail(f"arm {name}, micro-step {i}: expected {want}, got {got}")
            moved = max(float((t - start[key]).abs().max()) for key, t in leaves().items())
            finite = all(bool(torch.isfinite(t).all()) for t in leaves().values())
            recs = [json.loads(l) for l in open(os.path.join(tcfg.logdir, "metrics.jsonl"))]
            steps = [r for r in recs if "loss" in r]
            ok = len(steps) == ARM_TRAIN_STEPS and all(
                np.isfinite(v) for r in steps for v in r.values() if isinstance(v, float))
            say(f"[arm-train] {name}: embedders moved by up to {moved:.3e}, finite {finite}, "
                f"{len(steps)} finite metric records {ok}")
            if not finite or not moved > 0 or not ok:
                fail(f"arm {name}: the update left the embedders unchanged or non-finite, or "
                     f"a metric is not finite")
            trainer.close()
        out[name] = _by_kind(fa, before_all)
    fa.launches_by_shape.clear()
    return out


# ----------------------------------------------------------------- slice 16
# the Upsample's naive path (JAX's ADAFACE_SUBPIXEL_UP=0), under which 8 and
# 8b run a second time
SUBPIXEL_NAIVE = {"ADAFACE_SUBPIXEL_UP": "0"}


def four_phase_convs(torch, x, weight, bias):
    """The phase fold in JAX's form (`adaface_tpu/ops/subpixel.py`): four
    2x2 convs of NHWC x with asymmetric pads, the phases interleaved, then
    the bias; [upsample] times it beside the port's one-conv form."""
    import torch.nn.functional as F

    from adaface_tpu_torch.ops.subpixel import _phase_taps

    b, h, w, _ = x.shape
    xc = x.permute(0, 3, 1, 2)
    outs = []
    for di in (0, 1):
        wr = _phase_taps(weight, di, 2)
        for dj in (0, 1):
            xp = F.pad(xc, (1 - dj, dj, 1 - di, di))
            outs.append(F.conv2d(xp, _phase_taps(wr, dj, 3)).permute(0, 2, 3, 1))
    y = torch.stack(outs).reshape(2, 2, b, h, w, -1)
    return y.permute(2, 3, 0, 4, 1, 5).reshape(b, 2 * h, 2 * w, -1) + bias


def phase_upsample(torch, pipe, card):
    """([upsample]) The UNet's and the VAE's `Upsample` at the shapes of one
    default request (forward pre-hooks during a request of 2 DDIM steps):
    the module under the default knobs gives `upsample2x_conv` (JAX's
    phase fold in one conv) bit for bit; that fold, the fold as JAX's four
    2x2 convs (`four_phase_convs`) and `nearest_upsample2x_conv_reference`
    (the ADAFACE_SUBPIXEL_UP=0 path) timed in bf16 on the module's weights,
    each with its relative L2 error against the naive function in fp32."""
    from adaface_tpu_torch.models import unet as unet_mod
    from adaface_tpu_torch.models import vae as vae_mod
    from adaface_tpu_torch.ops import subpixel

    seen = {}

    def record(name):
        def hook(mod, inp):
            seen[(name, tuple(inp[0].shape))] = mod
        return hook

    hooks = [m.register_forward_pre_hook(record(name))
             for name, model, cls in (("unet", pipe.unet, unet_mod.Upsample),
                                      ("vae", pipe.vae, vae_mod.Upsample))
             for m in model.modules() if isinstance(m, cls)]
    try:
        pipe.generate([PROMPT] * BATCH, seed=0, num_steps=2, guidance_scale=(10.0, 4.0),
                      height=SIZE, width=SIZE)
    finally:
        for hk in hooks:
            hk.remove()
    if len(seen) != 6:
        fail(f"[upsample] expected the UNet's and the VAE's three Upsample shapes, got "
             f"{sorted(seen)}")
    gen = torch.Generator(device="cuda").manual_seed(16)
    forms = {"fold": subpixel.upsample2x_conv,
             "four convs": lambda x, w, b: four_phase_convs(torch, x, w, b),
             "naive": subpixel.nearest_upsample2x_conv_reference}
    total = dict.fromkeys(forms, 0.0)
    for (model, shape), mod in sorted(seen.items()):
        x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        w, b = (t.detach().to(torch.bfloat16) for t in (mod.conv.weight, mod.conv.bias))
        with torch.inference_mode():
            if not torch.equal(mod(x), subpixel.upsample2x_conv(x, w, b)):
                fail(f"[upsample] {model} {shape}: the default module is not the phase fold")
            ref = subpixel.nearest_upsample2x_conv_reference(x.float(), w.float(), b.float())
            res = []
            for name, f in forms.items():
                ms = time_ms(torch, lambda: f(x, w, b))
                total[name] += ms
                res.append(f"{name} {ms:.4f} ms (rel L2 {rel_err(f(x, w, b).float(), ref):.3e})")
        say(f"[upsample] {model} {shape} bf16: " + ", ".join(res)
            + f"; rel L2 against the naive function in fp32 [{card}]")
        del x, ref
    say(f"[upsample] sum over the six shapes (one call each): "
        + ", ".join(f"{name} {t:.4f} ms" for name, t in total.items()) + f" [{card}]")


# [zero-shot]: a request conditioned on reference images alone (the JAX
# package's `scripts/zero_shot_test.py` path) on [main]'s UNet, VAE and CLIP
ZS_PROMPT = "a photo of a z " + ", " * 15 + "y, person"
ZS_IMAGES, ZS_IMAGE_SIZE, ZS_FACELESS = 4, 512, 2  # reference images; index without a face
# relative L2 error of each zero-shot output, bf16 on the card vs the same
# port code in fp32 on the CPU: the vision tower's fg and bg features, the
# fg (z) and bg (y) generators' [16, 1, K, 768] outputs, and the context
# after CLIP. The phase also runs faults through the card's stack (a second
# identity; the fg features fed to the bg generator): each output they
# change must fall outside its tolerance, so that the gate can tell a wrong
# stack from a sound one. Measured on an H100: clip_fg 1.495e-2, clip_bg
# 1.489e-2, z 1.274e-2, y 8.524e-3, context 1.143e-2; the faults 4.609e-2
# (the context under fg features as bg) to 2.006
ZS_REL_TOL = {"clip_fg": 3e-2, "clip_bg": 3e-2, "z": 2.5e-2, "y": 2e-2, "context": 3e-2}
ZS_MOVE_MIN = 1e-3  # a second identity must move the context by more (max abs)
ZS_CONTEXT_BATCH, ZS_CONTEXT_STEPS = 2, 10  # the generate(context=...) check


def zero_shot_builds(tok):
    """name -> constructor of each zero-shot module at the shipped model's widths:
    a ViT-L/14 vision tower, a ViT-L/14 text Arc2Face encoder, a fg generator
    (prompt2token_proj of that config, K 16) and a bg generator (1024-wide
    image features, 4 heads, 257 tokens, K 4), as the JAX trainer builds
    them."""
    from adaface_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
    from adaface_tpu_torch.models.clip_vision import CLIPVisionConfig, CLIPVisionEncoder
    from adaface_tpu_torch.personalization.subj_basis_generator import SubjBasisGenerator

    vis = CLIPVisionConfig.vit_l_14()
    return {
        "vision": lambda: CLIPVisionEncoder(vis),
        "arc2face": lambda: CLIPTextEncoder(CLIPTextConfig.vit_l_14()),
        "fg": lambda: SubjBasisGenerator(
            placeholder_is_bg=False, num_out_layers=16, num_out_embs_per_layer=16,
            output_dim=768, proj_cfg=CLIPTextConfig.vit_l_14(), pad_token_id=tok.eos_id),
        "bg": lambda: SubjBasisGenerator(
            placeholder_is_bg=True, num_out_layers=16, num_out_embs_per_layer=4,
            output_dim=768, image_embedding_dim=vis.hidden_size, num_heads=4,
            bg_num_id_vecs=vis.num_tokens),
    }


def zero_shot_references(seed):
    """ZS_IMAGES uint8 RGB images of ZS_IMAGE_SIZE and disk-shaped fg masks,
    from a numpy seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = ZS_IMAGE_SIZE
    images = [rng.integers(0, 256, (n, n, 3), dtype=np.uint8) for _ in range(ZS_IMAGES)]
    yy, xx = np.mgrid[:n, :n]
    masks = []
    for _ in range(ZS_IMAGES):
        cy, cx, r = rng.uniform(0.3 * n, 0.7 * n, 2).tolist() + [rng.uniform(0.2, 0.4) * n]
        masks.append(((yy - cy) ** 2 + (xx - cx) ** 2 <= r * r).astype(np.float32))
    return images, masks


def zero_shot_face_fn(images, seed):
    """A face embedder for `images`: a seeded unit 512-d vector for each, and
    None for image ZS_FACELESS (the face stack is not ported yet)."""
    import numpy as np

    def face(img):
        i = next(k for k, im in enumerate(images) if im is img)
        if i == ZS_FACELESS:
            return None
        v = np.random.default_rng([seed, i]).standard_normal(512)
        return (v / np.linalg.norm(v)).astype(np.float32)
    return face


def zero_shot_pipeline(torch, tok, clip, unet, vae, models, features):
    """A pipeline on (clip, unet, vae) whose manager holds the zero-shot
    placeholders z (fg, K 16) and y (bg, K 4) of `models`, conditioned on
    `features`."""
    from adaface_tpu_torch.personalization.arc2face import (
        FORWARD_TEMPLATE, INVERSE_TEMPLATE, make_template_ids)
    from adaface_tpu_torch.pipeline import StableDiffusionPipeline

    pipe = StableDiffusionPipeline(tok, clip, unet, vae)
    mgr = pipe.embedding_manager
    mgr.add_zero_shot_placeholder("z", tok.add_placeholder("z"), models["fg"])
    mgr.add_zero_shot_placeholder("y", tok.add_placeholder("y"), models["bg"],
                                  is_background=True)
    mgr.arc2face_encoder = models["arc2face"]
    templates = (make_template_ids(tok, FORWARD_TEMPLATE),
                 make_template_ids(tok, INVERSE_TEMPLATE), int(tok.encode("id")[0]))
    pipe.set_zero_shot_features(features, *templates)
    return pipe, templates


def phase_zero_shot(torch, pipe, card):
    """[zero-shot]: the zero-shot stack at full width in bf16 on the card
    (random weights from seeds), fed ZS_IMAGES reference images: the feature
    extractor's three vision passes, the Arc2Face forward and the
    generators, `encode_prompts`, then one warm-up and 3 timed batch-8
    requests at [main]'s point. Gates: the fg and bg features, both
    generators' outputs and the context against the same code in fp32 on
    the CPU, each fault (a second identity, fg features in place of bg
    ones) outside the tolerance it would have to pass; a second identity
    moves the context and the same one repeats it bit for bit; each
    request launches the flash kernels as a [main] request does;
    `generate(context=...)` gives images of the right shape."""
    from adaface_tpu_torch.data.tokenizer import HashTokenizer
    from adaface_tpu_torch.models.unet import UNetConfig, UNetModel
    from adaface_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from adaface_tpu_torch.personalization.arc2face import forward_face_embs
    from adaface_tpu_torch.personalization.zero_shot import (
        ZeroShotFeatureExtractor, ZeroShotFeatures)
    from adaface_tpu_torch.pipeline import build_random

    fa = _fa()
    t_phase = time.time()
    tok = HashTokenizer()
    builds = zero_shot_builds(tok)
    dtype = pipe.unet.in_conv.weight.dtype
    models = {name: build_random(b, 100 + i, pipe.device, dtype)
              for i, (name, b) in enumerate(builds.items())}
    n_params = {k: sum(p.numel() for p in m.parameters()) / 1e6 for k, m in models.items()}
    say(f"[zero-shot] stack built in {time.time() - t_phase:.1f} s (M parameters, bf16): "
        + ", ".join(f"{k} {v:.1f}" for k, v in n_params.items()))
    images, masks = zero_shot_references(0)
    face = zero_shot_face_fn(images, 1)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.time() - t0) * 1e3

    ZeroShotFeatureExtractor(models["vision"], face_embed_fn=face).encode(
        images, masks, calc_avg=True)  # warm-up
    ex = ZeroShotFeatureExtractor(models["vision"], face_embed_fn=face)
    feats, vision_ms = timed(lambda: ex.encode(images, masks, calc_avg=True))
    if feats.faceless_img_count != 1 or feats.id_embs.shape != (1, 512):
        fail(f"[zero-shot] {feats.faceless_img_count} faceless images, id embeddings "
             f"{tuple(feats.id_embs.shape)}; want 1 and (1, 512)")
    zpipe, templates = zero_shot_pipeline(torch, tok, pipe.clip, pipe.unet, pipe.vae, models,
                                          feats)
    mgr = zpipe.embedding_manager
    gen_kw = dict(forward_template_ids=templates[0], arcface_token_id=templates[2])
    with torch.inference_mode():
        mgr.compute_zero_shot_embeddings(feats, templates[1], **gen_kw)  # warm-up
        (subj, inv), gen_ms = timed(lambda: mgr.compute_zero_shot_embeddings(
            feats, templates[1], **gen_kw))
    prompts = [ZS_PROMPT] * BATCH
    zpipe.encode_prompts(prompts)  # warm-up
    ctx, encode_ms = timed(lambda: zpipe.encode_prompts(prompts))
    say(f"[zero-shot] stages (host clock, synchronized): 3 vision passes (fg and bg over "
        f"{ZS_IMAGES} images, the negative over 1) {vision_ms:.3f} ms, Arc2Face forward + "
        f"generators {gen_ms:.3f} ms, encode_prompts (B{BATCH}, with the generators) "
        f"{encode_ms:.3f} ms [{card}]")
    D = pipe.clip.cfg.hidden_size
    want_ctx = (16, BATCH, 77, D)
    if (tuple(ctx.shape) != want_ctx or subj["z"].shape != (16, 1, 16, D)
            or subj["y"].shape != (16, 1, 4, D) or not bool(torch.isfinite(ctx).all())):
        fail(f"[zero-shot] context {tuple(ctx.shape)} (want {want_ctx}), z "
             f"{tuple(subj['z'].shape)}, y {tuple(subj['y'].shape)}, or not finite")

    # the same identity repeats the context bit for bit; faults a broken
    # stack could make, run through the card's stack: a second identity,
    # and the fg features fed to the bg generator
    if not torch.equal(zpipe.encode_prompts(prompts), ctx):
        fail("[zero-shot] the same features gave another context")

    def run(features):
        with torch.inference_mode():
            out, _ = mgr.compute_zero_shot_embeddings(features, templates[1], **gen_kw)
        zpipe.set_zero_shot_features(features, *templates)
        return out, zpipe.encode_prompts(prompts)

    subj_id, ctx_id = run(ZeroShotFeatures(feats.clip_fg, feats.clip_bg,
                                           torch.roll(feats.id_embs, 1, dims=-1)))
    subj_swap, ctx_swap = run(ZeroShotFeatures(feats.clip_fg, feats.clip_fg, feats.id_embs))
    zpipe.set_zero_shot_features(feats, *templates)
    moved = float((ctx_id.float() - ctx.float()).abs().max())
    say(f"[zero-shot] a second identity moves the context by {moved:.4e} max abs "
        f"(must exceed {ZS_MOVE_MIN})")
    if not moved > ZS_MOVE_MIN:
        fail(f"[zero-shot] a second identity moved the context by {moved:.3e} only")

    # the same code in fp32 on the CPU, same weights, same reference images
    t0 = time.time()
    cpu_models = {k: cpu_fp32_copy(torch, m, builds[k]) for k, m in models.items()}
    clip_cpu = cpu_fp32_copy(torch, pipe.clip)
    feats_cpu = ZeroShotFeatureExtractor(cpu_models["vision"], face_embed_fn=face).encode(
        images, masks, calc_avg=True)
    # encode_prompts runs the CLIP and the generators only: the CPU
    # pipeline's UNet and VAE are tiny stand-ins that never run
    pipe_cpu, _ = zero_shot_pipeline(torch, HashTokenizer(), clip_cpu,
                                     UNetModel(UNetConfig.tiny()),
                                     AutoencoderKL(VAEConfig.tiny()), cpu_models, feats_cpu)
    with torch.inference_mode():
        subj_cpu, _ = pipe_cpu.embedding_manager.compute_zero_shot_embeddings(
            feats_cpu, templates[1], **gen_kw)
    ctx_cpu = pipe_cpu.encode_prompts(prompts)
    # output -> (card, CPU reference, {fault: the card's output under it})
    checks = {
        "clip_fg": (feats.clip_fg, feats_cpu.clip_fg, {"bg features": feats.clip_bg}),
        "clip_bg": (feats.clip_bg, feats_cpu.clip_bg, {"fg features": feats.clip_fg}),
        "z": (subj["z"], subj_cpu["z"], {"second identity": subj_id["z"]}),
        "y": (subj["y"], subj_cpu["y"], {"fg features as bg": subj_swap["y"]}),
        "context": (ctx, ctx_cpu, {"second identity": ctx_id, "fg features as bg": ctx_swap}),
    }
    errs = {k: rel_err(got, ref) for k, (got, ref, _) in checks.items()}
    fault_errs = {(k, f): rel_err(bad, ref) for k, (_, ref, faults) in checks.items()
                  for f, bad in faults.items()}
    say(f"[zero-shot] bf16 card vs fp32 cpu relative L2 error (tolerance; each fault's "
        f"error): " + "; ".join(
            f"{k} {errs[k]:.3e} (tol {ZS_REL_TOL[k]}; " + ", ".join(
                f"{f} {e:.3e}" for (kk, f), e in fault_errs.items() if kk == k) + ")"
            for k in checks) + f"; the CPU reference took {time.time() - t0:.1f} s")
    del cpu_models, clip_cpu, pipe_cpu, subj_id, subj_swap, ctx_id, ctx_swap
    for k, err in errs.items():
        if not err <= ZS_REL_TOL[k]:
            fail(f"[zero-shot] {k} on the card disagrees with the CPU reference "
                 f"({err:.3e} > {ZS_REL_TOL[k]})")
    for (k, f), err in fault_errs.items():
        if not err > ZS_REL_TOL[k]:
            fail(f"[zero-shot] the {k} gate cannot tell the fault '{f}' apart "
                 f"({err:.3e} <= {ZS_REL_TOL[k]})")

    kw = dict(num_steps=STEPS, guidance_scale=(10.0, 4.0), height=SIZE, width=SIZE)
    t0 = time.time()
    zpipe.generate(prompts, seed=0, **kw)
    say(f"[zero-shot] warm-up request {time.time() - t0:.3f} s [{card}]")
    want = {s: n for s, (_, n) in MAIN_SHAPES.items()}
    times = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(3):
        fa.launches_by_shape.clear()
        torch.cuda.synchronize()
        t0 = time.time()
        imgs = zpipe.generate(prompts, seed=i + 1, **kw)
        times.append(time.time() - t0)
        counts = {(b, lq, h, d): n for (kind, arm, b, lq, lk, h, d), n
                  in fa.launches_by_shape.items() if kind == "fwd"}
        arms = launches_by_arm(fa)
        say(f"[zero-shot] request {i}: {times[-1]:.3f} s, kernel launches {n_launches(fa)} "
            f"{sorted(counts.items())} by arm {arms} [{card}]")
        if n_launches(fa) != 750 or counts != want or arms != {"K1": 500, "K4": 250}:
            fail(f"[zero-shot] expected [main]'s 750 launches ({want}; K1 500, K4 250), "
                 f"got {n_launches(fa)} {counts} {arms}")
        if (imgs.shape != (BATCH, SIZE, SIZE, 3) or str(imgs.dtype) != "uint8"
                or imgs.std() < 1.0):
            fail(f"[zero-shot] images {imgs.shape} {imgs.dtype} std {imgs.std():.3f}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    med = statistics.median(times)
    say(f"[zero-shot] batch {BATCH} {SIZE}x{SIZE} DDIM-{STEPS} CFG 10->4 bf16 from {ZS_IMAGES} "
        f"reference images: median {med:.3f} s/request, {BATCH / med:.4f} img/s, best "
        f"{min(times):.3f} s, peak {peak:.2f} GiB [{card}]")

    # the Arc2Face evaluation mode: its forward embeddings drive the UNet
    with torch.inference_mode():
        full, _ = forward_face_embs(models["arc2face"], feats.id_embs, templates[0],
                                    templates[2])
    imgs = zpipe.generate([ZS_PROMPT] * ZS_CONTEXT_BATCH, num_steps=ZS_CONTEXT_STEPS,
                          height=SIZE, width=SIZE, context=full[None, :1])
    want_shape = (ZS_CONTEXT_BATCH, SIZE, SIZE, 3)
    if imgs.shape != want_shape or str(imgs.dtype) != "uint8":
        fail(f"[zero-shot] generate(context=...) gave {imgs.shape} {imgs.dtype}, "
             f"want {want_shape} uint8")
    say(f"[zero-shot] generate(context=[1, 1, 77, {D}] Arc2Face forward embeddings) "
        f"B{ZS_CONTEXT_BATCH} DDIM-{ZS_CONTEXT_STEPS}: images {imgs.shape} {imgs.dtype}")
    del models, zpipe, ex
    torch.cuda.empty_cache()
    say(f"[zero-shot] phase {time.time() - t_phase:.1f} s")


# [zs-train]: zero-shot training of the generators (the JAX package's
# `ZeroShotTrainer.fit`) and Arc2Face distillation of per-subject training
# on [main]'s UNet, VAE and CLIP with a second SD v1.5 UNet as the teacher
ZS_DARK_LEVEL = 48  # pixel values of the faceless reference image lie below
ZS_FACELESS_MEAN = 40.0  # the phase's face embedder finds no face below this mean
ZS_TRAIN_ROUNDS = 3  # rounds of the six micro-step kinds below
# [zs-train-ref]: S 1 Arc2Face draws read against fp32 on the CPU, and their
# loss gate. That loss is the masked mean square of two bf16 UNets' eps
# difference (student and teacher), so it carries both UNets' rounding: on
# an H100 the four draws read 6.6e-4 to 5.713e-3 (t 18) while the
# student's and the teacher's eps each read 1.7-1.8e-2, within the
# recon path's TRAIN_EPS_TOL. The gate lies between that largest sound
# reading and the smallest reading of the teacher fed the student's
# context (2.805e-2); a second identity reads 5.0e-3 to 1.2e-2, inside the
# loss's noise, and is left to the generators' gradient gate.
ZS_REF_A2F_DRAWS = 4
ZS_A2F_LOSS_TOL = 1e-2
# the flash kernels at batch 1: a multi-step Arc2Face iteration (S 3 at
# batch 3) keeps ceil(3 / 3) = 1 instance; the student masks its keys (the
# augmentation mask), the teacher does not
ZS_B1_SHAPES = {(1, 4096, 8, 40): (K1, 5, 4), (1, 1024, 8, 80): (K1, 5, 5),
                (1, 256, 8, 160): (K4, 5, 5)}


def zs_train_face_fn(seed):
    """A face embedder for the seeded dataset's augmented images: None for
    an image darker than ZS_FACELESS_MEAN, else a unit 512-d vector seeded
    by the image's content."""
    import numpy as np

    def face(img):
        if float(img.mean()) < ZS_FACELESS_MEAN:
            return None
        v = np.random.default_rng([seed, int(img.astype(np.int64).sum())]).standard_normal(512)
        return (v / np.linalg.norm(v)).astype(np.float32)
    return face


@contextlib.contextmanager
def scripted_plans(module, plans):
    """Within the block, the trainer module's `plan_iteration` hands out
    `plans` in order, so that each micro-step kind runs where wanted."""
    real = module.plan_iteration
    queue = list(plans)
    module.plan_iteration = lambda rng, step, cfg: queue.pop(0)
    try:
        yield queue
    finally:
        module.plan_iteration = real


def zs_kinds():
    """name -> (IterPlan maker, UNet batch, teacher calls, student calls) of
    each micro-step kind the phase drives."""
    from adaface_tpu_torch.training.iter_plan import (
        ARC2FACE_DISTILL, COMPOS_DISTILL, RECON, IterPlan)

    a2f = lambda **kw: IterPlan(iter_type=ARC2FACE_DISTILL, training_percent=0.3, **kw)
    return {
        "zs compos": (lambda: IterPlan(iter_type=COMPOS_DISTILL, training_percent=0.3,
                                       use_background_token=True,
                                       comp_init_fg_from_training_image=True), 4, 0, 1),
        "zs recon, bg token": (lambda: IterPlan(iter_type=RECON, training_percent=0.3,
                                                use_background_token=True,
                                                emb_noise_std=0.04), 3, 0, 1),
        "zs recon, no bg token": (lambda: IterPlan(iter_type=RECON, training_percent=0.3),
                                  3, 0, 1),
        "zs a2f S1 real face": (lambda: a2f(num_denoising_steps=1), 3, 1, 1),
        "zs a2f S3 random face": (lambda: a2f(num_denoising_steps=3,
                                              gen_arc2face_rand_face=True), 1, 3, 3),
        "zs a2f S3 noised ids": (lambda: a2f(num_denoising_steps=3,
                                             add_noise_to_real_id_embs=True), 1, 3, 3),
    }


def unet_flash_want(b, teacher_calls, student_calls):
    """kind -> (B, L, H, d) -> flash launches of `teacher_calls` forward-only
    and `student_calls` trained UNet calls at batch b (TRAIN_SHAPES' counts
    a call)."""
    want = {"fwd": {}, "dq": {}, "dkv": {}}
    for (_, l, h, d), (_, nf, nb) in TRAIN_SHAPES.items():
        want["fwd"][(b, l, h, d)] = nf * (teacher_calls + student_calls)
        if student_calls:
            want["dq"][(b, l, h, d)] = want["dkv"][(b, l, h, d)] = nb * student_calls
    return {k: v for k, v in want.items() if v}


def flash_ctas(kind, b, l, h, d, bias=False):
    """CTAs of one bf16 flash launch of `kind` (flags 0), from the rows a
    CTA the built kernel reports (`flash_attention.cta_rows`) and, for
    dk/dv, the wrapper's split (`bwd_launch_plan`)."""
    from adaface_tpu_torch.device import sm_count
    from adaface_tpu_torch.ops import flash_attention as fa

    split = fa.bwd_launch_plan(b, h, l, l, d, sm_count(0)).split if kind == "dkv" else 1
    return -(-l // fa.cta_rows(kind, d, bias=bias)) * h * b * split


def zs_train_configs(logdir, batch_size=None):
    """`configs/finetune-ada.yaml`'s trainer and iter_plan values (batch 3,
    Prodigy d_coef 10, accumulation 2, clip 0.5), zero-shot on, without
    checkpoints or logging on the way."""
    import dataclasses

    from adaface_tpu_torch.config import load_config
    from adaface_tpu_torch.training.iter_plan import IterPlanConfig
    from adaface_tpu_torch.training.trainer import TrainerConfig

    cfg = load_config(os.path.join(CONFIG_DIR, "finetune-ada.yaml"))
    fields = lambda cls, section: {k: v for k, v in cfg[section].items()
                                   if k in {f.name for f in dataclasses.fields(cls)}}
    tcfg = TrainerConfig(**dict(fields(TrainerConfig, "trainer"), log_every_steps=10 ** 6,
                                ckpt_every_steps=10 ** 6, logdir=logdir))
    if batch_size is not None:
        tcfg = dataclasses.replace(tcfg, batch_size=batch_size)
    return tcfg, IterPlanConfig(**dict(fields(IterPlanConfig, "iter_plan"), do_zero_shot=True))


def _grad_errs(torch, card_gens, cpu_gens):
    """generator -> (relative L2 error of all its parameters' gradients
    together, worst leaf error among leaves holding >= 1e-3 of the largest
    leaf's norm, that leaf)."""
    out = {}
    for s in sorted(cpu_gens):
        pairs = [(n, (g.grad if g.grad is not None else torch.zeros_like(g)).float().cpu(),
                  c.grad if c.grad is not None else torch.zeros_like(c))
                 for (n, g), (_, c) in zip(card_gens[s].named_parameters(),
                                           cpu_gens[s].named_parameters())]
        top = max(float(c.norm()) for _, _, c in pairs)
        whole = (torch.cat([(g - c).flatten() for _, g, c in pairs]).norm()
                 / torch.cat([c.flatten() for _, _, c in pairs]).norm()).item()
        worst, where = 0.0, ""
        for n, g, c in pairs:
            if float(c.norm()) >= 1e-3 * top:
                e = ((g - c).norm() / c.norm()).item()
                if e > worst:
                    worst, where = e, n
        if not all(bool(torch.isfinite(g).all()) for _, g, _ in pairs):
            worst = float("inf")
        out[s] = (whole, worst, where)
    return out


def phase_zs_train_reference(torch, zpipe, trainer, gens, builds, teacher_unet, tmp, card):
    """One zs recon loss with its generator gradients and ZS_REF_A2F_DRAWS
    S 1 Arc2Face losses, at 32x32 latents and batch 1, bf16 on the card
    (fp32 generators) against the same weights in fp32 on the CPU (the
    reference's Upsample as `bf16_upsample_reference` sets it), dropout
    off. Gates, each with planted faults of which at least one must read
    outside it: the zs recon loss within `loss_tol` (faults: a second
    identity, the fg features fed to the bg generator, the bg generator's
    dropout left on, the recon loss without its fg mask); every draw's
    Arc2Face loss within ZS_A2F_LOSS_TOL (faults on each draw: a second
    identity, the teacher fed the student's context, the fg mask dropped);
    the student's and the teacher's eps of the first draw, each within
    TRAIN_EPS_TOL (the witness that the loss's error is the two bf16 UNets'
    rounding); each generator's gradients (all its leaves as one vector)
    within TRAIN_GRAD_TOL (faults: the recon loss's, and z's
    prompt2token_proj gradient scale left out, which moves no loss)."""
    import copy
    import dataclasses

    from adaface_tpu_torch.training import train_step as ts_mod
    from adaface_tpu_torch.training.iter_plan import ARC2FACE_DISTILL, RECON, IterPlan
    from adaface_tpu_torch.training.train_step import (
        make_zero_shot_arc2face_step, make_zero_shot_recon_step)
    from adaface_tpu_torch.training.zs_trainer import ZeroShotTrainer

    ds_dir = os.path.join(tmp, "zs_ref_subjects")
    g_card = {s: copy.deepcopy(g) for s, g in gens.items()}
    small = ZeroShotTrainer(zpipe, make_dataset(ds_dir, size=256, subjects=2,
                                                num_vectors_per_subj_token=16),
                            trainer.extractor,
                            g_card, trainer._arc_encoder,
                            dataclasses.replace(trainer.cfg, batch_size=1,
                                                logdir=os.path.join(tmp, "zs_ref")),
                            trainer.plan_cfg, bg_placeholders=frozenset({"y"}))
    recon_plan = IterPlan(iter_type=RECON, training_percent=0.3, use_background_token=True)
    seeded = small.build_zs_recon_batch(small._draw_examples(1), recon_plan)
    batch = seeded._replace(dropout_seed=None)
    a2f_plan = IterPlan(iter_type=ARC2FACE_DISTILL, training_percent=0.3)
    a2f_batches = [small.build_zs_arc2face_batch(a2f_plan)._replace(dropout_seed=None)
                   for _ in range(ZS_REF_A2F_DRAWS)]
    if tuple(batch.latents.shape) != (1, 32, 32, 4) or any(
            b.latents.shape[0] != 1 for b in a2f_batches):
        fail(f"[zs-train-ref] latents {tuple(batch.latents.shape)}, want (1, 32, 32, 4)")
    recon_step = small._get_zs_recon_step(True)
    a2f_step = small._get_zs_arc2face_step(a2f_plan, teacher_unet)

    def card_recon(b):
        for g in g_card.values():
            g.zero_grad(set_to_none=True)
        loss, m = recon_step.loss_fn(g_card, b)
        loss.backward()
        return loss.item(), m

    def card_a2f(b):
        with torch.no_grad():
            return a2f_step.loss_fn(g_card, b)[0].item()

    @contextlib.contextmanager
    def teacher_context(ctx):
        # the fault: the teacher fed `ctx` in place of the Arc2Face forward's
        real = ts_mod._teacher_trajectory
        ts_mod._teacher_trajectory = lambda unet, sched, b, _, S: real(unet, sched, b, ctx, S)
        try:
            yield
        finally:
            ts_mod._teacher_trajectory = real

    second = lambda b: b._replace(id_embs=torch.roll(b.id_embs, 1, dims=-1))
    a2f_gpu, a2f_faults, eps_gpu = [], [], {"student": [], "teacher": []}
    for i, b in enumerate(a2f_batches):
        captured = []
        hook = zpipe.clip.register_forward_hook(lambda m, inp, o: captured.append(o.detach()))
        with contextlib.ExitStack() as stack:
            if i == 0:
                stack.enter_context(first_output(zpipe.unet, eps_gpu["student"]))
                stack.enter_context(first_output(teacher_unet, eps_gpu["teacher"]))
            a2f_gpu.append(card_a2f(b))
        hook.remove()
        # the student's context (its first layer) from the clip call above
        student0 = captured[-1].reshape((16, -1) + tuple(captured[-1].shape[1:]))[0]
        with teacher_context(student0):
            swap = card_a2f(b)
        a2f_faults.append({"a second identity": card_a2f(second(b)),
                           "the teacher fed the student's context": swap,
                           "the fg mask dropped": card_a2f(b._replace(fg_mask=None))})

    # the same code in fp32 on the CPU
    t0 = time.time()
    cpu = lambda m, build=None: cpu_fp32_copy(torch, m, build).requires_grad_(False)
    clip_cpu, unet_cpu, teacher_cpu = cpu(zpipe.clip), cpu(zpipe.unet), cpu(teacher_unet)
    arc_cpu = cpu(trainer._arc_encoder, builds["arc2face"])
    g_cpu = {s: cpu(g, builds["fg" if s == "z" else "bg"]).requires_grad_(True)
             for s, g in gens.items()}
    kw = dict(bg_placeholders=frozenset({"y"}), arc2face_encoder=arc_cpu,
              templates=small._templates, skip_weights=zpipe.skip_weights)
    recon_cpu = make_zero_shot_recon_step(
        clip_cpu, unet_cpu, zpipe.base_sched, None, **kw, bg_weight=small.cfg.bg_recon_weight,
        complem_weight=small.cfg.fg_bg_complementary_loss_weight,
        xlayer_weight=small.cfg.fg_bg_xlayer_consist_loss_weight,
        prompt_delta_weight=small._delta_w, use_bg_token=True)
    a2f_cpu = make_zero_shot_arc2face_step(clip_cpu, unet_cpu, teacher_cpu, zpipe.base_sched,
                                           None, **kw, num_denoising_steps=1)
    to_cpu = lambda b: b._replace(**{f: (v.detach().cpu().float() if v.is_floating_point()
                                         else v.cpu())
                                     for f, v in b._asdict().items() if torch.is_tensor(v)})
    eps_cpu = {"student": [], "teacher": []}
    a2f_ref = []
    with bf16_upsample_reference(torch):
        loss_cpu, m_cpu = recon_cpu.loss_fn(g_cpu, to_cpu(batch))
        loss_cpu.backward()
        for i, b in enumerate(a2f_batches):
            with torch.no_grad(), contextlib.ExitStack() as stack:
                if i == 0:
                    stack.enter_context(first_output(unet_cpu, eps_cpu["student"]))
                    stack.enter_context(first_output(teacher_cpu, eps_cpu["teacher"]))
                a2f_ref.append(a2f_cpu.loss_fn(g_cpu, to_cpu(b))[0].item())
    say(f"[zs-train-ref] fp32 CPU zs recon loss and gradients and {len(a2f_ref)} Arc2Face "
        f"losses in {time.time() - t0:.1f} s")
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-12)
    loss_gpu, m_gpu = card_recon(batch)
    errs = _grad_errs(torch, g_card, g_cpu)
    recon_faults = {}
    for name, b in (("a second identity", second(batch)),
                    ("the fg features fed to the bg generator",
                     batch._replace(clip_bg=batch.clip_fg)),
                    ("the bg generator's dropout left on", seeded),
                    ("the recon loss without its fg mask", batch._replace(fg_mask=None))):
        recon_faults[name] = (rel(card_recon(b)[0], loss_cpu.item()),
                              _grad_errs(torch, g_card, g_cpu))
    z_scale = g_card["z"].prompt2token_proj_grad_scale
    g_card["z"].prompt2token_proj_grad_scale = 1.0
    try:
        grad_faults = {"z's prompt2token_proj gradient scale left out":
                       (rel(card_recon(batch)[0], loss_cpu.item()),
                        _grad_errs(torch, g_card, g_cpu))}
    finally:
        g_card["z"].prompt2token_proj_grad_scale = z_scale
    grad_faults.update(recon_faults)

    for k in sorted(m_cpu):
        say(f"[zs-train-ref] {k:22s} card {m_gpu[k].item():.6e} cpu {m_cpu[k].item():.6e} "
            f"relative error {rel(m_gpu[k].item(), m_cpu[k].item()):.3e}")
    tol = loss_tol()
    recon_err = rel(loss_gpu, loss_cpu.item())
    say(f"[zs-train-ref] zs recon loss relative error {recon_err:.3e} (tol {tol}); faults: "
        + ", ".join(f"{n} {e:.3e}" for n, (e, _) in recon_faults.items())
        + f" [Upsample: {upsample_path()}]")
    a2f_errs = [rel(g, r) for g, r in zip(a2f_gpu, a2f_ref)]
    for i, (g, r, e, faults) in enumerate(zip(a2f_gpu, a2f_ref, a2f_errs, a2f_faults)):
        say(f"[zs-train-ref] Arc2Face S1 draw {i} (t {int(a2f_batches[i].timesteps[0])}): "
            f"loss card {g:.6e} cpu {r:.6e}, relative error {e:.3e} (tol {ZS_A2F_LOSS_TOL}); "
            "faults: " + ", ".join(f"{n} {rel(v, r):.3e}" for n, v in faults.items()))
    eps_errs = {who: rel_err(eps_gpu[who][0], eps_cpu[who][0]) for who in eps_gpu}
    diff_err = rel_err(eps_gpu["student"][0] - eps_gpu["teacher"][0],
                       eps_cpu["student"][0] - eps_cpu["teacher"][0])
    say(f"[zs-train-ref] Arc2Face S1 draw 0 eps relative L2 error: student {eps_errs['student']:.3e}, "
        f"teacher {eps_errs['teacher']:.3e} (tol {TRAIN_EPS_TOL}), student - teacher "
        f"{diff_err:.3e}; the loss's relative error {a2f_errs[0]:.3e} against 2r + r^2 = "
        f"{2 * diff_err + diff_err ** 2:.3e} of r = the difference's error")
    for s in sorted(errs):
        say(f"[zs-train-ref] generator {s} gradients relative L2 error {errs[s][0]:.3e} all "
            f"leaves as one vector (tol {TRAIN_GRAD_TOL}; worst leaf holding >= 1e-3 of the "
            f"largest leaf's norm {errs[s][1]:.3e}, {errs[s][2]}); faults: " + ", ".join(
                f"{n} {fe[s][0]:.3e}" for n, (_, fe) in grad_faults.items()))
    if not recon_err <= tol or not max(a2f_errs) <= ZS_A2F_LOSS_TOL:
        fail("[zs-train-ref] a loss on the card disagrees with the fp32 CPU reference")
    if not max(eps_errs.values()) <= TRAIN_EPS_TOL:
        fail("[zs-train-ref] the student's or the teacher's eps disagrees with the fp32 CPU "
             "reference")
    if not all(e[0] <= TRAIN_GRAD_TOL for e in errs.values()):
        fail("[zs-train-ref] a generator's gradients disagree with the fp32 CPU reference")
    if not max(e for e, _ in recon_faults.values()) > tol:
        fail("[zs-train-ref] the zs recon loss gate cannot tell any planted fault apart")
    for i, (r, faults) in enumerate(zip(a2f_ref, a2f_faults)):
        if not max(rel(v, r) for v in faults.values()) > ZS_A2F_LOSS_TOL:
            fail(f"[zs-train-ref] the Arc2Face loss gate cannot tell any planted fault apart "
                 f"on draw {i}")
    for s in sorted(errs):
        if not max(fe[s][0] for _, fe in grad_faults.values()) > TRAIN_GRAD_TOL:
            fail(f"[zs-train-ref] generator {s}'s gradient gate cannot tell any planted fault "
                 "apart")
    small.close()
    del g_card, g_cpu, clip_cpu, unet_cpu, teacher_cpu, arc_cpu, small


def phase_zs_train(torch, pipe, trainer_cls, tmp, card):
    """[zs-train]: `ZeroShotTrainer.fit` at full width in bf16 (fp32
    generators), ZS_TRAIN_ROUNDS rounds of the six kinds of `zs_kinds` with
    a second SD v1.5 UNet as the Arc2Face teacher, each micro-step's flash
    launches exact by kind and shape; the generators move at the first
    update and stay finite; the last checkpoint loads back bit for bit;
    one profiled zs recon micro-step; the fp32 reference
    (`phase_zs_train_reference`); then `Trainer.fit(arc2face_teacher=)` at
    S 1 and S 3 and the training entry point with `--arc2face_unet` on the
    teacher written as diffusers fp16 safetensors. Returns the flash
    launches of the zero-shot micro-steps, (kind, B, L, H, d) -> n."""
    import numpy as np

    from adaface_tpu_torch.data.tokenizer import HashTokenizer
    from adaface_tpu_torch.interop.checkpoint_io import save_safetensors
    from adaface_tpu_torch.interop.diffusers_unet import diffusers_unet_state_dict
    from adaface_tpu_torch.interop.hf_clip import hf_clip_text_state_dict
    from adaface_tpu_torch.models.unet import UNetModel
    from adaface_tpu_torch.personalization.static_embedding import embedder_leaves
    from adaface_tpu_torch.personalization.zero_shot import ZeroShotFeatureExtractor
    from adaface_tpu_torch.pipeline import StableDiffusionPipeline, build_random
    from adaface_tpu_torch.train import main as train_main
    from adaface_tpu_torch.training import trainer as trainer_mod
    from adaface_tpu_torch.training import zs_trainer as zs_mod
    from adaface_tpu_torch.training.arc2face_teacher import Arc2FaceTeacher
    from adaface_tpu_torch.training.iter_plan import IterPlan, RECON

    fa = _fa()
    t_phase = time.time()
    tok = HashTokenizer()
    builds = zero_shot_builds(tok)
    dev, dt = pipe.device, pipe.unet.in_conv.weight.dtype
    vision = build_random(builds["vision"], 100, dev, dt)
    arc = build_random(builds["arc2face"], 101, dev, dt)
    gens = {"z": build_random(builds["fg"], 102, dev), "y": build_random(builds["bg"], 103, dev)}
    teacher_unet = build_random(lambda: UNetModel(pipe.unet.cfg), 200, dev, dt).to(
        memory_format=torch.channels_last)
    zpipe = StableDiffusionPipeline(tok, pipe.clip, pipe.unet, pipe.vae)
    zpipe.embedding_manager.add_zero_shot_placeholder("z", tok.add_placeholder("z"), gens["z"])
    zpipe.embedding_manager.add_zero_shot_placeholder("y", tok.add_placeholder("y"), gens["y"],
                                                      is_background=True)
    face = zs_train_face_fn(1)
    tcfg, pcfg = zs_train_configs(os.path.join(tmp, "zs_run"))
    # the prompts pad z to the fg generator's 16 vectors
    ds = make_dataset(os.path.join(tmp, "zs_subjects"), subjects=2, dark={(0, 3)},
                      num_vectors_per_subj_token=16)
    trainer = zs_mod.ZeroShotTrainer(zpipe, ds, ZeroShotFeatureExtractor(vision,
                                                                         face_embed_fn=face),
                                     gens, arc, tcfg, pcfg, bg_placeholders=frozenset({"y"}))
    say(f"[zs-train] models built in {time.time() - t_phase:.1f} s: the generators in fp32 "
        f"(fg {sum(p.numel() for p in gens['z'].parameters()) / 1e6:.1f} M, bg "
        f"{sum(p.numel() for p in gens['y'].parameters()) / 1e6:.1f} M parameters), the rest "
        f"bf16 (a second SD v1.5 UNet as the teacher); finetune-ada.yaml: batch "
        f"{tcfg.batch_size}, accumulation {tcfg.accumulate_grad_batches}, Prodigy d_coef "
        f"{tcfg.d_coef}, clip {tcfg.grad_clip}, do_zero_shot {pcfg.do_zero_shot}")

    kinds = zs_kinds()
    order = [name for _ in range(ZS_TRAIN_ROUNDS) for name in kinds]
    params = lambda: {(s, n): p.detach().clone() for s, g in gens.items()
                      for n, p in g.named_parameters()}
    start = params()
    marks = []
    real_post = trainer._post_step

    def post(t0):
        torch.cuda.synchronize()
        marks.append((time.time(), dict(fa.launches_by_shape)))
        if len(marks) == 3:  # the first optimizer update (accumulation 2)
            now = params()
            moved = max(float((now[k] - start[k]).abs().max()) for k in start)
            finite = all(bool(torch.isfinite(t).all()) for t in now.values())
            say(f"[zs-train] after the first update the generators moved by up to "
                f"{moved:.3e}, finite {finite}")
            if not finite or not moved > 0:
                fail("[zs-train] the first update left the generators unchanged or non-finite")
            del now
        real_post(t0)

    trainer._post_step = post
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches_by_shape.clear()
    marks.append((time.time(), {}))
    with scripted_plans(zs_mod, [kinds[name][0]() for name in order]):
        trainer.fit(len(order), arc2face_teacher_unet=teacher_unet)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    trainer._post_step = real_post
    del start
    times = {}
    totals = {}
    for i, name in enumerate(order):
        (t_a, before), (t_b, after) = marks[i], marks[i + 1]
        got = launches_between(before, after)
        _, b, n_teacher, n_student = kinds[name]
        want = unet_flash_want(b, n_teacher, n_student)
        say(f"[zs-train] micro-step {i} ({name}): {t_b - t_a:.3f} s, launches "
            f"{ {k: sorted(v.items()) for k, v in sorted(got.items())} } [{card}]")
        if got != want:
            fail(f"[zs-train] micro-step {i} ({name}): expected the launches {want}, got {got}")
        times.setdefault(name, []).append(t_b - t_a)
        for kind, by in got.items():
            for (bb, l, h, d), n in by.items():
                totals[(kind, bb, l, h, d)] = totals.get((kind, bb, l, h, d), 0) + n
    recs = [json.loads(line) for line in open(os.path.join(tcfg.logdir, "metrics.jsonl"))]
    steps = [r for r in recs if "loss" in r]
    want_types = ["compos_distill" if "compos" in n else "arc2face_distill" if "a2f" in n
                  else "recon" for n in order]
    if [r["iter_type"] for r in steps] != want_types or not all(
            np.isfinite(v) for r in steps for v in r.values() if isinstance(v, float)):
        fail(f"[zs-train] the micro-steps ran as {[r['iter_type'] for r in steps]} (want "
             f"{want_types}) or logged a non-finite value")
    for i, name in enumerate(order[:len(kinds)]):
        say(f"[zs-train] ran {name}: "
            f"{ {k: round(v, 6) for k, v in steps[i].items() if isinstance(v, float)} }")
    say(f"[zs-train] median s per micro-step after each kind's first (batch 3 512x512 bf16; "
        f"compos one block of 4 UNet rows; a2f S3 at batch 1): " + ", ".join(
            f"{name} {statistics.median(ts[1:]):.3f} (first {ts[0]:.3f})"
            for name, ts in times.items()) + f"; peak {peak:.2f} GiB [{card}]")

    # the last checkpoint: generators, frozen anchor, optimizer and RNG
    # states come back bit for bit after a perturbation
    t0 = time.time()
    path = os.path.join(tcfg.logdir, "subj_basis_last.pt")
    def leaves(x):
        if torch.is_tensor(x):
            return [x]
        if isinstance(x, dict):
            return [t for k in sorted(x, key=str) for t in leaves(x[k])]
        if isinstance(x, (list, tuple)):
            return [t for v in x for t in leaves(v)]
        return [x]

    state = lambda: leaves([[g.state_dict() for g in gens.values()],
                            [g.state_dict() for g in trainer._gen0.values()],
                            trainer.optimizer.state_dict(), trainer.rng.bit_generator.state,
                            trainer.dataset.rng.bit_generator.state])
    snap = [t.detach().clone() if torch.is_tensor(t) else t for t in state()]
    with torch.no_grad():
        for g in list(gens.values()) + list(trainer._gen0.values()):
            for p in g.parameters():
                p.add_(1.0)
        for t in trainer.optimizer.inner.exp_avg:
            t.add_(1.0)
    trainer.rng.random(7)
    trainer.load_checkpoint(path)
    now = state()
    same = len(now) == len(snap) and all(
        (torch.is_tensor(a) and torch.is_tensor(b) and a.dtype == b.dtype
         and torch.equal(a, b.to(a.device))) or (not torch.is_tensor(a) and a == b)
        for a, b in zip(snap, now))
    say(f"[zs-train] checkpoint {os.path.getsize(path) / 2 ** 30:.2f} GiB: save -> load "
        f"{'bit for bit' if same else 'DIFFERS'} ({time.time() - t0:.1f} s to check)")
    if not same:
        fail("[zs-train] the checkpoint did not load back bit for bit")
    del snap, now

    profile_breakdown(torch, lambda: trainer._run_zs_recon(IterPlan(
        iter_type=RECON, training_percent=0.3, use_background_token=True)), "zs-train-profile",
        "one zs recon micro-step (bg token, batch 3)", card)
    phase_zs_train_reference(torch, zpipe, trainer, gens, builds, teacher_unet, tmp, card)
    trainer.close()
    del trainer

    # per-subject training with the teacher: Trainer.fit and the entry point
    teacher = Arc2FaceTeacher(teacher_unet, arc, pipe.tokenizer, face_embed_fn=face)
    a2f = {name: kinds[name] for name in ("zs a2f S1 real face", "zs a2f S3 random face")}
    tcfg2, pcfg2 = train_configs(os.path.join(tmp, "a2f_run"))
    tr = trainer_cls(pipe, make_dataset(os.path.join(tmp, "a2f_subject")), tcfg2, pcfg2)
    leaves = lambda: {(s, n): t.detach().clone() for s, p in pipe.embedding_manager.embedders
                      .items() for n, t in embedder_leaves(p)}
    before_emb = leaves()
    with scripted_plans(trainer_mod, [k[0]() for k in a2f.values()]):
        for i, (name, (_, b, n_teacher, n_student)) in enumerate(a2f.items()):
            before = dict(fa.launches_by_shape)
            torch.cuda.synchronize()
            t0 = time.time()
            tr.fit(i + 1, arc2face_teacher=teacher.as_tuple())
            torch.cuda.synchronize()
            got = launches_between(before, fa.launches_by_shape)
            say(f"[a2f-train] Trainer micro-step {i} ({name[3:]}): {time.time() - t0:.3f} s, "
                f"launches { {k: sorted(v.items()) for k, v in sorted(got.items())} } [{card}]")
            if got != unet_flash_want(b, n_teacher, n_student):
                fail(f"[a2f-train] micro-step {i}: expected "
                     f"{unet_flash_want(b, n_teacher, n_student)}, got {got}")
    recs = [json.loads(line) for line in open(os.path.join(tcfg2.logdir, "metrics.jsonl"))
            if '"loss"' in line]
    moved = max(float((t - before_emb[k]).abs().max()) for k, t in leaves().items())
    say(f"[a2f-train] losses {[round(r['loss'], 6) for r in recs]}, embedders moved by up to "
        f"{moved:.3e} after the update")
    if ([r["iter_type"] for r in recs] != ["arc2face_distill"] * 2
            or not all(np.isfinite(r["loss"]) for r in recs) or not moved > 0):
        fail("[a2f-train] the Arc2Face micro-steps did not train")
    tr.close()

    # the entry point on the teacher written as Arc2Face ships: a diffusers
    # UNet and an HF text encoder, fp16 safetensors
    t0 = time.time()
    unet_dir, enc_dir = os.path.join(tmp, "arc2face", "arc2face"), os.path.join(tmp, "arc2face",
                                                                               "encoder")
    os.makedirs(unet_dir)
    os.makedirs(enc_dir)
    half = lambda sd: {k: v.half() for k, v in sd.items()}
    save_safetensors(diffusers_unet_state_dict(half(teacher_unet.state_dict()), pipe.unet.cfg),
                     os.path.join(unet_dir, "diffusion_pytorch_model.safetensors"))
    save_safetensors(hf_clip_text_state_dict(half(arc.state_dict()), arc.cfg.num_layers),
                     os.path.join(enc_dir, "model.safetensors"))
    say(f"[a2f-cli] teacher written as diffusers/HF fp16 safetensors in {time.time() - t0:.1f} s")
    cli_dir = os.path.join(tmp, "a2f_cli")
    argv = ["--base", os.path.join(CONFIG_DIR, "finetune-static-layerwise.yaml"), "--bf16",
            "--data_root", os.path.join(tmp, "a2f_cli_subject"), "--max_steps", "2",
            "--logdir", cli_dir, "--arc2face_unet", unet_dir, "--arc2face_text_encoder",
            enc_dir]
    before = dict(fa.launches_by_shape)
    t0 = time.time()
    with scripted_plans(trainer_mod, [k[0]() for k in a2f.values()]):
        rc = train_main(argv, dataset=make_dataset(os.path.join(tmp, "a2f_cli_subject")))
    torch.cuda.synchronize()
    got = launches_between(before, fa.launches_by_shape)
    want = {}
    for _, b, n_teacher, n_student in a2f.values():
        for kind, by in unet_flash_want(b, n_teacher, n_student).items():
            want.setdefault(kind, {}).update(by)
    recs = [json.loads(line) for line in open(os.path.join(cli_dir, "metrics.jsonl"))
            if '"loss"' in line]
    say(f"[a2f-cli] python -m adaface_tpu_torch.train --arc2face_unet (in-process, "
        f"finetune-static-layerwise.yaml --bf16, 2 micro-steps): rc {rc}, "
        f"{time.time() - t0:.1f} s with its setup, losses "
        f"{[(r['iter_type'], round(r['loss'], 6)) for r in recs]}, launches "
        f"{ {k: sorted(v.items()) for k, v in sorted(got.items())} } [{card}]")
    if (rc != 0 or [r["iter_type"] for r in recs] != ["arc2face_distill"] * 2
            or not all(np.isfinite(r["loss"]) for r in recs) or got != want):
        fail(f"[a2f-cli] the entry point did not distill from the loaded teacher (launches "
             f"want {want})")
    del teacher, teacher_unet, vision, arc, gens, zpipe
    torch.cuda.empty_cache()
    say(f"[zs-train] phase {time.time() - t_phase:.1f} s")
    return totals


def main():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device is visible to torch")
    try:
        from adaface_tpu_torch import kernels
        from adaface_tpu_torch.data.tokenizer import HashTokenizer
        from adaface_tpu_torch.pipeline import StableDiffusionPipeline
        from adaface_tpu_torch.training.trainer import Trainer
    except ImportError as e:
        fail(f"the port is not importable beside this script: {e}")
    fa = _fa()
    t_start = time.time()

    card, exp2_rate = phase_card(torch)
    phase_build(kernels)
    rows = phase_kernels(torch, fa, card, exp2_rate)
    bwd_rows = phase_backward_kernels(torch, fa, card, exp2_rate)
    # 4f: the compos step's shapes, without its (absent) key bias first
    compos_bwd_rows = phase_backward_kernels(torch, fa, card, exp2_rate, COMPOS_SHAPES,
                                             biases=(False, True))
    # [zs-train]'s multi-step Arc2Face iterations run them at batch 1: the
    # student with a key mask, the teacher without
    b1_bwd_rows = phase_backward_kernels(torch, fa, card, exp2_rate, ZS_B1_SHAPES)
    say("[b1-grid] CTAs a launch at batch 1 (the card has "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs; the forward with "
        "the student's key bias / the teacher's none): " + ", ".join(
            f"{kind} L{l} d{d} {flash_ctas(kind, b, l, h, d, bias=True)}"
            + (f" / {flash_ctas(kind, b, l, h, d)}" if kind == "fwd" else "")
            for kind, b, l, h, d in sorted(b1_bwd_rows)))
    arm_rows, arm_bwd_rows = phase_arm_kernels(torch, fa, card, exp2_rate)
    phase_backward_edges(torch, fa, card)
    fp32_rows = phase_fp32_kernels(torch, fa, card, exp2_rate)
    fused_rows = phase_fused_kernels(torch, card, exp2_rate)

    t0 = time.time()
    tok = HashTokenizer()
    pipe = StableDiffusionPipeline.from_random(0, tok, dtype=torch.bfloat16, device="cuda")
    tid = tok.add_placeholder("z")
    pipe.embedding_manager.add_placeholder(
        "z", token_id=tid, num_vectors=9, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(7))
    n_params = sum(p.numel() for m in (pipe.clip, pipe.unet, pipe.vae) for p in m.parameters())
    say(f"[main] SD-v1.5-width pipeline ({n_params / 1e6:.1f} M parameters with the VAE "
        f"encoder, bf16) built in {time.time() - t0:.1f} s")

    phase_reference(torch, pipe)
    counts, med, default_imgs = phase_main_path(torch, pipe, card)
    phase_upsample(torch, pipe, card)
    wino_rows, wino_launches = phase_winograd(torch, pipe, card)
    fp32_fused_rows, wino_fp32_launches = phase_fused_fp32_kernels(
        torch, card, exp2_rate, {k[1:]: n for k, n in wino_launches.items()})
    # before any profiler runs, so that the arms' requests are timed as the
    # default's were
    arm_counts = phase_arm_generate(torch, pipe, card, default_imgs, med)
    phase_profile(torch, pipe, card)
    gn_counts, ff_counts = phase_fused_main_path(torch, pipe, card, med)
    fa_fp32_gen, gn_fp32_gen, ff_fp32_gen = phase_fp32_main_path(torch, card)
    phase_zero_shot(torch, pipe, card)

    add_training_placeholders(torch, pipe)
    with tempfile.TemporaryDirectory() as tmp:
        # 8 and 8b gate the bf16 training arithmetic against fp32 on the
        # same weights, under the default Upsample and again under the
        # naive one; the fold's eps error may not exceed the naive path's
        # by more than FOLD_EPS_RATIO
        phase_fold_eps_ratio(torch, pipe, Trainer, tmp)
        train_counts, train_med, compos_med, train_peak = phase_train(torch, pipe, fa, Trainer,
                                                                      tmp, card)
        gn_train, ff_train = phase_fused_train(torch, pipe, Trainer, tmp, card, train_med,
                                               compos_med, train_peak)
        arm_train = phase_arm_train(torch, pipe, Trainer, tmp, card)
        fp32_counts, fp32_fused_train = phase_entry_point(torch, fa, Trainer, tmp, card)
        zs_counts = phase_zs_train(torch, pipe, Trainer, tmp, card)

    entries = []
    for (b, l, h, d), (replaces, _) in MAIN_SHAPES.items():
        entries.append(dict(name=f"flash_attn_packed B{b} L{l} H{h} d{d}", route="cuda",
                            source=SOURCE, replaces=replaces, launches=counts[(b, l, h, d)],
                            **rows[(b, l, h, d)]))
    names = {"fwd": ("flash_attn_packed fwd (lse when recorded)", SOURCE),
             "dq": ("flash_attn_bwd dq", BWD_SOURCE),
             "dkv": ("flash_attn_bwd dk/dv", BWD_SOURCE)}
    # launches over phase 9's micro-steps: B3 on the recon ones, B4 on the
    # compos ones
    for rows_, what in ((bwd_rows, "training"), (compos_bwd_rows, "compos training")):
        for (kind, b, l, h, d), row in rows_.items():
            name, source = names[kind]
            entries.append(dict(name=f"{name} B{b} L{l} H{h} d{d} ({what})", route="cuda",
                                source=source, launches=train_counts[(kind, b, l, h, d)],
                                **row))
    # batch 1: launches over [zs-train]'s zero-shot micro-steps
    for (kind, b, l, h, d), row in sorted(b1_bwd_rows.items()):
        name, source = names[kind]
        entries.append(dict(name=f"{name} B{b} L{l} H{h} d{d} (zero-shot training)",
                            route="cuda", source=source,
                            launches=zs_counts.get((kind, b, l, h, d), 0), **row))
    # the arms: launches per generate request under each arm configuration
    default = expected_generate_launches("default")
    for name, got in arm_counts.items():
        for (arm, b, lq, lk, h, d), n in sorted(got.items()):
            if (arm, b, lq, lk, h, d) in default:
                continue  # the default arm's launches, in the rows above
            row = arm_rows[(arm, b, lq, lk, h, d)]
            entries.append(dict(
                name=f"flash_attn_packed {arm} B{b} Lq{lq} Lk{lk} H{h} d{d}", route="cuda",
                source=SOURCE, replaces=ARM_REPLACES[arm], launches=n, **row))
    for (b, h, w, cin, cout), row in sorted(wino_rows.items()):
        entries.append(dict(name=f"winograd_conv3x3 B{b} {h}x{w} Cin{cin} Cout{cout}",
                            route="cuda", source=WINO_SOURCE, replaces=K10,
                            launches=wino_launches[("bf16", b, h, w, cin, cout)], **row))
    # the training arms: launches over their ARM_TRAIN_STEPS micro-steps
    bwd_names = {"fwd": "flash_attn_packed fwd + lse", "dq": "flash_attn_bwd dq",
                 "dkv": "flash_attn_bwd dk/dv"}
    for (kind, arm, b, lq, lk, h, d), row in sorted(arm_bwd_rows.items()):
        config = "K6" if (arm == "K6" or h == 1) else "K4 cross"
        fwd_arm = "K6" if config == "K6" else "K4"
        n = arm_train[config].get(kind, {}).get((arm, b, lq, lk, h, d), 0)
        entries.append(dict(
            name=f"{bwd_names[kind]} {fwd_arm} B{b} Lq{lq} Lk{lk} H{h} d{d} (training)",
            route="cuda", source=SOURCE if kind == "fwd" else BWD_SOURCE,
            replaces=ARM_REPLACES[arm] if kind == "fwd" else (K3B if kind == "dq" else K3C),
            launches=n, **row))
    # the fused configuration: launches per generate request, and over the
    # FUSED_TRAIN_STEPS timed micro-steps for the training shapes
    for kind, name, source, replaces, gen_counts, tr_counts in (
            ("gn", "gn_silu B{} N{} C{}", GN_SOURCE, K8, gn_counts, gn_train),
            ("ff", "ln_geglu_ff B{} L{} C{}", FF_SOURCE, K9, ff_counts, ff_train)):
        for (k, b, n, c), row in fused_rows.items():
            if k != kind:
                continue
            training = ("bf16", b, n, c) in tr_counts
            what = " (compos training)" if b == 4 else " (training)"
            entries.append(dict(
                name=name.format(b, n, c) + (what if training else ""),
                route="cuda", source=source, replaces=replaces,
                launches=(tr_counts if training else gen_counts)[("bf16", b, n, c)], **row))
    # the fp32 kernel: launches over phase 9d's fp32 run (B3 recon, B4
    # compos) for the training shapes, over [fp32-main]'s default request for
    # the generate ones
    fp32_names = {"fwd": "flash_attn_fp32 fwd (lse when recorded)", "dq": "flash_attn_fp32 dq",
                  "dkv": "flash_attn_fp32 dk/dv"}
    for (kind, b, l, h, d), row in sorted(fp32_rows.items()):
        if (b, l, h, d) in FP32_TRAIN_SHAPES:
            what = "fp32 compos training" if (b, l, h, d) in COMPOS_SHAPES else "fp32 training"
            n = fp32_counts.get((FP32_KINDS[kind], b, l, h, d), 0)
        else:
            what, n = "fp32 request", fa_fp32_gen.get((b, l, h, d), 0)
        entries.append(dict(name=f"{fp32_names[kind]} B{b} L{l} H{h} d{d} ({what})",
                            route="cuda", source=FP32_SOURCE, launches=n, **row))
    # the fp32 instances of K8 and K9: launches over phase 9e's micro-steps
    # for the training shapes (B3 recon, B4 compos), over the fused fp32
    # request for the generate ones; K10 over 4h's conv3x3_same drive
    for kind, name, source, replaces, gen_counts, tr_counts in (
            ("gn", "gn_silu fp32 B{} N{} C{}", GN_SOURCE, K8, gn_fp32_gen,
             fp32_fused_train["gn"]),
            ("ff", "ln_geglu_ff_fp32 B{} L{} C{}", FF_FP32_SOURCE, K9, ff_fp32_gen,
             fp32_fused_train["ff"])):
        for key, row in fp32_fused_rows.items():
            if key[0] != kind:
                continue
            _, b, n, c = key
            training = ("fp32", b, n, c) in tr_counts
            what = " (fp32 compos training)" if b == 4 else " (fp32 training)"
            entries.append(dict(
                name=name.format(b, n, c) + (what if training else " (fp32 request)"),
                route="cuda", source=source, replaces=replaces,
                launches=(tr_counts if training else gen_counts)[("fp32", b, n, c)], **row))
    # (the shapes that the fp32 gate sends to the direct conv launch no
    # kernel there; their 4h times are printed above)
    for (k, *key), row in sorted(fp32_fused_rows.items()):
        if k == "wino" and ("fp32", *key) in wino_fp32_launches:
            b, h, w, cin, cout = key
            entries.append(dict(
                name=f"winograd_conv3x3_fp32 B{b} {h}x{w} Cin{cin} Cout{cout}", route="cuda",
                source=WINO_FP32_SOURCE, replaces=K10,
                launches=wino_fp32_launches[("fp32", *key)], **row))
    say(f"[main] whole script {time.time() - t_start:.1f} s")
    say(json.dumps({"kernels": entries}))
    say(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
