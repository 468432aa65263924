"""`ADAFACE_*` environment knobs (counterpart of `adaface_tpu/knobs.py`).

The port gives the JAX package's knobs the same names and meanings, and reads
them live, at call time, so a process can flip a knob between two calls.
Each is compared exactly as the JAX call site compares it.

GroupNorm (`ops/basic.py`, `group_norm`; the UNet's and the VAE's norms and
the fused kernel's fallback):

- `ADAFACE_GN_SHIFT` ("1" to enable): one-pass statistics of x minus a
  per-group probe (the group mean of the first spatial position, no
  gradient), accurate under a large common-mode offset. The fused
  GroupNorm+SiLU kernel keeps the raw form, as JAX's Pallas kernel does.

Sampling (`pipeline.generate`), each read per call, "0" to turn off:

- `ADAFACE_CFG_DEDUP`: the CFG stem runs once at batch B and is tiled before
  the first cross-attention (only where level 0 has attention); off, the
  UNet runs at batch 2B.
- `ADAFACE_CROSS_KV`: the loop-invariant cross-attention K/V projections
  are computed once per request, not once per step.

Fused UNet configuration:

- `ADAFACE_GN_MAX_ELEMS` (default 0): the largest per-image `N * C` slab that
  `ops.fused_norm.group_norm_silu` hands to the fused GroupNorm+SiLU kernel;
  0 keeps every site on the plain GroupNorm then SiLU.
- `ADAFACE_FUSED_FF` ("1" to enable): the UNet's non-capturing transformer
  blocks run `ops.fused_ff.ln_geglu_ff`, the fused LayerNorm + GEGLU
  feed-forward + residual kernel.

Attention routing in the UNet (`models/unet.py`, `UNetCrossAttention`):

- `ADAFACE_FLASH_MIN_LK` (default 0): attentions with fewer keys take the
  module's einsum path.
- `ADAFACE_FLASH_PACKED_MIN_L` (default 256) and `ADAFACE_FLASH_PACKED`
  ("0" to disable): attentions at Lq at least that long take the packed
  entry `flash_attention_blc`, the others the `[B, H, L, D]` entry
  `flash_attention`.

Kernel arms of the packed entry (`ops/flash_attention.py`, `forward_arm`):

- `ADAFACE_FLASH_CROSS=1`: Lk < 256 (cross-attention) goes to the kernel,
  keys padded to a multiple of 128 with a -1e30 bias, instead of the
  einsum path.
- `ADAFACE_FLASH_MAXFREE=0` (K5), `ADAFACE_FLASH_PVT=0` (K5),
  `ADAFACE_FLASH_PVT2` ("1": K2; unset: K2 at Lq <= 256), and
  `ADAFACE_FLASH_SHORT=0` (no K4 for Lk <= 256) pick the TPU kernel id
  counted; on the card all run `csrc/flash_attn_packed.cu`.
- `ADAFACE_FLASH_EXP_BF16=1` and `ADAFACE_FLASH_MXU_SUM=1`, under K1 only:
  scores rounded to bf16 before exp2, and the denominator summed from bf16
  probabilities; they change the kernel's arithmetic.

The `[B, H, L, D]` entry (`flash_attention`, `bhld_arm`):

- `ADAFACE_FLASH_MODE=row`: K7 where Lk <= 4096 and Lq % min(256, Lq) ==
  0, else K6; both one-head calls of the same kernel.
- `ADAFACE_FLASH_HOST_PAD=1`: in JAX, the head dim zero-padded to a
  multiple of 128 (a TPU lane layout); the same function, so the port runs
  the unpadded kernel under it.

Both entries: `ADAFACE_FLASH_BWD=einsum` differentiates the einsum
reference instead of running the backward kernels.

Upsample (`ops/subpixel.py`, `upsample_conv`; the UNet's and the VAE's):
`ADAFACE_SUBPIXEL_UP` ("0": nearest 2x upsample, then the 3x3 conv; unset
or anything else: JAX's phase fold, taps that hit one source pixel summed
in the compute dtype first, which in bf16 rounds them and so differs from
the naive function).

Winograd conv (`ops/winograd.py`, `winograd_eligible`): `ADAFACE_WINOGRAD`
("0" default, "1" or "auto"), `ADAFACE_WINOGRAD_MIN_TILES` (default 256) and
`ADAFACE_WINOGRAD_VMEM` (default 72 MiB).

JAX knobs that the port reads as the same function and ignores on purpose
(each changes only how XLA or the TPU schedules the work):
`ADAFACE_GN_BARRIER` (an optimisation barrier before the GroupNorm stats),
`ADAFACE_PROJ_DENSE` (1x1 projections
as dense products), `ADAFACE_FLASH_SEMANTICS` (the TPU grid's dimension
semantics), `ADAFACE_FLASH_PACKED_{BQ,BK,UNROLL}` (the TPU kernel's tiles
and unroll), and the compiled-program caches (`ADAFACE_AOT_CACHE`,
`ADAFACE_AOT_CACHE_FORCE`, `ADAFACE_COMPILE_CACHE`).
The port keeps no compiled-program cache, so it needs no `fingerprint()`.
"""

from __future__ import annotations

import os


def get(name: str, default=None):
    """Raw environment read, compared exactly as the JAX call sites do."""
    return os.environ.get(name, default)


def flag(name: str, default: bool = False) -> bool:
    """Boolean knob: unset -> default; "0", "" and "false" -> False; else True."""
    v = os.environ.get(name)
    if v is None:
        return default
    return v not in ("0", "", "false", "False")


def intval(name: str, default) -> int:
    return int(os.environ.get(name, default))
