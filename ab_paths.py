#!/usr/bin/env python3
"""Time the port's generate request and its recon and compos micro-steps of
one tree, so that two trees can be compared on one card.

    python3 ab_paths.py [--fp32] [ROOT]

imports `adaface_tpu_torch` from ROOT (default: this checkout; another tree
is unpacked with `git archive <commit> | tar -x -C _checkout`), builds its
kernels, and at SD-v1.5 width in bf16 (fp32 with `--fp32`: the fp32 flash,
whose backward runs on every fp32 micro-step) with random weights times:

- `generate`: one warm-up and GENERATE_REQUESTS requests of batch 8,
  512x512, DDIM-50, CFG 10->4 (chip_smoke.py's phase 6); with `--fp32`,
  FP32_GENERATE_REQUESTS requests of DDIM-10 (chip_smoke.py's
  FP32_REQUEST_STEPS, as `[fp32-main]` runs them);
- `Trainer.fit`, recon-only (`composition_regs_iter_gap` 0): TRAIN_STEPS
  micro-steps at batch 3, 512x512 (chip_smoke.py's phase 9 otherwise), the
  first left out of the median;
- `Trainer.fit` at the shipped gap 3 (trees from slice 12 on):
  COMPOS_TRAIN_STEPS micro-steps, the median of the compos ones (3 and 6)
  after the first.

The seeded dataset and the placeholders are this checkout's
`chip_smoke.py` helpers; the trainer's values are
`configs/finetune-static-layerwise.yaml`'s, written in (an older tree has
no YAML reader). Prints the card and one JSON line with the medians. Run
trees in turns in one call (parent, change, change, parent): two calls may
land on two cards.
"""

import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

GENERATE_REQUESTS = 3
FP32_GENERATE_REQUESTS = 2
TRAIN_STEPS = 6
COMPOS_TRAIN_STEPS = 7  # compos at 0, 3, 6


def train_configs(logdir, steps, gap):
    """`configs/finetune-static-layerwise.yaml`'s trainer and iter_plan
    values (as chip_smoke.py's `train_configs` reads them), in the tree's
    own config classes."""
    from adaface_tpu_torch.training.iter_plan import IterPlanConfig
    from adaface_tpu_torch.training.trainer import TrainerConfig

    return (TrainerConfig(batch_size=3, accumulate_grad_batches=2, grad_clip=0.5, d_coef=10.0,
                          max_steps=steps, log_every_steps=10 ** 6, ckpt_every_steps=10 ** 6,
                          logdir=logdir),
            IterPlanConfig(composition_regs_iter_gap=gap, do_zero_shot=False,
                           prompt_emb_delta_reg_weight=2e-4, mix_prompt_distill_weight=2e-4,
                           arc2face_distill_iter_prob=0.0))


def main():
    args = [a for a in sys.argv[1:] if a != "--fp32"]
    fp32 = len(args) < len(sys.argv) - 1
    root = Path(args[0] if args else Path(__file__).parent).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        sys.exit("ab_paths: no CUDA device is visible to torch")
    spec = importlib.util.spec_from_file_location(
        "smoke_helpers", Path(__file__).resolve().with_name("chip_smoke.py"))
    helpers = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(helpers)
    from adaface_tpu_torch import kernels
    from adaface_tpu_torch.data.tokenizer import HashTokenizer
    from adaface_tpu_torch.pipeline import StableDiffusionPipeline
    from adaface_tpu_torch.training.trainer import Trainer

    if not kernels.__file__.startswith(str(root)):
        sys.exit(f"ab_paths: imported {kernels.__file__}, not the package under {root}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.splitlines()[0].strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    kernels.build_all()
    build_s = time.time() - t0

    tok = HashTokenizer()
    dtype = torch.float32 if fp32 else torch.bfloat16
    pipe = StableDiffusionPipeline.from_random(0, tok, dtype=dtype, device="cuda")
    tid = tok.add_placeholder("z")
    pipe.embedding_manager.add_placeholder(
        "z", token_id=tid, num_vectors=9, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(7))
    prompts = [helpers.PROMPT] * helpers.BATCH
    kw = dict(num_steps=helpers.FP32_REQUEST_STEPS if fp32 else helpers.STEPS,
              guidance_scale=(10.0, 4.0), height=helpers.SIZE, width=helpers.SIZE)
    pipe.generate(prompts, seed=0, **kw)
    gen_s = []
    for i in range(FP32_GENERATE_REQUESTS if fp32 else GENERATE_REQUESTS):
        torch.cuda.synchronize()
        t0 = time.time()
        pipe.generate(prompts, seed=1 + i, **kw)
        torch.cuda.synchronize()
        gen_s.append(time.time() - t0)

    helpers.add_training_placeholders(torch, pipe)
    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, steps, gap in (("recon", TRAIN_STEPS, 0), ("gap3", COMPOS_TRAIN_STEPS, 3)):
            ds_dir = os.path.join(tmp, f"subject_{name}")
            os.makedirs(ds_dir)
            tcfg, pcfg = train_configs(os.path.join(tmp, name), steps, gap)
            trainer = Trainer(pipe, helpers.make_dataset(ds_dir), tcfg, pcfg)
            times[name] = []
            for i in range(steps):
                torch.cuda.synchronize()
                t0 = time.time()
                trainer.fit(i + 1)
                torch.cuda.synchronize()
                times[name].append(time.time() - t0)
            trainer.close()
    train_s, gap3_s = times["recon"], times["gap3"]
    compos_s = [t for i, t in enumerate(gap3_s) if i % 3 == 0]
    print(f"[ab] {root} {'fp32' if fp32 else 'bf16'}: build {build_s:.1f} s; generate "
          f"{gen_s}; recon micro-steps {train_s}; gap-3 micro-steps {gap3_s} [{card}]",
          flush=True)
    print(json.dumps({"root": str(root), "card": card, "dtype": "fp32" if fp32 else "bf16",
                      "generate_median_s": statistics.median(gen_s),
                      "recon_micro_step_median_s": statistics.median(train_s[1:]),
                      "compos_micro_step_median_s": statistics.median(compos_s[1:])}),
          flush=True)


if __name__ == "__main__":
    main()
