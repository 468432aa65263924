#!/usr/bin/env python3
"""Which bf16 rounding of the Upsample moves chip_smoke.py phase 8's recon
loss: the recon loss (forward only) of the bf16 SD-width pipeline with
random weights from seed 0, at phase 8's batch (one 32x32 latent), under
Upsample variants, against fp32 copies of CLIP and the UNet on the card
(TF32 off) under reference variants; the same weights and batch throughout.

    python3 upsample_probe.py

Run from the root of a checkout on a machine with a CUDA card. bf16
variants: the naive path (bias in the conv), the naive path with the bias
added after the conv's rounding (JAX's flax conv), the fold (bias after
the rounding, JAX's default) and the fold with the bias in the conv. fp32
references: the naive function; the fold with its taps summed in bf16; the
whole Upsample (fold, or naive with the bias after) computed in bf16
inside the fp32 model. Prints each loss and each bf16 variant's relative
error against each reference, with the card's name and power limit.
"""

import dataclasses
import os
import sys
import tempfile

import chip_smoke as cs


def main():
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        cs.fail("no CUDA device is visible to torch")
    from adaface_tpu_torch.data.tokenizer import HashTokenizer
    from adaface_tpu_torch.models import unet as unet_mod
    from adaface_tpu_torch.ops import subpixel
    from adaface_tpu_torch.personalization.static_embedding import embedder_leaves
    from adaface_tpu_torch.pipeline import StableDiffusionPipeline
    from adaface_tpu_torch.training.iter_plan import IterPlan
    from adaface_tpu_torch.training.train_step import make_recon_train_step
    from adaface_tpu_torch.training.trainer import Trainer

    card, _ = cs.phase_card(torch)
    tok = HashTokenizer()
    pipe = StableDiffusionPipeline.from_random(0, tok, dtype=torch.bfloat16, device="cuda")
    tid = tok.add_placeholder("z")
    pipe.embedding_manager.add_placeholder(
        "z", token_id=tid, num_vectors=9, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(7))
    cs.add_training_placeholders(torch, pipe)

    def naive_bias_after(x, w, b):
        up = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
        return F.conv2d(up, w, None, padding=1).permute(0, 2, 3, 1) + b.to(x.dtype)

    def fold_bias_in(x, w, b):
        bh, h, wd, _ = x.shape
        y = F.conv2d(x.permute(0, 3, 1, 2), subpixel.phase_kernels(w).to(x.dtype),
                     b.to(x.dtype).repeat(4), padding=1).permute(0, 2, 3, 1)
        return y.unflatten(3, (2, 2, -1)).permute(0, 1, 3, 2, 4, 5).reshape(bh, 2 * h, 2 * wd, -1)

    def in_bf16(f):
        return lambda x, w, b: f(x.bfloat16(), w.bfloat16(), b.bfloat16()).to(x.dtype)

    variants = {"naive (bias in conv)": subpixel.nearest_upsample2x_conv_reference,
                "naive, bias after rounding": naive_bias_after,
                "fold (bias after rounding)": subpixel.upsample2x_conv,
                "fold, bias in conv": fold_bias_in}
    refs = {"fp32 naive": subpixel.nearest_upsample2x_conv_reference,
            "fp32, taps folded in bf16":
                lambda x, w, b: subpixel.upsample2x_conv(x, w.bfloat16(), b),
            "fp32, Upsample fold in bf16": in_bf16(subpixel.upsample2x_conv),
            "fp32, Upsample naive-bias-after in bf16": in_bf16(naive_bias_after)}

    def fp32_copy(m):
        with torch.device("meta"):
            c = type(m)(m.cfg)
        c = c.to_empty(device="cuda")
        c.load_state_dict({k: v.float() for k, v in m.state_dict().items()})
        return c.eval().requires_grad_(False)

    losses = {}
    with tempfile.TemporaryDirectory() as tmp:
        tcfg, pcfg = cs.train_configs(os.path.join(tmp, "logs"))
        tcfg = dataclasses.replace(tcfg, batch_size=1)
        os.makedirs(os.path.join(tmp, "subject"))
        trainer = Trainer(pipe, cs.make_dataset(os.path.join(tmp, "subject"), size=256), tcfg,
                          pcfg)
        batch = trainer.build_recon_batch(IterPlan(use_background_token=True))
        step = trainer._get_recon_step(True)
        ref_step = make_recon_train_step(
            fp32_copy(pipe.clip), fp32_copy(pipe.unet), pipe.base_sched, None,
            skip_weights=pipe.skip_weights, bg_weight=tcfg.bg_recon_weight,
            emb_reg_weight=trainer._emb_reg_w, prompt_delta_weight=trainer._delta_w,
            complem_weight=tcfg.fg_bg_complementary_loss_weight,
            xlayer_weight=tcfg.fg_bg_xlayer_consist_loss_weight, use_bg_token=True,
            do_zero_shot=False, bg_placeholders=frozenset({"y"}))
        emb = {s: dataclasses.replace(p, **{n: t.detach().float().clone()
                                            for n, t in embedder_leaves(p)})
               for s, p in pipe.embedding_manager.embedders.items()}
        plain = unet_mod.upsample_conv
        try:
            with torch.no_grad():
                for table, st in ((variants, step), (refs, ref_step)):
                    for name, f in table.items():
                        unet_mod.upsample_conv = f
                        losses[name] = st.loss_fn(emb, batch)[0].item()
                        cs.say(f"[probe] {name}: recon loss {losses[name]:.7e}")
        finally:
            unet_mod.upsample_conv = plain
            trainer.close()
    for r in refs:
        for v in variants:
            cs.say(f"[probe] {v} vs {r}: relative error "
                   f"{abs(losses[v] - losses[r]) / abs(losses[r]):.3e} [{card}]")


if __name__ == "__main__":
    sys.exit(main())
