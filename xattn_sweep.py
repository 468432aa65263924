"""Cross-attention scale sweep for chip_smoke's [img2img] / [inpaint] gates.

Run on the card from the root of a checkout: `python3 xattn_sweep.py`. For
each cross-attention scale (to_q and to_k times qk, to_v and to_out times vo)
of a random SD v1.5-width bf16 pipeline ([main]'s weights, seed 0, a static
9-vector z with conv attention at kernel size 2 from a reference-format
`.pt`), it runs img2img (strength 0.75) and inpaint at 512x512, batch 2,
DDIM-50, in bf16 and on an fp32 copy on the card (einsum attention, TF32
off), and prints the relative L2 error of the bf16 images against the fp32
copy's, and of each planted fault (strength 1.0, the mask inverted, conv
attention off), and conv attention off in fp32 alone. chip_smoke's
I2I_XATTN_SCALE and I2I_REL_TOL come from its readings.
"""

import dataclasses
import os
import shutil
import tempfile
import time

import torch

import chip_smoke as cs
from adaface_tpu_torch import img2img, kernels
from adaface_tpu_torch.data.tokenizer import HashTokenizer
from adaface_tpu_torch.pipeline import StableDiffusionPipeline

t_start = time.time()
card, _ = cs.phase_card(torch)
kernels.build_all()
tok = HashTokenizer()
pipe = StableDiffusionPipeline.from_random(0, tok, dtype=torch.bfloat16, device="cuda")
pipe.embedding_manager.add_placeholder("z", token_id=tok.add_placeholder("z"), num_vectors=9,
                                       device="cuda",
                                       generator=torch.Generator(device="cuda").manual_seed(7))
z = pipe.embedding_manager.embedders["z"]
folder = tempfile.mkdtemp()
pt = os.path.join(folder, "e.pt")
cs.write_reference_pt(torch, pt, statics={"z": {f: getattr(z, f) for f in (
    "basis_rand_weights", "basis_comm_weights", "basis_vecs", "pre_vecs", "bias")
    if getattr(z, f) is not None}}, token2num={"z": 9}, conv_ks=2)
(_, _), init, mask = cs.i2i_inputs(folder)
prompts = [cs.SERVE_PADDED] * 2
kw = dict(num_steps=50, guidance_scale=7.5, seed=4)


def module(m, dtype, scale=None, **cfg):
    with torch.device("meta"):
        c = type(m)(dataclasses.replace(m.cfg, **cfg))
    c = c.to_empty(device="cuda").to(dtype)
    sd = {}
    for k, v in m.state_dict().items():
        if scale is not None and ".attn2." in k:
            s = scale[0] if (".to_q." in k or ".to_k." in k) else scale[1]
            v = (v.float() * s).to(torch.bfloat16)
        sd[k] = v
    c.load_state_dict(sd)
    return c.to(memory_format=torch.channels_last).eval()


clip32, vae32 = module(pipe.clip, torch.float32), module(pipe.vae, torch.float32)
t = lambda a: torch.as_tensor(a).float()
for qk, vo in [(1, 1), (1, 3), (3, 1), (2, 2), (3, 3), (1, 10), (10, 10)]:
    t0 = time.time()
    runs = {}
    for name, dtype, clip, vae, flash in (("bf16", torch.bfloat16, pipe.clip, pipe.vae, True),
                                          ("fp32", torch.float32, clip32, vae32, False)):
        ptok = HashTokenizer()
        p = StableDiffusionPipeline(ptok, clip, module(pipe.unet, dtype, (qk, vo),
                                                       use_flash_attention=flash), vae)
        p.embedding_manager.load_reference_checkpoint(pt, token_id_resolver=ptok.add_placeholder,
                                                      device="cuda")
        p.set_conv_attn_kernel_size(2)
        runs[name, "i2i"] = p.img2img(init, prompts, strength=0.75, **kw)
        runs[name, "inp"] = img2img.inpaint(p, init, mask, prompts, **kw)
        if name == "bf16":
            runs[name, "i2i strength"] = p.img2img(init, prompts, strength=1.0, **kw)
            runs[name, "inp inverted"] = img2img.inpaint(p, init, 1.0 - mask, prompts, **kw)
        p.set_conv_attn_kernel_size(-1)
        runs[name, "i2i conv off"] = p.img2img(init, prompts, strength=0.75, **kw)
        runs[name, "inp conv off"] = img2img.inpaint(p, init, mask, prompts, **kw)
        del p
        torch.cuda.empty_cache()
    e = {k[1] if k[0] == "bf16" else "fp32 " + k[1]:
         cs.rel_err(t(v), t(runs["fp32", k[1].split(" ")[0]])) for k, v in runs.items()
         if k != ("fp32", "i2i") and k != ("fp32", "inp")}
    cs.say(f"[sweep] qk {qk} vo {vo}: " + ", ".join(f"{k} {v:.4e}" for k, v in e.items())
           + f" ({time.time() - t0:.1f} s) [{card}]")
shutil.rmtree(folder)
cs.say(f"[sweep] total {time.time() - t_start:.1f} s")
print('{"ok": true}')
