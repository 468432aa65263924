"""Image-to-image and inpainting CLI of the port (counterpart of
`scripts/img2img.py`):

    python -m adaface_tpu_torch.img2img --init_img in.png --prompt "a z person" \\
        [--mask mask.png] [--strength 0.75] [--ckpt sd-v1-5.ckpt] [--bf16]

Without `--mask`: `StableDiffusionPipeline.img2img` (the init image's
latent noised to t = strength * steps, then DDIM from there at a fixed
guidance scale). With `--mask` (white = repaint): `inpaint`, masked latent
blending on an ordinary SD model. The backbone, embeddings and devices are
`txt2img.build_pipeline`'s (`--device cpu` for the CPU; `--num_devices` /
`--tp` serve over a dp x tp mesh by `txt2img`'s rules, rank 0 writing);
images are read by `txt2img.load_resized` (PNGs and JPEGs by the port's
decoders, another size than `--size` by `data/resample.py`'s bicubic, other
formats through PIL) and written as PNGs by the port's codec.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from adaface_tpu_torch import txt2img as t2i
from adaface_tpu_torch.data import png
from adaface_tpu_torch.parallel import mesh as pmesh


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--init_img", required=True)
    p.add_argument("--prompt", required=True)
    p.add_argument("--mask", default=None, help="white = repaint region (inpainting mode)")
    p.add_argument("--strength", type=float, default=0.75)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--n_samples", type=int, default=2)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scale", type=float, nargs="+", default=[7.5])
    p.add_argument("--ckpt", default=None)
    p.add_argument("--embedding_paths", nargs="*", default=[])
    p.add_argument("--subject_string", default="z")
    p.add_argument("--num_vectors_per_subj_token", type=int, default=9)
    p.add_argument("--out", dest="outdir", default="outputs/img2img")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--num_devices", type=int, default=1,
                   help="ranks to serve on, one card each (-1 = all cards)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks of the UNet (alone: a tp-only mesh)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card)")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None, *, device=None, opt=None) -> int:
    """img2img, or inpainting with `--mask`. `device` overrides `--device`;
    `opt` takes already parsed options."""
    opt = opt if opt is not None else parse_args(argv)
    ranks = t2i.run_ranks(main, opt, device, kwargs={"opt": opt})
    if ranks is not None:
        return ranks
    pipe, _ = t2i.build_pipeline(opt, device)
    init = t2i.load_resized(opt.init_img, opt.size)
    k = max((i.num_vectors for i in pipe.embedding_manager.placeholders.values()), default=1)
    prompt = t2i.pad_placeholders(opt.prompt, opt.subject_string, k)
    guidance = tuple(opt.scale) if len(opt.scale) > 1 else opt.scale[0]
    if opt.mask:
        mask = t2i.load_resized(opt.mask, opt.size, "L") / 255.0
        imgs = inpaint(pipe, init, mask, [prompt] * opt.n_samples, num_steps=opt.steps,
                       guidance_scale=guidance, seed=opt.seed)
    else:
        imgs = pipe.img2img(init, [prompt] * opt.n_samples, strength=opt.strength,
                            num_steps=opt.steps, guidance_scale=guidance, seed=opt.seed)
    if not pmesh.is_main(pipe.mesh):  # rank 0 writes
        return 0
    os.makedirs(opt.outdir, exist_ok=True)
    for i, im in enumerate(imgs):
        png.write(os.path.join(opt.outdir, f"{i:05}.png"), im)
    print(f"wrote {len(imgs)} images to {opt.outdir}")
    return 0


def resize_nearest_jax(m: np.ndarray, n: int) -> np.ndarray:
    """[H, W] -> [n, n] nearest samples, as `jax.image.resize(..., "nearest")`."""
    return m[t2i.nearest_indices(n, m.shape[0])][:, t2i.nearest_indices(n, m.shape[1])]


@torch.inference_mode()
def inpaint(pipe, init_image: np.ndarray, mask: np.ndarray, prompts: Sequence[str],
            num_steps: int = 50, guidance_scale=7.5, seed: int = 0,
            x_T: Optional[np.ndarray] = None, blend_noise: Optional[np.ndarray] = None
            ) -> np.ndarray:
    """Masked latent blending (the JAX script's `inpaint`): uint8 [B, H, W, 3]
    from `init_image` [H, W, 3] uint8 and `mask` [H, W] in [0, 1], 1 =
    repaint (the reverse of `ddim_sample`'s mask, 1 = keep). The empty
    negative prompt; DDIM from x_T (a draw from a torch.Generator seeded with
    `seed`, or `x_T`) with annealed guidance; after each step the region
    outside the latent-resolution mask is reset to the init latent noised to
    the step's a_prev by ONE fixed draw (`blend_noise`, else a draw from a
    torch.Generator seeded with 0, as JAX draws it from PRNGKey(0)), the
    same at every step. Under the pipeline's mesh both draws are made for
    the whole batch and each dp rank denoises its rows; every rank returns
    the whole gathered batch."""
    from adaface_tpu_torch.models.vae import SD_VAE_SCALE_FACTOR
    from adaface_tpu_torch.ops.schedule import make_ddim_schedule
    from adaface_tpu_torch.samplers.ddim import ddim_step

    dev = pipe.device
    b_all = len(prompts)
    rows = pipe._rows(b_all)
    if rows is not None:
        prompts = [prompts[i] for i in rows]
    b = len(prompts)
    ids = pipe.tokenizer(list(prompts))
    ctx_c = pipe.encode_prompts(prompts)
    ctx_u = pipe.encode_negative("", b)
    eps_fn = pipe._cfg_eps_fn(ctx_c, ctx_u, pipe._cfg_slot_map(ids))
    sched = make_ddim_schedule(pipe.base_sched, num_steps, guidance_scale=guidance_scale)
    f = 2 ** (len(pipe.vae.cfg.ch_mult) - 1)
    lh = init_image.shape[0] // f
    x = torch.as_tensor(np.asarray(init_image), device=dev).float() / 127.5 - 1.0
    mean, _ = pipe.vae.encode(x[None])
    z0 = (mean * SD_VAE_SCALE_FACTOR).float().expand((b,) + tuple(mean.shape[1:]))
    ml = resize_nearest_jax(np.asarray(mask, np.float32), lh)
    ml = torch.as_tensor(ml, device=dev)[None, :, :, None].expand(b, lh, lh, 1)

    def draw(given, s):
        if given is not None:
            out = torch.as_tensor(np.array(given, np.float32), device=dev)
        else:
            gen = torch.Generator(device=dev).manual_seed(s)
            out = torch.randn((b_all,) + tuple(z0.shape[1:]), generator=gen, device=dev)
        return out if rows is None else out[torch.as_tensor(rows, device=dev)]

    x = draw(x_T, seed)
    noise = draw(blend_noise, 0)
    f32 = np.float32
    for i in range(len(sched.timesteps)):
        t = torch.full((b,), int(sched.timesteps[i]), dtype=torch.int32, device=dev)
        eps = eps_fn(x, t, float(sched.guidance_scales[i]))
        x, _ = ddim_step(x, eps, sched.alphas[i], sched.alphas_prev[i],
                         sched.sqrt_one_minus_alphas[i], sched.sigmas[i])
        a_prev = f32(sched.alphas_prev[i])
        z0_noised = (float(np.sqrt(a_prev)) * z0
                     + float(np.sqrt(f32(1) - a_prev)) * noise)
        x = ml * x + (1 - ml) * z0_noised
    return pipe._gather_images(pipe._decode_uint8(x), b_all)


if __name__ == "__main__":
    sys.exit(main())
