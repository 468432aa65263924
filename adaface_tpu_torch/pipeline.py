"""End-to-end subject-driven generation (counterpart of
`adaface_tpu/pipeline.py`): tokenize -> patch placeholder embeddings (static
embedders, or zero-shot generators fed by `set_zero_shot_features`) ->
CLIP-encode the 16-layer prompt batch -> DDIM with annealed CFG, or PLMS at
a fixed scale (stem dedup, hoisted cross-attention K/V, subject conv
attention) -> VAE decode -> uint8. `img2img` encodes an image, noises it to
t = strength * steps and decodes from there.

`from_sd_checkpoint` builds the pipeline from an SD v1.x `.ckpt` or
`.safetensors` (LDM names, `interop/sd_unet.py`, `interop/sd_vae.py`,
`interop/hf_clip.py`), with fresh placeholder rows in the CLIP table.

`use_mesh(n_devices, dp, tp)` serves over a dp x tp mesh of ranks (JAX's
`use_mesh`; `parallel/mesh.py`): each request's batch is split over dp (a
batch that dp does not divide runs whole on every rank, as JAX then runs it
unsharded), the UNet is tensor-parallel over tp (`models/unet.shard_unet_tp`),
CLIP, the VAE and the embedders stay replicated.

The JAX package compiles each path into one program; here it runs eagerly on
the pipeline's device. The initial noise and img2img's encode noise come
from a torch.Generator seeded with `seed` (JAX draws them with
`jax.random`: the law is the same, the numbers are not), or from `x_T` /
`noise` when given.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from adaface_tpu_torch import knobs
from adaface_tpu_torch.data.tokenizer import TokenizerBase
from adaface_tpu_torch.device import resolve_device
from adaface_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
from adaface_tpu_torch.models.unet import (
    NUM_CA_LAYERS, UNetConfig, UNetModel, precompute_cross_kv)
from adaface_tpu_torch.models.vae import SD_VAE_SCALE_FACTOR, AutoencoderKL, VAEConfig
from adaface_tpu_torch.ops.compel import apply_compel_cfg
from adaface_tpu_torch.ops.schedule import (
    DiffusionSchedule, make_ddim_schedule, make_diffusion_schedule)
from adaface_tpu_torch.personalization.embedding_manager import EmbeddingManager
from adaface_tpu_torch.samplers.ddim import (
    ddim_decode, ddim_sample, make_cfg_eps_fn, stochastic_encode)
from adaface_tpu_torch.samplers.plms import plms_sample

# The reference's predefined negative prompt (`stable_txt2img.py:349-352`).
DEFAULT_NEGATIVE_PROMPT = (
    "duplicate faces, deformed, distorted, disfigured, poorly drawn, bad anatomy, "
    "wrong anatomy, extra limb, missing limb, floating limbs, mutated hands and "
    "fingers, disconnected limbs, mutation, mutated, ugly, disgusting, amputation"
)


# a zero-shot generator's own initializers: N(0, 1) pos_embs and latent
# queries, last-3-hidden-state weights [1, 2, 4]
_UNIT_NORMAL_PARAMS = ("pos_embs", "latent_queries")


def init_random_(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's random init: norm scales at 1, every other weight
    and bias randn * 0.02 (the generators' own leaves as their flax
    initializers make them). No zero-initialized output convs (a random UNet
    would then be context-blind, eps == 0) and no torch default inits."""
    with torch.no_grad():
        for mod_name, mod in module.named_modules():
            for name, p in mod.named_parameters(recurse=False):
                if name.endswith("scale") or (isinstance(mod, nn.LayerNorm)
                                              and name == "weight"):
                    p.fill_(1.0)
                elif name == "hidden_state_layer_weights":
                    p.copy_(torch.tensor([[1.0], [2.0], [4.0]]))
                else:
                    std = 1.0 if name in _UNIT_NORMAL_PARAMS else 0.02
                    p.copy_(std * torch.randn(p.shape, generator=generator,
                                              device=p.device))


def build_random(build, seed: int, device=None, dtype: torch.dtype = torch.float32
                 ) -> nn.Module:
    """`build()` made on `device` (the CUDA card unless `device="cpu"`) with
    `init_random_` weights drawn from `seed`, cast to `dtype`, in eval mode."""
    dev = resolve_device(device)
    with torch.device("meta"):
        m = build()
    m = m.to_empty(device=dev)
    init_random_(m, torch.Generator(device=dev).manual_seed(seed))
    return m.to(dtype).eval()


def build_loaded(build, state_dict, device: torch.device) -> nn.Module:
    """`build()` made on `device` with `state_dict` loaded strictly (in the
    module's dtype), in eval mode."""
    with torch.device("meta"):
        m = build()
    m = m.to_empty(device=device)
    m.load_state_dict(state_dict, strict=True)
    return m.eval()


class StableDiffusionPipeline:
    def __init__(self, tokenizer: TokenizerBase, clip: CLIPTextEncoder,
                 unet: UNetModel, vae: AutoencoderKL,
                 embedding_manager: Optional[EmbeddingManager] = None,
                 base_sched: Optional[DiffusionSchedule] = None,
                 skip_weights: Tuple[float, float] = (0.5, 0.5)):
        self.tokenizer = tokenizer
        self.clip, self.unet, self.vae = clip.eval(), unet.eval(), vae.eval()
        self.embedding_manager = embedding_manager or EmbeddingManager()
        self.base_sched = base_sched or make_diffusion_schedule()
        self.skip_weights = skip_weights
        self.device = unet.in_conv.weight.device
        self.mesh = None  # serving mesh, set by use_mesh()

    @classmethod
    def from_random(cls, seed: int, tokenizer: TokenizerBase,
                    unet_cfg: Optional[UNetConfig] = None,
                    vae_cfg: Optional[VAEConfig] = None,
                    clip_cfg: Optional[CLIPTextConfig] = None,
                    dtype: torch.dtype = torch.float32, num_extra_tokens: int = 8,
                    device=None) -> "StableDiffusionPipeline":
        """Random-weight pipeline (SD v1.5 widths by default), built on
        `device` (the CUDA card unless `device="cpu"`) from `seed`."""
        dev = resolve_device(device)
        unet_cfg = unet_cfg or UNetConfig.sd_v1()
        vae_cfg = vae_cfg or VAEConfig.sd_v1()
        clip_cfg = clip_cfg or CLIPTextConfig.vit_l_14(num_extra_tokens=num_extra_tokens)
        models = []
        for i, build in enumerate((lambda: CLIPTextEncoder(clip_cfg),
                                   lambda: UNetModel(unet_cfg),
                                   lambda: AutoencoderKL(vae_cfg))):
            m = build_random(build, seed * 3 + i, dev, dtype)
            if dev.type == "cuda":
                m = m.to(memory_format=torch.channels_last)
            models.append(m)
        return cls(tokenizer, *models)

    @classmethod
    def from_sd_checkpoint(cls, path: str, tokenizer: TokenizerBase,
                           dtype: torch.dtype = torch.float32, num_extra_tokens: int = 8,
                           device=None, unet_cfg: Optional[UNetConfig] = None,
                           vae_cfg: Optional[VAEConfig] = None,
                           clip_cfg: Optional[CLIPTextConfig] = None
                           ) -> "StableDiffusionPipeline":
        """The pipeline of an SD v1.x checkpoint (a torch zip `.ckpt`, read
        without running pickled code, or a `.safetensors`), in `dtype` on
        `device` (the CUDA card unless `device="cpu"`). The configs default
        to SD v1.5's. A checkpoint whose top level is not a flat state dict
        is flattened from its module stubs. The `num_extra_tokens`
        placeholder rows of the CLIP table are fresh:
        `np.random.default_rng(0).standard_normal((n, D))` in the base
        table's numpy dtype (bf16 read as fp32) times the table's std."""
        from adaface_tpu_torch.interop.hf_clip import map_clip_text_state_dict
        from adaface_tpu_torch.interop.sd_unet import UNET_PREFIX, map_unet_state_dict
        from adaface_tpu_torch.interop.sd_vae import map_vae_state_dict
        from adaface_tpu_torch.interop.torch_pickle import load_sd_state_dict, walk_stub_tree

        dev = resolve_device(device)
        sd = load_sd_state_dict(path)
        if not isinstance(sd, dict) or not any(k.startswith(UNET_PREFIX) for k in sd):
            sd = walk_stub_tree(sd)
        unet_cfg = unet_cfg or UNetConfig.sd_v1()
        vae_cfg = vae_cfg or VAEConfig.sd_v1()
        clip_cfg = dataclasses.replace(clip_cfg or CLIPTextConfig.vit_l_14(),
                                       num_extra_tokens=num_extra_tokens)
        clip_sd = map_clip_text_state_dict(sd, clip_cfg.num_layers,
                                           prefix="cond_stage_model.transformer.text_model.")
        if num_extra_tokens:
            base = clip_sd["token_embedding.weight"]
            base = (base.numpy() if base.dtype in (torch.float16, torch.float32, torch.float64)
                    else base.float().numpy())
            rows = (np.random.default_rng(0).standard_normal((num_extra_tokens, base.shape[1]))
                    .astype(base.dtype) * float(base.std()))
            clip_sd["extra_token_embedding.weight"] = torch.from_numpy(rows)
        models = []
        for build, msd in ((lambda: CLIPTextEncoder(clip_cfg), clip_sd),
                           (lambda: UNetModel(unet_cfg), map_unet_state_dict(sd, unet_cfg)),
                           (lambda: AutoencoderKL(vae_cfg), map_vae_state_dict(sd, vae_cfg))):
            with torch.device("meta"):
                m = build()
            m = m.to_empty(device=dev).to(dtype)
            m.load_state_dict(msd, strict=True)
            if dev.type == "cuda":
                m = m.to(memory_format=torch.channels_last)
            models.append(m.eval())
        return cls(tokenizer, *models)

    def use_mesh(self, n_devices: Optional[int] = None, dp: Optional[int] = None, tp: int = 1,
                 mesh=None):
        """Serve over a dp x tp mesh of this process group's ranks (every
        rank calls it, then every request): `generate`, `img2img` and
        `inpaint` draw their noise at the whole batch and each dp rank
        computes its rows; tp > 1 tensor-shards the UNet's attention and
        feed-forward (`shard_unet_tp`, Megatron's column / row pairs). The
        gathered images come back whole on every rank."""
        from adaface_tpu_torch.models.unet import shard_unet_tp
        from adaface_tpu_torch.parallel import mesh as pmesh

        self.mesh = mesh if mesh is not None else pmesh.make_mesh(n_devices, dp, tp)
        shard_unet_tp(self.unet, self.mesh)
        return self.mesh

    def _rows(self, b: int):
        """This dp rank's rows of a b-row request (None: all of them)."""
        return None if self.mesh is None else self.mesh.local_rows(b)

    def _gather_images(self, imgs: np.ndarray, b: int) -> np.ndarray:
        """uint8 rows of every dp rank into the whole [b, H, W, 3] batch."""
        if self._rows(b) is None:
            return imgs
        full = self.mesh.gather_rows(torch.as_tensor(imgs.astype(np.int32), device=self.device), b)
        return full.cpu().numpy().astype(np.uint8)

    def ldm_state_dict(self) -> Dict[str, torch.Tensor]:
        """The backbone's weights in SD v1.x LDM names (the inverse of
        `from_sd_checkpoint`'s maps; the CLIP table's placeholder rows are
        left out), as tensors of the modules' dtype and device."""
        from adaface_tpu_torch.interop.hf_clip import hf_clip_text_state_dict
        from adaface_tpu_torch.interop.sd_unet import ldm_unet_state_dict
        from adaface_tpu_torch.interop.sd_vae import ldm_vae_state_dict

        sd = hf_clip_text_state_dict(self.clip.state_dict(), self.clip.cfg.num_layers,
                                     prefix="cond_stage_model.transformer.text_model.")
        sd.update(ldm_unet_state_dict(self.unet.state_dict(), self.unet.cfg))
        sd.update(ldm_vae_state_dict(self.vae.state_dict(), self.vae.cfg))
        return {k: v.detach() for k, v in sd.items()}

    def set_conv_attn_kernel_size(self, ks: int) -> "StableDiffusionPipeline":
        """Subject-token conv attention of kernel size `ks` in later requests
        (a reference checkpoint's `use_conv_attn_kernel_size`); <= 1 is off."""
        self.unet.cfg = dataclasses.replace(self.unet.cfg, conv_attn_kernel_size=ks)
        self.embedding_manager.use_conv_attn_kernel_size = ks
        return self

    def _cfg_slot_map(self, ids: np.ndarray, sm: Optional[Dict[str, np.ndarray]] = None
                      ) -> torch.Tensor:
        """[2B, T] subject slot map of a CFG (cond; uncond) batch for conv
        attention: the first non-background placeholder's map on the cond
        half, -1 on the uncond half (and everywhere without conv attention
        or placeholders)."""
        ids = np.asarray(ids)
        if sm is None:
            sm = self.embedding_manager.build_slot_maps(ids)
        cond = np.full(ids.shape, -1, np.int32)
        if sm and self.unet.cfg.conv_attn_kernel_size > 1:
            subj = next((s for s, i in self.embedding_manager.placeholders.items()
                         if not i.is_background), None)
            if subj:
                cond = np.asarray(sm[subj], np.int32)
        return torch.as_tensor(np.concatenate([cond, np.full_like(cond, -1)]),
                               device=self.device)

    def _cfg_eps_fn(self, ctx_c: torch.Tensor, ctx_u: torch.Tensor, slot_map: torch.Tensor):
        """The CFG eps function of one request: stem dedup and the cross-K/V
        hoist, each with an A/B knob read per call ("0" turns it off), as in
        JAX, and the conv-attention slot map."""
        dedup = (0 in self.unet.cfg.attention_levels
                 and knobs.get("ADAFACE_CFG_DEDUP") != "0")
        kv_fn = (None if knobs.get("ADAFACE_CROSS_KV") == "0"
                 else lambda ctx: precompute_cross_kv(self.unet, ctx))

        def unet_apply(x, t, ctx, cross_kv=None):
            return self.unet(x, t, ctx, cfg_dedup=dedup, cross_kv=cross_kv,
                             subj_slot_map=slot_map)

        return make_cfg_eps_fn(unet_apply, ctx_c, ctx_u, dedup=dedup, kv_fn=kv_fn)

    def _decode_uint8(self, z: torch.Tensor) -> np.ndarray:
        imgs = self.vae.decode(z / SD_VAE_SCALE_FACTOR).float()
        imgs = torch.clamp((imgs + 1.0) / 2.0, 0.0, 1.0)
        return (imgs * 255).to(torch.uint8).cpu().numpy()  # truncation, as in JAX

    # ------------------------------------------------------------- encoding
    def _encode_patched(self, ids: np.ndarray, slot_maps: Dict[str, np.ndarray],
                        extra_subj: Optional[Dict[str, torch.Tensor]] = None
                        ) -> torch.Tensor:
        """ids [B, 77] with placeholders -> [16, B, 77, D]. `extra_subj`
        (the zero-shot generators' [L, B, K, D]) takes precedence over a
        static embedder of the same placeholder."""
        mgr = self.embedding_manager
        embedded = self.clip.embed_tokens(torch.as_tensor(ids, dtype=torch.long,
                                                          device=self.device))
        subj = {s: e.to(self.device) for s, e in mgr.compute_subject_embeddings().items()
                if not extra_subj or s not in extra_subj}
        subj.update(extra_subj or {})
        patched = mgr.patch_prompt_embeddings(embedded, slot_maps, subj)
        L, B, T, D = patched.shape
        ctx = self.clip(input_embeds=patched.reshape(L * B, T, D),
                        skip_weights=self.skip_weights)
        return ctx.reshape(L, B, T, D)

    def _encode_plain(self, ids: np.ndarray) -> torch.Tensor:
        """ids [B, 77] -> [1, B, 77, D]."""
        ids_t = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        return self.clip(ids_t, skip_weights=self.skip_weights)[None]

    def set_zero_shot_features(self, features, forward_template_ids, inverse_template_ids,
                               arcface_token_id: int, out_id_embs_scale: float = 1.0,
                               is_face: bool = True, inf_emb_type: str = "full_half_pad"):
        """Condition later requests on reference-image features (a
        `ZeroShotFeatures` from `ZeroShotFeatureExtractor.encode`) through
        the manager's zero-shot generators. The templates are [1, 77] ids
        of `arc2face.FORWARD_TEMPLATE` and `INVERSE_TEMPLATE`;
        `inf_emb_type` is the inverse embeddings' padding variant."""
        self._zs = dict(features=features,
                        forward_template_ids=np.asarray(forward_template_ids),
                        inverse_template_ids=np.asarray(inverse_template_ids),
                        arcface_token_id=arcface_token_id,
                        out_id_embs_scale=out_id_embs_scale, is_face=is_face,
                        inf_emb_type=inf_emb_type)

    def _zero_shot_subject(self, batch: int) -> Optional[Dict[str, torch.Tensor]]:
        """The generators' [L, batch, K, D] embeddings of the features' first
        instance, broadcast over the prompt batch; None without zero-shot
        features or generators."""
        zs = getattr(self, "_zs", None)
        mgr = self.embedding_manager
        if zs is None or not mgr.subj_basis_generators:
            return None
        subj, _ = mgr.compute_zero_shot_embeddings(
            zs["features"], zs["inverse_template_ids"],
            forward_template_ids=zs["forward_template_ids"],
            arcface_token_id=zs["arcface_token_id"],
            out_id_embs_scale=zs["out_id_embs_scale"], is_face=zs["is_face"],
            inf_emb_type=zs["inf_emb_type"])
        return {s: e[:, :1].expand((e.shape[0], batch) + tuple(e.shape[2:]))
                for s, e in subj.items()}

    def _encode_ids(self, ids: np.ndarray, slot_maps: Dict[str, np.ndarray]) -> torch.Tensor:
        if not slot_maps:
            return self._encode_plain(ids)
        return self._encode_patched(ids, slot_maps, self._zero_shot_subject(ids.shape[0]))

    @torch.inference_mode()
    def encode_prompts(self, prompts: Sequence[str]) -> torch.Tensor:
        """[L, B, 77, D] prompt contexts with placeholders patched (L = 1
        when no placeholder is registered)."""
        ids = self.tokenizer(list(prompts))
        return self._encode_ids(ids, self.embedding_manager.build_slot_maps(ids))

    @torch.inference_mode()
    def encode_negative(self, prompt: str, batch: int) -> torch.Tensor:
        return self._encode_plain(self.tokenizer([prompt])).expand(-1, batch, -1, -1)

    # ------------------------------------------------------------- sampling
    @torch.inference_mode()
    def generate(self, prompts: Sequence[str],
                 negative_prompt: str = DEFAULT_NEGATIVE_PROMPT,
                 num_steps: int = 50, guidance_scale=(10.0, 4.0),
                 height: int = 512, width: int = 512, seed: int = 0,
                 sampler: str = "ddim", compel_cfg_weight_level: float = 0.0,
                 x_T: Optional[np.ndarray] = None,
                 context: Optional[torch.Tensor] = None) -> np.ndarray:
        """uint8 images [B, H, W, 3]. The initial noise is `x_T` [B, h, w, C]
        when given, else drawn from a torch.Generator seeded with `seed`.
        `sampler` "ddim" anneals the guidance over the steps; "plms" runs at
        the pair's first value (or the scalar), as JAX does.
        `compel_cfg_weight_level` != 0 scales the cond context's offset from
        the empty prompt's context by 1.1**level (the cond half only).
        `context` [L|1, B|1, T, D] replaces the prompt encoding (layer and
        batch dims of size 1 broadcast, a single layer to all 16): the
        Arc2Face evaluation modes, where raw Arc2Face or inverse prompt
        embeddings drive the UNet. The prompts then only size the batch.
        Under `use_mesh` the noise is drawn for the whole batch, each dp rank
        samples its rows and every rank returns the whole gathered batch."""
        if sampler not in ("ddim", "plms"):
            raise ValueError(f"unknown sampler {sampler!r}")
        b_all = len(prompts)
        rows = self._rows(b_all)
        f = 2 ** (len(self.vae.cfg.ch_mult) - 1)
        lh, lw = height // f, width // f
        ids = self.tokenizer(list(prompts))
        sm = self.embedding_manager.build_slot_maps(ids)
        if rows is not None:
            ids, sm = ids[rows], {k: np.asarray(v)[rows] for k, v in sm.items()}
        b = len(ids)
        if context is not None:
            ctx_c = torch.as_tensor(context).to(device=self.device,
                                                dtype=self.clip.token_embedding.weight.dtype)
            L = NUM_CA_LAYERS if ctx_c.shape[0] == 1 else ctx_c.shape[0]
            ctx_c = ctx_c.expand((L, b_all) + tuple(ctx_c.shape[2:]))
            if rows is not None:
                ctx_c = ctx_c[:, torch.as_tensor(rows, device=self.device)]
        else:
            # Encode each distinct prompt row once (token row + slot-map
            # rows): a serving batch of one repeated prompt pays 16 CLIP
            # rows, not 16*B. Zero-shot embeddings are the same for every
            # row, so the dedup holds under them too.
            row_key, first_idx, gather = {}, [], []
            for i in range(b):
                key = (ids[i].tobytes(), tuple(m[i].tobytes() for m in sm.values()))
                if key not in row_key:
                    row_key[key] = len(first_idx)
                    first_idx.append(i)
                gather.append(row_key[key])
            ctx_c = self._encode_ids(ids[first_idx], {k: v[first_idx] for k, v in sm.items()})
            if len(first_idx) != b:
                ctx_c = ctx_c[:, torch.as_tensor(gather, device=self.device)]
        ctx_u = self.encode_negative(negative_prompt, b)  # encoded once, broadcast
        if compel_cfg_weight_level:
            empty = self.encode_negative("", 1)[0]
            ctx_c = apply_compel_cfg(ctx_c, empty.to(ctx_c.dtype), compel_cfg_weight_level)

        in_ch = self.unet.cfg.in_channels
        if x_T is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            x = torch.randn((b_all, lh, lw, in_ch), generator=gen, device=self.device)
        else:
            x = torch.as_tensor(np.asarray(x_T, np.float32), device=self.device)
            if tuple(x.shape) != (b_all, lh, lw, in_ch):
                raise ValueError(f"x_T has shape {tuple(x.shape)}, "
                                 f"want {(b_all, lh, lw, in_ch)}")
        if rows is not None:
            x = x[torch.as_tensor(rows, device=self.device)]
        eps_fn = self._cfg_eps_fn(ctx_c, ctx_u, self._cfg_slot_map(ids, sm))
        sched = make_ddim_schedule(self.base_sched, num_steps, guidance_scale=guidance_scale)
        if sampler == "plms":
            z = plms_sample(eps_fn, sched, x, guide_scale=_first(guidance_scale))
        else:
            z = ddim_sample(eps_fn, sched, x)
        return self._gather_images(self._decode_uint8(z), b_all)

    @torch.inference_mode()
    def img2img(self, init_image: np.ndarray, prompts: Sequence[str], strength: float = 0.75,
                negative_prompt: str = DEFAULT_NEGATIVE_PROMPT, num_steps: int = 50,
                guidance_scale=(10.0, 4.0), seed: int = 0,
                noise: Optional[np.ndarray] = None) -> np.ndarray:
        """uint8 [B, H, W, 3] from `init_image` [H, W, 3] uint8: the VAE
        encode's mean times the scale factor, noised to the timestep of
        sampling index steps - t_enc (t_enc = strength * steps, kept in
        [1, steps - 1]) by `noise` [B, h, w, C] or a draw from a
        torch.Generator seeded with `seed`, then DDIM from there at one fixed
        guidance scale (the pair's first value; no annealing). Under
        `use_mesh` as `generate`: each dp rank its rows of the whole draw."""
        b_all = len(prompts)
        rows = self._rows(b_all)
        ids = self.tokenizer(list(prompts))
        sm = self.embedding_manager.build_slot_maps(ids)
        if rows is not None:
            ids, sm = ids[rows], {k: np.asarray(v)[rows] for k, v in sm.items()}
        b = len(ids)
        ctx_c = self._encode_ids(ids, sm)
        ctx_u = self.encode_negative(negative_prompt, b)
        sched = make_ddim_schedule(self.base_sched, num_steps, guidance_scale=guidance_scale)
        t_enc = max(1, min(int(strength * num_steps), num_steps - 1))
        start = num_steps - t_enc  # timesteps descend: the last t_enc steps
        img = torch.as_tensor(np.asarray(init_image), device=self.device)
        x = (img.float() / 127.5 - 1.0)[None].expand((b,) + tuple(img.shape))
        mean, _ = self.vae.encode(x)
        z0 = mean * SD_VAE_SCALE_FACTOR
        t = torch.full((b,), int(sched.timesteps[start]), dtype=torch.int32, device=self.device)
        if noise is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            n = torch.randn((b_all,) + tuple(z0.shape[1:]), generator=gen, device=self.device)
        else:
            n = torch.as_tensor(np.array(noise, np.float32), device=self.device)
        if rows is not None:
            n = n[torch.as_tensor(rows, device=self.device)]
        z_t = stochastic_encode(self.base_sched, z0, t, n)
        eps_fn = self._cfg_eps_fn(ctx_c, ctx_u, self._cfg_slot_map(ids, sm))
        return self._gather_images(
            self._decode_uint8(ddim_decode(eps_fn, sched, z_t, start,
                                           guide_scale=_first(guidance_scale))), b_all)


def _first(guidance_scale) -> float:
    """The fixed scale of PLMS and img2img: a pair's first value, or the scalar."""
    if isinstance(guidance_scale, (tuple, list)):
        return float(guidance_scale[0])
    return float(guidance_scale)
