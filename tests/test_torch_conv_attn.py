"""Subject-token conv attention in the port against the JAX package's, on the
CPU in fp32:

- `conv_attn_scores` and `apply_conv_attn` at ks 2, 3 and 4 on the same
  q, k and slot map (a row with the subject at the start, one in the
  middle, one without it; atol 1e-5), and each trap with its other choice
  outside that tolerance: the pad table (mirrored), the shift order
  (dx outer), the scale (sim_scale / ks);
- the UNet at SD v1.5 depth (tiny widths, einsum attention) with a CFG
  slot map at ks 2 and 3 (atol 5e-5), where forcing no layer to 1x1 (the
  reference forces 12, 16, 17, 18 and 19) falls outside, and the routing:
  a cross-attention with conv attention calls no flash entry, the forced
  layers still do;
- the pipeline's CFG slot map (the uncond half all -1) and
  `set_conv_attn_kernel_size`."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from adaface_tpu.models.unet import UNetConfig as JUNetConfig
from adaface_tpu.models.unet import UNetModel as JUNet
from adaface_tpu.ops import attention as jattn

from adaface_tpu_torch.interop import from_jax
from adaface_tpu_torch.models import unet as tunet
from adaface_tpu_torch.models.unet import UNetConfig, UNetModel
from adaface_tpu_torch.ops import attention as tattn
from adaface_tpu_torch.pipeline import build_random

torch.set_num_threads(2)

ATOL = 1e-5
B, H, HW, D, T = 3, 2, (6, 5), 8, 12


def _inputs(seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, HW[0] * HW[1], D)).astype(np.float32)
    k = rng.standard_normal((B, H, T, D)).astype(np.float32)
    sim = rng.standard_normal((B, H, HW[0] * HW[1], T)).astype(np.float32)
    sm = np.full((B, T), -1, np.int32)
    sm[0, 1:1 + 16] = np.arange(min(16, T - 1))   # the subject from token 1
    sm[1, 5:] = np.arange(T - 5)                    # from token 5
    return q, k, sim, sm                            # row 2: no subject


def _shifted_maps(q, k, sm, ks, scale, pads, dx_outer=False):
    """conv_attn_scores with another pad table or shift order."""
    Bq, h, N, d = q.shape
    m = ks * ks
    onehot = (sm[:, :, None] == torch.arange(m)).float()
    subj = torch.einsum("bhtd,btm->bhmd", k, onehot)
    l, r, t, b = pads
    x = q.reshape(Bq * h, *HW, d).permute(0, 3, 1, 2).reshape(1, Bq * h * d, *HW)
    w = subj.reshape(Bq * h, ks, ks, d).permute(0, 3, 1, 2)
    maps = F.conv2d(F.pad(x, (l, r, t, b)), w, groups=Bq * h).reshape(Bq, h, *HW) * scale
    order = ([(dy, dx) for dx in range(-l, r + 1) for dy in range(-t, b + 1)] if dx_outer
             else [(dy, dx) for dy in range(-t, b + 1) for dx in range(-l, r + 1)])
    outs = []
    for dy, dx in order:
        s = torch.roll(maps, (dy, dx), dims=(2, 3))
        if dy > 0:
            s[:, :, :dy] = 0
        elif dy < 0:
            s[:, :, dy:] = 0
        if dx > 0:
            s[:, :, :, :dx] = 0
        elif dx < 0:
            s[:, :, :, dx:] = 0
        outs.append(s.reshape(Bq, h, N))
    return torch.stack(outs)


@pytest.mark.parametrize("ks", [2, 3, 4])
def test_conv_attn_scores_and_apply_equal_jax(ks):
    q, k, sim, sm = _inputs(ks)
    scale = D ** -0.5
    ref = np.asarray(jattn.conv_attn_scores(jnp.asarray(q), jnp.asarray(k), jnp.asarray(sm),
                                            HW, ks, scale))
    got = tattn.conv_attn_scores(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(sm).long(), HW, ks, scale)
    assert got.shape == (ks * ks, B, H, HW[0] * HW[1])
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)
    ref_sim = np.asarray(jattn.apply_conv_attn(jnp.asarray(sim), jnp.asarray(q), jnp.asarray(k),
                                               jnp.asarray(sm), HW, ks, scale))
    got_sim = tattn.apply_conv_attn(torch.from_numpy(sim), torch.from_numpy(q),
                                    torch.from_numpy(k), torch.from_numpy(sm).long(), HW, ks,
                                    scale)
    np.testing.assert_allclose(got_sim.numpy(), ref_sim, atol=ATOL)
    np.testing.assert_array_equal(got_sim[2].numpy(), sim[2])  # no subject: untouched
    # the traps: each other choice leaves the tolerance
    qt, kt, smt = torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(sm).long()
    pads = tattn._CONV_ATTN_PADS[ks]
    mine = _shifted_maps(qt, kt, smt, ks, scale / ks ** 1.5, pads)
    np.testing.assert_allclose(mine.numpy(), ref, atol=ATOL)  # the helper is right
    mirrored = (pads[1], pads[0], pads[3], pads[2]) if ks != 3 else (0, 2, 0, 2)
    others = {"scale / ks": _shifted_maps(qt, kt, smt, ks, scale / ks, pads),
              "other pads": _shifted_maps(qt, kt, smt, ks, scale / ks ** 1.5, mirrored)}
    if ks > 1:
        others["dx outer"] = _shifted_maps(qt, kt, smt, ks, scale / ks ** 1.5, pads,
                                           dx_outer=True)
    for name, other in others.items():
        assert np.abs(other.numpy() - ref).max() > 100 * ATOL, name


def test_kernel_size_one_is_the_identity():
    q, k, sim, sm = _inputs(0)
    out = tattn.apply_conv_attn(torch.from_numpy(sim), torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(sm).long(), HW, 1, 1.0)
    assert torch.equal(out, torch.from_numpy(sim))


# SD v1.5 depth (layer indices 1..24, so 12 and 16-19 exist) at tiny widths
UNET_KW = dict(model_channels=32, channel_mult=(1, 2, 4, 4), num_res_blocks=2,
               attention_levels=(0, 1, 2), num_heads=4, context_dim=16,
               use_flash_attention=False)


@pytest.fixture(scope="module")
def unets():
    unet = build_random(lambda: UNetModel(UNetConfig(**UNET_KW)), 5, "cpu")
    with torch.no_grad():  # cross-attention weights large enough to move eps
        for name, p in unet.named_parameters():
            if ".attn2." in name:
                p.mul_(10.0)
    tree = from_jax.jax_tree_from_module(unet)
    return unet, tree


def _unet_inputs():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.array([500, 500], np.int32)
    ctx = rng.standard_normal((16, 2, T, 16)).astype(np.float32)
    sm = np.full((2, T), -1, np.int32)
    sm[0, 2:11] = np.arange(9)  # cond row: a 9-vector subject; uncond row: none
    return x, t, ctx, sm


def _jax_eps(tree, ks, x, t, ctx, sm):
    cfg = JUNetConfig(**UNET_KW, conv_attn_kernel_size=ks)
    return np.asarray(JUNet(cfg).apply({"params": tree}, jnp.asarray(x), jnp.asarray(t),
                                       jnp.asarray(ctx), subj_slot_map=jnp.asarray(sm)))


@pytest.mark.parametrize("ks", [2, 3])
def test_unet_with_slot_map_equals_jax(unets, monkeypatch, ks):
    unet, tree = unets
    x, t, ctx, sm = _unet_inputs()
    ref = _jax_eps(tree, ks, x, t, ctx, sm)
    args = (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    unet.cfg = UNetConfig(**UNET_KW, conv_attn_kernel_size=ks)
    try:
        with torch.no_grad():
            got = unet(*args, subj_slot_map=torch.from_numpy(sm)).numpy()
            off = unet(*args).numpy()  # no slot map: no conv attention
            monkeypatch.setattr(tunet, "CONV_ATTN_1X1_LAYERS", ())
            unforced = unet(*args, subj_slot_map=torch.from_numpy(sm)).numpy()
    finally:
        unet.cfg = UNetConfig(**UNET_KW)
    np.testing.assert_allclose(got, ref, atol=5e-5)
    assert np.abs(off - ref).max() > 100 * 5e-5
    assert np.abs(unforced - ref).max() > 100 * 5e-5


def test_conv_attention_takes_the_einsum_path(monkeypatch):
    """With flash attention on, a cross-attention with conv attention calls
    no flash entry; those of the layers forced to 1x1 still do."""
    unet = build_random(lambda: UNetModel(UNetConfig(**{**UNET_KW,
                                                         "use_flash_attention": True},
                                                      conv_attn_kernel_size=2)), 6, "cpu")
    calls = []
    real_blc, real_bhld = tunet.flash_attention_blc, tunet.flash_attention

    def blc(q, k, v, h, **kw):
        calls.append(k.shape[1])
        return real_blc(q, k, v, h, **kw)

    def bhld(q, k, v, **kw):
        calls.append(k.shape[2])
        return real_bhld(q, k, v, **kw)

    monkeypatch.setattr(tunet, "flash_attention_blc", blc)
    monkeypatch.setattr(tunet, "flash_attention", bhld)
    x, t, ctx, sm = _unet_inputs()
    with torch.no_grad():
        unet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
             subj_slot_map=torch.from_numpy(sm))
    cross = [n for n in calls if n == T]
    assert len(cross) == 5  # layers 12, 16, 17, 18, 19
    calls.clear()
    with torch.no_grad():
        unet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    assert len([n for n in calls if n == T]) == 16  # no slot map: every cross-attention


def test_pipeline_cfg_slot_map_and_kernel_size():
    from adaface_tpu_torch.data.tokenizer import HashTokenizer
    from adaface_tpu_torch.models.clip_text import CLIPTextConfig
    from adaface_tpu_torch.models.vae import VAEConfig
    from adaface_tpu_torch.pipeline import StableDiffusionPipeline

    tok = HashTokenizer()
    pipe = StableDiffusionPipeline.from_random(
        0, tok, UNetConfig.tiny(), VAEConfig.tiny(),
        CLIPTextConfig.tiny(vocab_size=49408, max_position_embeddings=77, hidden_size=16,
                            num_extra_tokens=2), device="cpu")
    y, z = tok.add_placeholder("y"), tok.add_placeholder("z")
    pipe.embedding_manager.add_placeholder("y", y, num_vectors=2, is_background=True,
                                           emb_dim=16)
    pipe.embedding_manager.add_placeholder("z", z, num_vectors=3, emb_dim=16)
    ids = tok(["a y , z , , person", "a cat"])
    assert (pipe._cfg_slot_map(ids) == -1).all()  # conv attention off
    pipe.set_conv_attn_kernel_size(2)
    assert pipe.unet.cfg.conv_attn_kernel_size == 2
    assert pipe.embedding_manager.use_conv_attn_kernel_size == 2
    sm = pipe._cfg_slot_map(ids).numpy()
    assert sm.shape == (4, 77) and (sm[2:] == -1).all()
    want = pipe.embedding_manager.build_slot_maps(ids)["z"]  # the subject, not the bg
    np.testing.assert_array_equal(sm[:2], want)
