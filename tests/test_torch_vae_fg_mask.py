"""Port parity of the VAE's fg-mask encode, fp32 on the CPU:
`AutoencoderKL.encode(x, fg_mask, aug_mask)` of `models/vae.py` against the
JAX package's (`adaface_tpu/models/vae.py:93-138, 190-199, 247-252`).

A tiny VAE (ch 32, ch_mult (1, 2)) from `build_random`, the mid attention's
q and k scaled up so that its softmax is far from uniform, carried to a
flax tree by `jax_tree_from_module`. Mean and logvar within TOL (1e-5 of
the largest value):

- a 30x30 fg mask into a 32x32 image (a 16x16 attention grid: the mask's
  nearest resize is not a 2x ratio), with and without an aug mask holding a
  zero band; a 64x64 image (1024 tokens: the masked path forms the whole
  [B, L, L] matrix where the unmasked one is query-chunked);
- the unmasked path: equal to JAX, and an aug mask without an fg mask is
  ignored (bit for bit the unmasked output), as in JAX.

The traps, each with its other choice outside the tolerance: no
renormalization after the zeroing; the masks resized with torch's
`nearest` index (floor(dst * in / out)), not the half-pixel nearest; the
aug mask multiplies both fg and bg (ignoring it reads outside).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax

from adaface_tpu.models.vae import AutoencoderKL as JAutoencoderKL
from adaface_tpu.models.vae import VAEConfig as JVAEConfig

from adaface_tpu_torch.interop.from_jax import jax_tree_from_module, vae_state_dict_from_jax
from adaface_tpu_torch.models import vae as tv
from adaface_tpu_torch.pipeline import build_random

torch.set_num_threads(2)

TOL = 1e-5
VAE_KW = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=4, embed_dim=4)


@pytest.fixture(scope="module")
def vaes():
    port = build_random(lambda: tv.AutoencoderKL(tv.VAEConfig(**VAE_KW)), 5, "cpu")
    with torch.no_grad():
        for m in (port.encoder.mid_attn_1.q, port.encoder.mid_attn_1.k):
            m.weight.mul_(40.0)
    tree = jax_tree_from_module(port)
    sd = vae_state_dict_from_jax(tree)
    for k, v in port.state_dict().items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)
    jvae = JAutoencoderKL(JVAEConfig(**VAE_KW))
    jenc = jax.jit(lambda x, fg, aug: jvae.apply({"params": tree}, x, fg, aug,
                                                 method=JAutoencoderKL.encode))
    return port, jenc


def _inputs(size, mask_size=30, seed=0):
    g = np.random.default_rng(seed)
    x = g.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    yy, xx = np.mgrid[:mask_size, :mask_size]
    fg = np.stack([((yy - c) ** 2 + (xx - c) ** 2 < (0.3 * mask_size) ** 2)
                   for c in (0.45 * mask_size, 0.6 * mask_size)])[..., None].astype(np.float32)
    aug = np.ones_like(fg)
    aug[:, :, mask_size // 3: mask_size // 3 + 4] = 0.0  # a zero band
    aug[1, :4] = 0.0
    return x, fg, aug


def _close(got, ref):
    for g, r in zip(got, ref):
        err = float(np.abs(g.numpy() - np.asarray(r)).max() / np.abs(np.asarray(r)).max())
        if not err < TOL:
            return err
    return 0.0


def _encode(port, x, fg=None, aug=None):
    t = lambda a: None if a is None else torch.from_numpy(a)
    with torch.no_grad():
        return port.encode(t(x), t(fg), t(aug))


@pytest.mark.parametrize("size, with_aug", [(32, False), (32, True), (64, True)])
def test_masked_encode_matches_jax(vaes, size, with_aug):
    port, jenc = vaes
    x, fg, aug = _inputs(size)
    aug = aug if with_aug else None
    ref = jenc(x, fg, aug)
    got = _encode(port, x, fg, aug)
    assert got[0].shape == (2, size // 2, size // 2, 4)
    assert _close(got, ref) == 0.0
    # the mask moves the output: the unmasked encode reads far outside
    assert _close(_encode(port, x), ref) > 100 * TOL


def test_unmasked_encode_matches_jax_and_ignores_aug_alone(vaes):
    port, jenc = vaes
    x, _, aug = _inputs(64)
    assert _close(_encode(port, x), jenc(x, None, None)) == 0.0
    for a, b in zip(_encode(port, x, None, aug), _encode(port, x)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _half_pixel_resize(m, h, w):
    return F.interpolate(m.permute(0, 3, 1, 2), size=(h, w),
                         mode="nearest-exact").permute(0, 2, 3, 1)


def test_traps_read_outside(vaes, monkeypatch):
    port, jenc = vaes
    x, fg, aug = _inputs(32)
    ref = jenc(x, fg, aug)
    isolate = tv.isolate_fg

    def renormalized(probs, *a):
        p = isolate(probs, *a)
        s = p.sum(-1, keepdim=True)  # rows of aug-zeroed tokens keep no pair
        return p / torch.where(s > 0, s, 1.0)

    faults = {
        "renormalized": ("isolate_fg", renormalized),
        "half-pixel mask resize": ("nearest_resize", _half_pixel_resize),
        "aug ignored": ("isolate_fg", lambda probs, fg_, aug_, hh, ww: isolate(
            probs, fg_, None, hh, ww)),
    }
    # the half-pixel resize picks other rows at 30 -> 16
    idx = torch.arange(16) * 30 // 16
    assert not torch.equal(idx, ((torch.arange(16) + 0.5) * 30 / 16).floor().long())
    for name, (attr, fn) in faults.items():
        monkeypatch.setattr(tv, attr, fn)
        err = _close(_encode(port, x, fg, aug), ref)
        monkeypatch.undo()
        assert err > 100 * TOL, name
    assert _close(_encode(port, x, fg, aug), ref) == 0.0
