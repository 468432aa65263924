"""Port parity of the CLIP vision tower (`adaface_tpu_torch/models/
clip_vision.py`) with the JAX package's, on a tiny config in fp32 on the
CPU, same weights through `interop/from_jax.py` and numpy inputs from a
seed: both mask modes at feature_layer -2 and None, the mask's resize to
the patch grid at sizes that do not divide evenly, and the antialiased
preprocessing resize. Two of the reference's traps must show: the +1 bias
read as a hard mask, and `F.interpolate` in place of `jax.image.resize`,
each falls outside the tolerance."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from adaface_tpu.models import clip_vision as jcv

from adaface_tpu_torch.interop import from_jax
from adaface_tpu_torch.models import clip_vision as tcv

torch.set_num_threads(2)

ATOL = 2e-5  # fp32, 2 layers of 64-wide attention and MLP


def _tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module")
def towers():
    cfg = jcv.CLIPVisionConfig.tiny(hidden_size=48)
    params = _tree(jcv.CLIPVisionEncoder(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 3)))["params"])
    ports = {}
    for mode in ("bias", "hard"):
        m = tcv.CLIPVisionEncoder(tcv.CLIPVisionConfig.tiny(hidden_size=48), mask_mode=mode)
        m.load_state_dict(from_jax.vision_state_dict_from_jax(params), strict=True)
        ports[mode] = m.eval()
    return cfg, params, ports


def _inputs(seed=0, b=2, mask_hw=(28, 28)):
    rng = np.random.default_rng(seed)
    pixels = rng.standard_normal((b, 28, 28, 3)).astype(np.float32)
    mask = (rng.random((b,) + mask_hw) > 0.4).astype(np.float32)
    return pixels, mask


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("mode", ["bias", "hard"])
@pytest.mark.parametrize("feature_layer", [-2, None])
def test_tower_matches_jax(towers, mode, feature_layer):
    cfg, params, ports = towers
    pixels, mask = _inputs()
    ref = jcv.CLIPVisionEncoder(cfg, mask_mode=mode).apply(
        {"params": params}, jnp.asarray(pixels), attn_mask=jnp.asarray(mask),
        feature_layer=feature_layer)
    with torch.no_grad():
        got = ports[mode](torch.from_numpy(pixels), attn_mask=torch.from_numpy(mask),
                          feature_layer=feature_layer)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        _close(g, r)
    # without a mask: no token mask, every pair attends
    ref_f, ref_p, ref_t = jcv.CLIPVisionEncoder(cfg, mask_mode=mode).apply(
        {"params": params}, jnp.asarray(pixels), feature_layer=feature_layer)
    with torch.no_grad():
        f, p, t = ports[mode](torch.from_numpy(pixels), feature_layer=feature_layer)
    assert t is None and ref_t is None
    _close(f, ref_f)
    _close(p, ref_p)


def test_hard_mask_in_place_of_the_bias_falls_outside(towers):
    """The reference adds the {0, 1} pair mask to the logits; reading it as a
    hard mask changes the features far beyond the tolerance."""
    cfg, params, ports = towers
    pixels, mask = _inputs(1)
    ref, _, _ = jcv.CLIPVisionEncoder(cfg).apply(
        {"params": params}, jnp.asarray(pixels), attn_mask=jnp.asarray(mask), feature_layer=-2)
    with torch.no_grad():
        wrong, _, _ = ports["hard"](torch.from_numpy(pixels), attn_mask=torch.from_numpy(mask),
                                    feature_layer=-2)
        right, _, _ = ports["bias"](torch.from_numpy(pixels), attn_mask=torch.from_numpy(mask),
                                    feature_layer=-2)
    _close(right, ref)
    assert np.abs(wrong.numpy() - np.asarray(ref)).max() > 100 * ATOL


@pytest.mark.parametrize("hw,grid", [((40, 33), 3), ((29, 50), 4), ((28, 28), 2), ((7, 9), 5)])
def test_resize_mask_to_grid_matches_jax(hw, grid):
    """Sizes that do not divide by the grid: the float32 index truncates the
    edge rows and columns as JAX's does."""
    mask = (np.random.default_rng(2).random((2,) + hw) > 0.5).astype(np.float32)
    ref = np.asarray(jcv.resize_mask_to_grid(jnp.asarray(mask), grid))
    got = tcv.resize_mask_to_grid(torch.from_numpy(mask), grid).numpy()
    assert got.shape == (2, grid * grid + 1)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("hw,size", [((50, 37), 28), ((224, 224), 28), ((30, 30), 30)])
def test_preprocess_images_matches_jax(hw, size):
    """The bilinear resize of `jax.image.resize` antialiases as it shrinks."""
    images = np.random.default_rng(3).integers(0, 256, (2,) + hw + (3,), dtype=np.uint8)
    ref = np.asarray(jcv.preprocess_images(jnp.asarray(images), size))
    got = tcv.preprocess_images(torch.from_numpy(images), size)
    assert got.shape == (2, size, size, 3) and got.dtype == torch.float32
    _close(got, ref, atol=1e-5)


def test_interpolate_in_place_of_the_antialiased_resize_falls_outside():
    images = np.random.default_rng(4).integers(0, 256, (2, 50, 37, 3), dtype=np.uint8)
    ref = np.asarray(jcv.preprocess_images(jnp.asarray(images), 28))
    x = torch.from_numpy(images).float() / 255.0
    x = F.interpolate(x.permute(0, 3, 1, 2), size=(28, 28), mode="bilinear",
                      align_corners=False).permute(0, 2, 3, 1)
    wrong = (x - torch.tensor(tcv.CLIP_IMAGE_MEAN)) / torch.tensor(tcv.CLIP_IMAGE_STD)
    assert np.abs(wrong.numpy() - ref).max() > 100 * 1e-5


def test_configs_match_jax():
    for name in ("vit_l_14", "vit_b_32", "tiny"):
        j, t = getattr(jcv.CLIPVisionConfig, name)(), getattr(tcv.CLIPVisionConfig, name)()
        for f in ("hidden_size", "num_layers", "num_heads", "intermediate_size", "image_size",
                  "patch_size", "layer_norm_eps", "grid", "num_tokens"):
            assert getattr(j, f) == getattr(t, f), (name, f)
    assert tcv.CLIPVisionConfig.vit_l_14().num_tokens == 257


def test_mask_mode_is_checked():
    with pytest.raises(ValueError, match="mask_mode"):
        tcv.CLIPVisionEncoder(tcv.CLIPVisionConfig.tiny(), mask_mode="soft")
