"""Port parity of the BiSeNet face parser, fp32 on the CPU:
`models/bisenet.py` and `interop/bisenet.py` against the JAX package's.

- The face-parsing map (`synth_state_dict()` of `tests/test_bisenet.py`,
  aux heads included): the folded weights equal JAX's bit for bit (the
  same numpy fp32 fold, eps 1e-5); an unconsumed key is refused under
  `strict` and passes without it; the aux heads are consumed; a state dict
  without them maps too.
- `load_bisenet` on a `.pth` written by torch.save against JAX's
  `load_bisenet`, and the forwards carried by
  `bisenet_state_dict_from_jax`: logits within TOL (1e-5 of the largest
  value) at 64 pixels (exact 2x ratios) and at 100 (feat8 13, feat16 7,
  feat32 4: neither upsample is 2x).
- The traps, each with its other choice outside the tolerance: the
  context path's nearest upsample is `jax.image.resize`'s half-pixel one
  (torch's `nearest`, the source repo's, reads outside at 100 pixels); the
  final upsample is bilinear with `align_corners=True` (False reads
  outside); the max pool pads with -inf (zero padding reads outside on
  negative inputs).
- `preprocess` and `parsing_to_mask` equal JAX's; the parts count includes
  the background.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from flax import linen as nn

from adaface_tpu.interop import bisenet as jib
from adaface_tpu.models import bisenet as jb

from adaface_tpu_torch.interop import bisenet as tib
from adaface_tpu_torch.interop.from_jax import bisenet_state_dict_from_jax
from adaface_tpu_torch.models import bisenet as tb

from test_bisenet import synth_state_dict
from torch_face_helpers import face_parsing_state_dict, flax_tree, rel_err

torch.set_num_threads(2)

TOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    sd = synth_state_dict(3)
    jparams = jib.map_bisenet_params(sd)
    port = tb.BiSeNet().eval()
    port.load_state_dict(tib.map_bisenet_params(sd), strict=True)
    return port, jparams


def _images(seed, size):
    return np.random.default_rng(seed).integers(0, 256, (2, size, size, 3), dtype=np.uint8)


def test_map_equals_jax_bit_for_bit(pair):
    port, jparams = pair
    ref, _ = flax_tree(port)
    flat_ref = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jparams)[0])
    assert flat_ref.keys() == flat_j.keys()
    for k, v in flat_j.items():
        np.testing.assert_array_equal(flat_ref[k], np.asarray(v))
    sd = bisenet_state_dict_from_jax(jparams)
    for k, v in port.state_dict().items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)


def test_strict_refusal_and_aux_heads():
    sd = synth_state_dict(0)
    sd["cp.resnet.bogus.weight"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="unconsumed"):
        tib.map_bisenet_params(sd)
    with pytest.raises(ValueError, match="unconsumed"):
        jib.map_bisenet_params(sd)
    loose = tib.map_bisenet_params(sd, strict=False)
    assert "resnet.conv1.weight" in loose
    no_aux = {k: v for k, v in synth_state_dict(0).items() if not k.startswith("conv_out1")
              and not k.startswith("conv_out3")}
    assert len(no_aux) < len(synth_state_dict(0))
    a, b = tib.map_bisenet_params(no_aux), tib.map_bisenet_params(synth_state_dict(0))
    assert a.keys() == b.keys() and not any("conv_out16" in k for k in a)


def test_load_bisenet_matches_jax(tmp_path):
    path = str(tmp_path / "79999_iter.pth")
    torch.save(face_parsing_state_dict(5), path)
    port = tib.load_bisenet(path)
    jmodel, jparams = jib.load_bisenet(path)
    x = jb.preprocess(jnp.asarray(_images(1, 64)))
    ref = np.asarray(jax.jit(jmodel.apply)({"params": jparams}, x))
    with torch.no_grad():
        got = port(tb.preprocess(torch.from_numpy(_images(1, 64)))).numpy()
    assert got.shape == (2, 64, 64, tb.N_PARSING_CLASSES)
    assert rel_err(got, ref) < TOL


@pytest.mark.parametrize("size", [64, 100])
def test_forward_matches_jax(pair, size, monkeypatch):
    port, jparams = pair
    imgs = _images(size, size)
    x = np.array(jb.preprocess(jnp.asarray(imgs)))
    np.testing.assert_array_equal(tb.preprocess(torch.from_numpy(imgs)).numpy(), x)
    ref = np.asarray(jax.jit(jb.BiSeNet().apply)({"params": jparams}, x))

    def run():
        with torch.no_grad():
            return port(torch.from_numpy(x)).numpy()

    assert rel_err(run(), ref) < TOL
    if size == 100:
        # the source repo's (and torch's default) nearest
        monkeypatch.setattr(tb, "resize_nearest",
                            lambda t, h, w: F.interpolate(t, size=(h, w), mode="nearest"))
        assert rel_err(run(), ref) > 100 * TOL
        monkeypatch.undo()
    monkeypatch.setattr(tb, "resize_bilinear_ac", lambda t, h, w: F.interpolate(
        t, size=(h, w), mode="bilinear", align_corners=False))
    assert rel_err(run(), ref) > 100 * TOL


def test_max_pool_pads_with_minus_inf():
    x = np.random.default_rng(2).normal(-3, 1, (1, 9, 9, 4)).astype(np.float32)
    ref = np.asarray(nn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                                 padding=((1, 1), (1, 1))))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = tb.max_pool_3x3s2(xt).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, ref)
    other = F.max_pool2d(F.pad(xt, (1, 1, 1, 1)), 3, 2).permute(0, 2, 3, 1).numpy()
    assert rel_err(other, ref) > 0.1


def test_parsing_to_mask_matches_jax():
    g = np.random.default_rng(4)
    parsing = g.integers(1, 19, (3, 12, 10))
    parsing[0, :4] = 0  # background present in image 0 only
    parsing[2] = np.where(parsing[2] > 5, 5, parsing[2])  # classes 1-5
    jm, jp = jb.parsing_to_mask(jnp.asarray(parsing))
    tm, tp = tb.parsing_to_mask(torch.from_numpy(parsing))
    assert tm.dtype == torch.uint8
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert tp[2] == 5 and tp[0] == tp[1] + 1  # the background counts as a part
