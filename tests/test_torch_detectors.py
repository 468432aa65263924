"""Port parity of the face detectors, fp32 on the CPU: `models/scrfd.py`
and `models/retinaface.py` against the JAX package's.

- SCRFD at `tiny` and `scrfd_10g` widths on a 64x64 frame and RetinaFace at
  its only width on a 96x80 frame, the weights carried from a seeded port
  module (BN statistics and affines, GN affines and conv biases moved off
  the identity) to flax trees and back by `scrfd_state_dict_from_jax` /
  `retinaface_state_dict_from_jax`: head outputs within TOL (1e-5 of the
  largest value).
- The host code on the same arrays, exactly: SCRFD's `distance2bbox`,
  `distance2kps`, `decode_scrfd`; RetinaFace's priors, `decode_boxes`,
  `decode_landmarks` and `nms` (with tied scores).
- Both detectors end to end (`detect_fn` output), SCRFD through both of
  its resize branches (PIL, and the integer-index one with PIL made
  unimportable), RetinaFace at its 320 input from a 300x250 frame.
- The biubug6 `mobilenet0.25_Final.pth` map from a synthetic state dict,
  read from a `.pth` by both packages' readers.
- The traps, each with its other choice outside the tolerance: SCRFD's
  GroupNorm eps 1e-6 (not 1e-5) at a group variance near 1e-6; the
  ResNetV1e downsample (2x2 average pool, then the 1x1 conv, only at stride
  2); `jax.image.resize`'s nearest (torch's `nearest-exact`, not
  `nearest`) at 5 -> 9; RetinaFace's `_leaky` rule (leaky 0.1 up to 64
  channels, ReLU above: at the shipped width every ConvBN has at most 64
  channels, so the rule's ReLU side is held at `out_ch=128`); SSH's one
  ReLU after the concatenation; the integer-index input resize (PIL's
  bilinear reads outside); the score thresholds (SCRFD keeps a score equal
  to it, RetinaFace does not); anchor centres repeated per anchor (tiled
  reads outside).
"""

import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from flax import linen as nn

from adaface_tpu.models import retinaface as jr
from adaface_tpu.models import scrfd as js

from adaface_tpu_torch.interop.from_jax import (
    retinaface_state_dict_from_jax,
    scrfd_state_dict_from_jax,
)
from adaface_tpu_torch.interop.torch_pickle import load_torch_checkpoint
from adaface_tpu_torch.models import retinaface as tr
from adaface_tpu_torch.models import scrfd as ts
from adaface_tpu_torch.models.flax_init import seeded

from torch_face_helpers import biubug6_state_dict, flax_tree, perturb_, rel_err

torch.set_num_threads(2)

TOL = 1e-5


def _scrfd_pair(cfg_name, seed=0):
    """(port SCRFD, JAX params) with the same perturbed weights."""
    m = perturb_(ts.init_scrfd(seed, getattr(ts.SCRFDConfig, cfg_name)()), seed + 1)
    params, _ = flax_tree(m)
    return m, params


@pytest.fixture(scope="module")
def tiny_scrfd():
    return _scrfd_pair("tiny")


@pytest.fixture(scope="module")
def retina():
    m = perturb_(tr.init_retinaface(3), 4)
    params, stats = flax_tree(m)
    return m, {"params": params, "batch_stats": stats}


def _frame(seed, h, w, scale=1.0, c=3):
    return (np.random.default_rng(seed).standard_normal((1, h, w, c)) * scale).astype(np.float32)


@pytest.mark.parametrize("cfg_name", ["tiny", "scrfd_10g"])
def test_scrfd_carried_over_matches_jax(cfg_name):
    port, params = _scrfd_pair(cfg_name, seed=10)
    sd = scrfd_state_dict_from_jax(params)
    assert sd.keys() == port.state_dict().keys()
    for k, v in port.state_dict().items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)
    fresh = ts.SCRFD(port.cfg).eval()
    fresh.load_state_dict(sd, strict=True)
    x = _frame(0, 64, 64)
    ref = jax.jit(js.SCRFD(js.SCRFDConfig(**vars(port.cfg))).apply)({"params": params}, x)
    with torch.no_grad():
        got = fresh(torch.from_numpy(x))
    for stride, r, g in zip(ts.STRIDES, ref, got):
        for a, b in zip(r, g):
            assert b.shape == a.shape and b.shape[1] == 64 // stride
            assert rel_err(b.numpy(), a) < TOL


def test_scrfd_groupnorm_eps_is_flax_default():
    """A group variance near 1e-6: eps 1e-6 against flax's GroupNorm
    within TOL, torch's default 1e-5 outside it."""
    head = ts.SCRFDHead(ts.SCRFDConfig.tiny())
    gn = perturb_(head, 5).cls_gn_0
    g = np.random.default_rng(1)
    x = (g.standard_normal((1, 6, 6, 16)) * 1e-3 + g.standard_normal(16) * 1e-3).astype(np.float32)
    ref = np.asarray(nn.GroupNorm(num_groups=4).apply(
        {"params": {"scale": gn.weight.detach().numpy(), "bias": gn.bias.detach().numpy()}}, x))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = gn(xt).permute(0, 2, 3, 1).numpy()
        other = F.group_norm(xt, 4, gn.weight, gn.bias, 1e-5).permute(0, 2, 3, 1).numpy()
    assert gn.eps == 1e-6
    assert rel_err(got, ref) < TOL
    assert rel_err(other, ref) > 100 * TOL


def test_batchnorm_eps_is_1e5():
    """SCRFD's BN and RetinaFace's BatchNorm at running variances near 1e-5:
    eps 1e-5 against JAX's within TOL, 1e-6 (flax's GroupNorm default)
    outside it."""
    g = np.random.default_rng(3)
    x = g.standard_normal((1, 4, 4, 8)).astype(np.float32) * 1e-2
    mean, var = (g.normal(0, 1e-3, 8).astype(np.float32),
                 g.uniform(0.5e-5, 2e-5, 8).astype(np.float32))
    scale, bias = g.uniform(0.8, 1.2, 8).astype(np.float32), g.normal(0, 0.1, 8).astype(np.float32)
    ref_scrfd = np.asarray(js.BN().apply(
        {"params": {"mean": mean, "var": var, "scale": scale, "bias": bias}}, x))
    ref_retina = np.asarray(nn.BatchNorm(use_running_average=True).apply(
        {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean, "var": var}}, x))
    convbn = tr.ConvBN(8, 8, relu=False).eval()
    bn = ts.BN(8)
    with torch.no_grad():
        for t, a in ((bn.mean, mean), (bn.var, var), (bn.weight, scale), (bn.bias, bias),
                     (convbn.bn.running_mean, mean), (convbn.bn.running_var, var),
                     (convbn.bn.weight, scale), (convbn.bn.bias, bias)):
            t.copy_(torch.from_numpy(a))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        for mod, ref in ((bn, ref_scrfd), (convbn.bn, ref_retina)):
            assert mod.eps == 1e-5
            assert rel_err(mod(xt).permute(0, 2, 3, 1).numpy(), ref) < TOL
            mod.eps = 1e-6
            assert rel_err(mod(xt).permute(0, 2, 3, 1).numpy(), ref) > 100 * TOL
            mod.eps = 1e-5


@pytest.mark.parametrize("cin, planes, stride", [(16, 24, 2), (16, 24, 1), (24, 24, 1)])
def test_scrfd_downsample_pools_then_projects(cin, planes, stride):
    blk = perturb_(seeded(ts.BasicBlock(cin, planes, stride), 7), 8)
    params, _ = flax_tree(blk)
    x = _frame(2, 8, 8, c=cin)
    ref = np.asarray(js.BasicBlock(planes, stride).apply({"params": params}, x))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = blk(xt).permute(0, 2, 3, 1).numpy()
        assert rel_err(got, ref) < TOL
        if stride != 1:
            # the other choice: a strided 1x1 projection, no average pool
            h = blk.bn2(blk.conv2(F.relu(blk.bn1(blk.conv1(xt)))))
            ident = blk.ds_bn(F.conv2d(xt, blk.ds_conv.weight, stride=2))
            other = F.relu(h + ident).permute(0, 2, 3, 1).numpy()
            assert rel_err(other, ref) > 100 * TOL


def test_nearest_resize_is_half_pixel():
    """`jax.image.resize(..., "nearest")` at 5 -> 9 is torch's
    `nearest-exact`; `nearest` reads other rows."""
    x = _frame(3, 5, 5)
    ref = np.asarray(jax.image.resize(x, (1, 9, 9, 3), "nearest"))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = F.interpolate(xt, size=(9, 9), mode="nearest-exact").permute(0, 2, 3, 1).numpy()
    other = F.interpolate(xt, size=(9, 9), mode="nearest").permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, ref)
    assert rel_err(other, ref) > 0.1


def test_scrfd_decode_matches_jax():
    g = np.random.default_rng(4)
    outs = []
    for stride in ts.STRIDES:
        h = w = 96 // stride
        outs.append((g.uniform(0.3, 0.7, (1, h, w, 2)).astype(np.float32),
                     g.uniform(0, 3, (1, h, w, 8)).astype(np.float32),
                     g.normal(0, 2, (1, h, w, 20)).astype(np.float32)))
    outs[0][0][0, 1, 1, 0] = 0.5  # a score equal to the threshold is kept
    ref = js.decode_scrfd(outs, 0.5, 0.4)
    got = ts.decode_scrfd(outs, 0.5, 0.4)
    assert len(got) == len(ref) > 5
    assert any(s == 0.5 for _, _, s in got)
    for (b1, k1, s1), (b2, k2, s2) in zip(got, ref):
        np.testing.assert_array_equal(b1, b2)
        np.testing.assert_array_equal(k1, k2)
        assert s1 == s2
    c = g.uniform(0, 50, (7, 2)).astype(np.float32)
    d = g.uniform(0, 5, (7, 4)).astype(np.float32)
    np.testing.assert_array_equal(ts.distance2bbox(c, d), js.distance2bbox(c, d))
    d10 = g.normal(0, 5, (7, 10)).astype(np.float32)
    np.testing.assert_array_equal(ts.distance2kps(c, d10), js.distance2kps(c, d10))
    # the other choice: anchor centres tiled, not repeated per anchor
    stride, (score, bbox, _) = ts.STRIDES[0], outs[0]
    h, w = score.shape[1:3]
    yy, xx = np.mgrid[:h, :w]
    centers = np.stack([xx.ravel(), yy.ravel()], axis=-1) * stride
    rep, tiled = np.repeat(centers, 2, axis=0), np.tile(centers, (2, 1))
    dist = bbox[0].reshape(-1, 4) * stride
    assert not np.allclose(ts.distance2bbox(tiled, dist), ts.distance2bbox(rep, dist))


def test_retinaface_host_decode_and_nms_match_jax():
    for h, w in ((320, 320), (96, 80)):
        np.testing.assert_array_equal(tr.make_priors(h, w), jr.make_priors(h, w))
    pri = tr.make_priors(96, 80)
    g = np.random.default_rng(5)
    loc = g.normal(0, 1, (len(pri), 4)).astype(np.float32)
    ldm = g.normal(0, 1, (len(pri), 10)).astype(np.float32)
    np.testing.assert_array_equal(tr.decode_boxes(loc, pri), jr.decode_boxes(loc, pri))
    np.testing.assert_array_equal(tr.decode_landmarks(ldm, pri), jr.decode_landmarks(ldm, pri))
    boxes = tr.decode_boxes(loc, pri)
    scores = np.round(g.uniform(0, 1, len(pri)), 1).astype(np.float32)  # many ties
    for thresh in (0.2, 0.4, 0.7):
        keep = tr.nms(boxes, scores, thresh)
        assert keep == jr.nms(boxes, scores, thresh)
        assert len(keep) > 3


def test_retinaface_carried_over_matches_jax(retina):
    port, variables = retina
    sd = retinaface_state_dict_from_jax(variables)
    assert sd.keys() == port.state_dict().keys()
    for k, v in port.state_dict().items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)
    # a depthwise HWIO [3, 3, 1, C] kernel arrives as [C, 1, 3, 3]
    assert variables["params"]["stage1_1"]["dw_conv"]["kernel"].shape == (3, 3, 1, 8)
    assert sd["stage1_1.dw_conv.weight"].shape == (8, 1, 3, 3)
    x = _frame(6, 96, 80, 60.0)
    ref = jax.jit(jr.RetinaFace().apply)(variables, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for r, g in zip(ref, got):
        for a, b in zip(r, g):
            assert rel_err(b.numpy(), a) < TOL


def test_retinaface_leaky_rule_and_ssh_relu():
    """`_leaky` at out_ch 128 (the FPN's ConvBNs are ReLU there, the SSH's
    32- and 16-channel ones leaky) and at the shipped 64; the other
    choices (leaky everywhere at 128, ReLU everywhere at 64, no ReLU after
    SSH's concatenation) read outside TOL."""
    x = _frame(7, 64, 64, 60.0)
    for out_ch in (128, 64):
        port = perturb_(seeded(tr.RetinaFace(out_ch=out_ch), 10), 11, bias_std=0.3)
        params, stats = flax_tree(port)
        ref = jax.jit(jr.RetinaFace(out_ch=out_ch).apply)(
            {"params": params, "batch_stats": stats}, x)
        ref = np.concatenate([np.asarray(o[1]).reshape(-1) for o in ref])

        def run():
            with torch.no_grad():
                return np.concatenate([o[1].reshape(-1).numpy()
                                       for o in port(torch.from_numpy(x))])

        assert rel_err(run(), ref) < TOL
        convbns = [m for m in port.modules() if isinstance(m, tr.ConvBN) and m.slope is not None]
        assert any(m.slope == 0.0 for m in convbns) == (out_ch == 128)
        saved = [m.slope for m in convbns]
        for m in convbns:
            m.slope = 0.1 if out_ch == 128 else 0.0
        assert rel_err(run(), ref) > 100 * TOL
        for m, s in zip(convbns, saved):
            m.slope = s
    orig = tr.SSH.forward
    try:
        tr.SSH.forward = lambda self, h: torch.cat(
            [self.conv3x3(h), self.conv5x5_2(self.conv5x5_1(h)),
             self.conv7x7_3(self.conv7x7_2(self.conv5x5_1(h)))], dim=1)
        assert rel_err(run(), ref) > 100 * TOL
    finally:
        tr.SSH.forward = orig
    assert rel_err(run(), ref) < TOL


def _jax_retina_detector(variables, **kw):
    return jr.RetinaFaceDetector(jr.RetinaFace(), variables, **kw)


def test_retinaface_detector_matches_jax(retina):
    port, variables = retina
    img = np.random.default_rng(8).integers(0, 256, (300, 250, 3), dtype=np.uint8)
    tdet = tr.RetinaFaceDetector(port, score_thresh=0.5)
    jdet = _jax_retina_detector(variables, score_thresh=0.5)
    np.testing.assert_array_equal(tdet.prepare(img), np.asarray(jdet_input(img))[0])
    cls, box, ldm = (np.asarray(a)[0] for a in jdet._fwd(variables, jdet_input(img)))
    tcls, tbox, tldm = tdet.heads(img)
    for a, b in ((tcls, cls), (tbox, box), (tldm, ldm)):
        assert rel_err(a, b) < TOL
    # scores near the threshold would let fp32 roundoff decide: none is
    margin = np.abs(cls[:, 1] - 0.5).min()
    assert margin > 1e-4, margin
    got, ref = tdet(img), jdet(img)
    assert len(got) == len(ref) > 0
    for (b1, l1, s1), (b2, l2, s2) in zip(got, ref):
        np.testing.assert_allclose(b1, b2, rtol=0, atol=TOL * 300)
        np.testing.assert_allclose(l1, l2, rtol=0, atol=TOL * 300)
        assert abs(s1 - s2) < TOL
    # the other choice: PIL's bilinear resize in place of the index sampling
    from PIL import Image

    pil = np.asarray(Image.fromarray(img).resize((320, 320), Image.BILINEAR), np.float32)
    with torch.no_grad():
        outs = port(torch.from_numpy(pil[None] - np.asarray(tr.RGB_MEAN, np.float32)))
    other = torch.cat([o[1] for o in outs], 1)[0].numpy()
    assert rel_err(other, box) > 100 * TOL


def jdet_input(img):
    ri = (np.arange(320) * (img.shape[0] / 320)).astype(np.int64)
    ci = (np.arange(320) * (img.shape[1] / 320)).astype(np.int64)
    return jnp.asarray((img[ri][:, ci].astype(np.float32) - np.asarray(jr.RGB_MEAN))[None])


def test_retinaface_score_threshold_is_strict(retina):
    """A score equal to the threshold is dropped (SCRFD keeps it): the
    decode against JAX's detector fed the same head outputs."""
    port, variables = retina
    n = len(tr.make_priors(320, 320))
    g = np.random.default_rng(9)
    cls = np.stack([np.zeros(n), g.uniform(0.3, 0.7, n)], -1).astype(np.float32)
    cls[:40, 1] = 0.5
    box = g.normal(0, 1, (n, 4)).astype(np.float32)
    ldm = g.normal(0, 1, (n, 10)).astype(np.float32)
    tdet = tr.RetinaFaceDetector(port, score_thresh=0.5)
    jdet = _jax_retina_detector(variables, score_thresh=0.5)
    jdet._fwd = lambda v, x: (cls[None], box[None], ldm[None])
    img = np.zeros((200, 180, 3), np.uint8)
    ref = jdet(img)
    got = tdet.decode(img.shape, cls, box, ldm)
    assert len(got) == len(ref) > 3
    assert all(s != 0.5 for _, _, s in got)
    for (b1, l1, s1), (b2, l2, s2) in zip(got, ref):
        np.testing.assert_array_equal(b1, b2)
        np.testing.assert_array_equal(l1, l2)
        assert s1 == s2


@pytest.mark.parametrize("branch", ["pil", "index"])
def test_scrfd_detector_matches_jax(tiny_scrfd, branch, monkeypatch):
    port, params = tiny_scrfd
    if branch == "index":
        monkeypatch.setitem(sys.modules, "PIL", None)
    img = np.random.default_rng(11).integers(0, 256, (50, 40, 3), dtype=np.uint8)
    tdet = ts.SCRFDDetector(port, input_size=(64, 64), score_thresh=0.5)
    jdet = js.SCRFDDetector(js.SCRFD(js.SCRFDConfig.tiny()), params, input_size=(64, 64),
                            score_thresh=0.5)
    x, scale = tdet.prepare(img)
    assert scale == 64 / 50
    # the letterbox at the top left: the padding columns stay -127.5/128
    assert (x[:, 51:] == -127.5 / 128).all() and not (x[:, :51] == -127.5 / 128).all()
    ref_heads = jdet._fwd(params, jnp.asarray(x[None]))
    for r, g in zip(ref_heads, tdet.heads(x)):
        for a, b in zip(r, g):
            assert rel_err(b, a) < TOL
    scores = np.concatenate([np.asarray(r[0]).reshape(-1) for r in ref_heads])
    assert np.abs(scores - 0.5).min() > 1e-4
    got, ref = tdet(img), jdet(img)
    assert len(got) == len(ref) > 0
    for (b1, k1, s1), (b2, k2, s2) in zip(got, ref):
        np.testing.assert_allclose(b1, b2, rtol=0, atol=TOL * 64)
        np.testing.assert_allclose(k1, k2, rtol=0, atol=TOL * 64)
        assert abs(s1 - s2) < TOL
    # the other choices: a centred letterbox, (x - 127.5) / 127.5
    ref = np.concatenate([np.asarray(a).reshape(-1) for r in ref_heads for a in r])
    flat = lambda xx: np.concatenate([a.reshape(-1) for h in tdet.heads(xx) for a in h])
    centred = np.full_like(x, -127.5 / 128)
    centred[:, 6:57] = x[:, :51]  # the 50x40 frame at 64x51
    other_norm = (x * 128.0 + 127.5 - 127.5) / 127.5
    for other in (centred, other_norm):
        assert rel_err(flat(other.astype(np.float32)), ref) > 100 * TOL
    # at the letterbox size the resize is a copy, with or without PIL
    same = np.random.default_rng(12).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    np.testing.assert_array_equal(ts.letterbox_resize(same, 64, 64), same)


def test_biubug6_map_matches_jax(tmp_path):
    """A synthetic `mobilenet0.25_Final.pth`, written by torch.save and read
    by each package's own reader and map: the same head outputs."""
    from adaface_tpu.interop.torch_pickle import load_torch_checkpoint as j_load

    path = str(tmp_path / "mobilenet0.25_Final.pth")
    torch.save(biubug6_state_dict(13), path)
    port = tr.RetinaFace().eval()
    port.load_state_dict(tr.map_retinaface_torch_params(load_torch_checkpoint(path)),
                         strict=True)
    assert int(port.stage1_0.bn.num_batches_tracked) == 1000
    variables = jr.map_retinaface_torch_params(j_load(path))
    x = _frame(14, 64, 64, 60.0)
    ref = jax.jit(jr.RetinaFace().apply)(variables, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for r, g in zip(ref, got):
        for a, b in zip(r, g):
            assert rel_err(b.numpy(), a) < TOL
    sd = biubug6_state_dict(13)
    del sd["body.stage1.0.1.num_batches_tracked"], sd["ssh2.conv5X5_1.1.num_batches_tracked"]
    mapped = tr.map_retinaface_torch_params(sd)
    assert int(mapped["stage1_0.bn.num_batches_tracked"]) == 0
    del sd["fpn.merge1.0.weight"]
    with pytest.raises(KeyError):
        tr.map_retinaface_torch_params(sd)
