"""Port parity of the face stack, fp32 on the CPU: `interop/onnx_weights.py`,
`models/arcface.py` and `face_app.py` against the JAX package's.

- The ONNX reader returns the same initializers and nodes as JAX's on the
  same bytes (raw, float_data and int64 tensors).
- Tiny IResNets (16 and 32 pixels: 1x1 and 2x2 last grids) carried over by
  `interop/from_jax.iresnet_state_dict_from_jax` match JAX's outputs within
  1e-5 of the largest value.
- The ONNX fc order: an NCHW torch oracle at 32 pixels (insightface's layout,
  the features flattened C, H, W) written as an ONNX file in insightface's
  node order; the port's `map_arcface_onnx_params` matches the oracle within
  ONNX_TOL (1e-5 of the largest value), and JAX's map, which reads the Gemm
  weight for H, W, C features, lies outside it (a deliberate difference,
  ROADMAP queue 3). At 16 pixels (a 1x1 grid) both maps agree.
- `estimate_norm` equal to JAX's; both warps (host and tensor) against JAX's
  device warp on uint8 (equal) and float images (within 1e-5).
- `FaceApp.get` / `embed_image` against JAX's `FaceApp` on the same params:
  three faces from a stub detector (JAX pads the count to 4 and the canvas
  to 256), a 300x200 image with a face over the edge (JAX pads the canvas,
  the port reads zeros outside: the same), embeddings within 1e-5; the
  degenerate-landmark ValueError (coincident and singular).
- `default_face_app`: with `ARCFACE_ONNX` (the recognizer's config made tiny
  in both packages) the same embeddings as JAX's `scripts/filter_faces.py`;
  without it the tiny random recognizer and its note.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaface_tpu import face_app as jfa
from adaface_tpu.interop.onnx_weights import load_onnx_weights as j_load_onnx
from adaface_tpu.models import arcface as ja

from adaface_tpu_torch import face_app as tfa
from adaface_tpu_torch.interop.from_jax import iresnet_state_dict_from_jax
from adaface_tpu_torch.interop.onnx_weights import load_onnx_weights
from adaface_tpu_torch.models import arcface as ta

from test_face_stack import TorchIBasicBlock, _len_field, _node, _tensor

torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "..")
ONNX_TOL = 1e-5
TINY = dict(depths=(1, 1, 1, 1), channels=(8, 8, 16, 16), emb_dim=32)


def _jax_iresnet(size, seed=0):
    """A JAX tiny IResNet with randomized (non-identity) params."""
    cfg = ja.IResNetConfig(**TINY, input_size=size)
    model = ja.IResNet(cfg)
    p = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)))["params"]
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        a = np.asarray(a)
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
    return model, jax.tree_util.tree_map_with_path(perturb, p)


def _port_iresnet(jparams, size):
    cfg = ta.IResNetConfig.tiny(input_size=size)
    m = ta.IResNet(cfg).eval()
    m.load_state_dict(iresnet_state_dict_from_jax(jparams, cfg), strict=True)
    return m


def _close(got, ref, tol=1e-5):
    np.testing.assert_allclose(got, ref, atol=tol * np.abs(ref).max(), rtol=0)


def test_onnx_reader_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    w1 = rng.standard_normal((4, 3, 3, 3)).astype(np.float32)
    w2 = np.arange(6, dtype=np.int64)
    floats = rng.standard_normal(5).astype(np.float32)
    packed = b"".join(np.float32(v).tobytes() for v in floats)
    float_tensor = (_len_field(8, b"fd") + b"\x08\x05" + b"\x10\x01" + _len_field(4, packed))
    graph = (_len_field(5, _tensor("conv.w", w1)) + _len_field(5, _tensor("idx", w2))
             + _len_field(5, float_tensor)
             + _len_field(1, _node("Conv", ["x", "conv.w"], ["y"]))
             + _len_field(1, _node("Gemm", ["y", "fd"], ["z"])))
    path = tmp_path / "m.onnx"
    path.write_bytes(_len_field(7, graph))
    for with_graph in (False, True):
        got, want = load_onnx_weights(str(path), with_graph), j_load_onnx(str(path), with_graph)
        if with_graph:
            (got, gn), (want, wn) = got, want
            assert gn == wn and [n["op_type"] for n in gn] == ["Conv", "Gemm"]
        assert sorted(got) == sorted(want) == ["conv.w", "fd", "idx"]
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["fd"], floats)


@pytest.mark.parametrize("size", [16, 32])
def test_iresnet_carried_over_matches_jax(size):
    model, p = _jax_iresnet(size)
    x = np.random.default_rng(2).standard_normal((2, size, size, 3)).astype(np.float32)
    ref = np.asarray(model.apply({"params": p}, jnp.asarray(x)))
    with torch.no_grad():
        got = _port_iresnet(p, size)(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (2, 32)
    _close(got, ref)


# ------------------------------------------------------------ the ONNX order

class NCHWOracle(torch.nn.Module):
    """insightface's IResNet: NCHW features flattened C, H, W into the fc."""

    def __init__(self, size):
        super().__init__()
        ch = TINY["channels"]
        self.conv1 = torch.nn.Conv2d(3, ch[0], 3, 1, 1, bias=False)
        self.bn1 = torch.nn.BatchNorm2d(ch[0])
        self.prelu1 = torch.nn.PReLU(ch[0])
        blocks, in_ch = [], ch[0]
        for c in ch:
            blocks.append(TorchIBasicBlock(in_ch, c, 2))
            in_ch = c
        self.blocks = torch.nn.ModuleList(blocks)
        self.bn2 = torch.nn.BatchNorm2d(in_ch)
        g = size // 16
        self.fc = torch.nn.Linear(in_ch * g * g, TINY["emb_dim"])
        self.features = torch.nn.BatchNorm1d(TINY["emb_dim"])
        torch.manual_seed(size)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.BatchNorm1d)):
                    m.running_mean.uniform_(-0.2, 0.2)
                    m.running_var.uniform_(0.5, 1.5)
                    m.weight.uniform_(0.8, 1.2)
                    m.bias.uniform_(-0.1, 0.1)
        self.eval()

    def forward(self, x):
        x = self.prelu1(self.bn1(self.conv1(x)))
        for b in self.blocks:
            x = b(x)
        return self.features(self.fc(self.bn2(x).flatten(1)))


def write_oracle_onnx(path, oracle):
    """The oracle as an ONNX graph in insightface's node order."""
    inits, nodes = [], []
    arr = lambda t: t.detach().numpy().astype(np.float32)

    def add(op, *tensors):
        names = []
        for t in tensors:
            names.append(f"w{len(inits)}")
            inits.append(_tensor(names[-1], arr(t)))
        nodes.append(_node(op, ["x"] + names, [f"y{len(nodes)}"]))

    conv = lambda c: add("Conv", c.weight)
    bn = lambda b: add("BatchNormalization", b.weight, b.bias, b.running_mean, b.running_var)
    prelu = lambda p: add("PRelu", p.weight.reshape(-1, 1, 1))
    conv(oracle.conv1), bn(oracle.bn1), prelu(oracle.prelu1)
    for b in oracle.blocks:
        bn(b.bn1), conv(b.conv1), bn(b.bn2), prelu(b.prelu), conv(b.conv2), bn(b.bn3)
        conv(b.down[0]), bn(b.down[1])
    bn(oracle.bn2)
    add("Gemm", oracle.fc.weight, oracle.fc.bias)
    bn(oracle.features)
    graph = b"".join(_len_field(5, t) for t in inits) + b"".join(_len_field(1, n) for n in nodes)
    with open(path, "wb") as f:
        f.write(_len_field(7, graph))


@pytest.mark.parametrize("size", [16, 32])
def test_onnx_map_follows_the_files_fc_order(tmp_path, size):
    oracle = NCHWOracle(size)
    path = str(tmp_path / "r.onnx")
    write_oracle_onnx(path, oracle)
    x = np.random.default_rng(3).standard_normal((2, size, size, 3)).astype(np.float32)
    with torch.no_grad():
        ref = oracle(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    cfg = ta.IResNetConfig.tiny(input_size=size)
    m = ta.IResNet(cfg).eval()
    m.load_state_dict(ta.map_arcface_onnx_params(*load_onnx_weights(path, True), cfg),
                      strict=True)
    with torch.no_grad():
        got = m(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    _close(got, ref, ONNX_TOL)
    jcfg = ja.IResNetConfig(**TINY, input_size=size)
    jp = ja.map_arcface_onnx_params(*j_load_onnx(path, True), jcfg)
    jout = np.asarray(ja.IResNet(jcfg).apply({"params": jp}, jnp.asarray(x)))
    err = np.abs(jout - ref).max() / np.abs(ref).max()
    if size == 16:  # a 1x1 grid: the orders coincide
        assert err < ONNX_TOL
    else:
        assert err > 100 * ONNX_TOL, err


# ------------------------------------------------------------------ align

def test_estimate_norm_matches_jax():
    rng = np.random.default_rng(4)
    for size in (16, 112):
        lm = ja.ARCFACE_DST * rng.uniform(0.5, 3.0) + rng.normal(0, 3, (5, 2)) + 20
        np.testing.assert_array_equal(ta.estimate_norm(lm.astype(np.float32), size),
                                      ja.estimate_norm(lm.astype(np.float32), size))


def test_warps_match_jax():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 255, (37, 29, 3)).astype(np.uint8)
    th = 0.3
    Ms = np.stack([np.array([[1, 0, 0], [0, 1, 0]], np.float32),
                   np.array([[0.5, 0, 3.2], [0, 0.5, -1.7]], np.float32),
                   np.array([[np.cos(th), -np.sin(th), 4.0],
                             [np.sin(th), np.cos(th), 2.0]], np.float32),
                   ta.estimate_norm(ja.ARCFACE_DST * 0.3 + 2.0, 16)])
    for im in (img, img.astype(np.float32) + 0.25):
        ref = np.asarray(ja.warp_affine_jax(jnp.asarray(im), jnp.asarray(Ms), 16))
        got = ta.warp_affine_torch(torch.from_numpy(im), torch.from_numpy(Ms), 16).numpy()
        assert got.dtype == np.float32 and got.shape == (4, 16, 16, 3)
        if im.dtype == np.uint8:
            np.testing.assert_array_equal(got, ref)
        else:
            _close(got, ref)
        for i in range(len(Ms)):
            host_ref = ja.warp_affine(im, Ms[i], 16)
            np.testing.assert_array_equal(ta.warp_affine(im, Ms[i], 16), host_ref)


# -------------------------------------------------------------------- app

def _apps(size=16, detect_fn=None):
    model, p = _jax_iresnet(size, seed=1)
    kw = {} if detect_fn is None else {"detect_fn": detect_fn}
    return jfa.FaceApp(model, p, **kw), tfa.FaceApp(_port_iresnet(p, size), **kw)


def _same_faces(tf, jf):
    assert len(tf) == len(jf)
    for a, b in zip(tf, jf):
        np.testing.assert_array_equal(a.bbox, b.bbox)
        assert a.area == b.area and a.det_score == b.det_score
        _close(a.embedding, b.embedding)
        _close(a.normed_embedding, b.normed_embedding)


def test_face_app_matches_jax_on_several_faces():
    img = np.random.default_rng(7).integers(0, 255, (90, 70, 3)).astype(np.uint8)
    lm = ja.ARCFACE_DST * np.array([70 / 112.0, 90 / 112.0], np.float32) + [3.0, -2.0]

    def det3(image):  # 3 faces: JAX pads the count to 4
        return [(np.array([0, 0, 70, 90], np.float32), lm, 1.0),
                (np.array([5, 5, 40, 40], np.float32), lm * 0.9 + 5.0, 0.9),
                (np.array([0, 0, 80, 90], np.float32), lm * 1.05, 0.8)]

    japp, tapp = _apps(detect_fn=det3)
    _same_faces(tapp.get(img), japp.get(img))
    _close(tapp.embed_image(img), japp.embed_image(img))
    assert tapp.embed_image(img) is not None
    none_app = tfa.FaceApp(tapp.recognizer, detect_fn=lambda im: [])
    assert none_app.get(img) == [] and none_app.embed_image(img) is None


def test_face_app_face_over_the_edge_matches_jax():
    """A 300x200 image (JAX pads the canvas to 512x256) whose face's crop
    reaches past the right and bottom edges."""
    img = np.random.default_rng(8).integers(0, 255, (300, 200, 3)).astype(np.uint8)
    lm = ja.ARCFACE_DST * 1.2 + np.array([110.0, 200.0], np.float32)

    def det(image):
        return [(np.array([110, 200, 200, 300], np.float32), lm, 0.99)]

    japp, tapp = _apps(size=32, detect_fn=det)
    M = ta.estimate_norm(lm, 32)
    corner = np.linalg.inv(np.vstack([M, [0, 0, 1]]))[:2] @ np.array([31.0, 31.0, 1.0])
    assert corner[0] > 200 or corner[1] > 300  # the crop reads outside the image
    _same_faces(tapp.get(img), japp.get(img))
    full = _apps(size=32)
    _close(full[1].embed_image(img), full[0].embed_image(img))


def test_degenerate_landmarks_raise(monkeypatch):
    def coincident(image):
        return [(np.array([0, 0, 64, 64], np.float32),
                 np.tile(np.array([10.0, 10.0], np.float32), (5, 1)), 1.0)]

    img = np.zeros((64, 64, 3), np.uint8)
    _, tapp = _apps(detect_fn=coincident)
    with pytest.raises(ValueError, match="degenerate"):
        tapp.get(img)
    singular = np.array([[1e-13, 0, 5], [0, 1e-13, 5]], np.float32)
    monkeypatch.setattr(tfa, "estimate_norm", lambda lm, size: singular)
    with pytest.raises(ValueError, match="singular"):
        _apps()[1].get(img)


def _filter_faces_script():
    spec = importlib.util.spec_from_file_location(
        "jax_filter_faces", os.path.join(ROOT, "scripts", "filter_faces.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_default_face_app_with_and_without_onnx(tmp_path, monkeypatch, capsys):
    img = np.random.default_rng(9).integers(0, 255, (48, 40, 3)).astype(np.uint8)
    monkeypatch.delenv("ARCFACE_ONNX", raising=False)
    app = tfa.default_face_app(device="cpu")
    assert "no ARCFACE_ONNX" in capsys.readouterr().out
    assert app.recognizer.cfg == ta.IResNetConfig.tiny()
    e = app.embed_image(img)
    assert e.shape == (32,) and abs(np.linalg.norm(e) - 1) < 1e-5
    np.testing.assert_array_equal(tfa.default_face_app(device="cpu").embed_image(img), e)
    capsys.readouterr()

    # the recognizer's config made tiny (16 pixels: JAX's map is right on
    # a 1x1 grid) in both packages, from one ONNX file
    oracle = NCHWOracle(16)
    path = str(tmp_path / "arcface.onnx")
    write_oracle_onnx(path, oracle)
    monkeypatch.setenv("ARCFACE_ONNX", path)
    monkeypatch.setattr(ja.IResNetConfig, "iresnet100",
                        classmethod(lambda cls: cls(**TINY, input_size=16)))
    monkeypatch.setattr(ta.IResNetConfig, "iresnet100",
                        classmethod(lambda cls: cls(**TINY, input_size=16)))
    japp = _filter_faces_script().default_face_app()
    tapp = tfa.default_face_app(device="cpu")
    assert "no ARCFACE_ONNX" not in capsys.readouterr().out
    _close(tapp.embed_image(img), japp.embed_image(img))
