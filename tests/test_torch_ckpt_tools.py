"""The port's checkpoint and embedding tools against the JAX package's scripts
on the same input files (`scripts/{export_embeddings,merge_embeddings,avgemb,
chk_ckpt_weights,modeldiff,repl_component}.py`, their command lines run
in-process with `runpy`), and `utils.calc_stats` / `count_params` against
`adaface_tpu/utils`:

- export, static: the same tokens, counts, background strings and scores,
  the embeddings within 1e-6 of JAX's, and the traps: they are the computed
  [16, K, D] embeddings (not the embedder's parameters) and a conv-attention
  kernel size of 0 is written as None; the `.pt` loads back through
  `load_reference_checkpoint`;
- export, `--zs`: the port's `subj_basis_<tag>.pt` gives JAX's state dicts
  (from its `.pkl` of the same generators) array for array;
- merge: the same `.npz` (header and arrays) from `.npz` and reference `.pt`
  inputs; every placeholder renumbered from 49408, collisions renamed;
- avgemb: globs sorted by mtime and `--last_n`, the `.npz` bit for bit;
- chk_ckpt_weights and modeldiff: the same lines (`gs-(\\d+)` read as a
  number; `.npz` and torch `.ckpt` inputs, bf16 among them);
- repl_component: the bundle's arrays equal JAX's (flax paths carried across
  by `interop/from_jax.py`) with the text tower replaced; `--vae` splices a
  bf16 VAE in (JAX's script raises there);
- calc_stats: JAX's line and (mean, population std, min, max); torch's
  default std (ddof 1) falls outside; count_params of a module and of a
  tree."""

import dataclasses
import json
import os
import pickle
import runpy
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adaface_tpu import utils as jutils
from adaface_tpu.interop.subj_basis import map_subj_basis_generator as jmap_sbg
from adaface_tpu.models.unet import UNetConfig as JUNetConfig
from adaface_tpu.models.vae import VAEConfig as JVAEConfig

from adaface_tpu_torch import utils as tutils
from adaface_tpu_torch.data.tokenizer import HashTokenizer
from adaface_tpu_torch.interop import from_jax
from adaface_tpu_torch.interop.checkpoint_io import save_safetensors
from adaface_tpu_torch.interop.hf_clip import hf_clip_text_state_dict
from adaface_tpu_torch.interop.sd_vae import ldm_vae_state_dict
from adaface_tpu_torch.interop.subj_basis import map_subj_basis_generator
from adaface_tpu_torch.models.clip_text import CLIPTextConfig
from adaface_tpu_torch.models.unet import UNetConfig
from adaface_tpu_torch.models.vae import VAEConfig
from adaface_tpu_torch.personalization.embedding_manager import EmbeddingManager
from adaface_tpu_torch.personalization.static_embedding import (compute_static_embedding,
                                                                embedder_leaves)
from adaface_tpu_torch.pipeline import StableDiffusionPipeline
from adaface_tpu_torch.tools import (avgemb, chk_ckpt_weights, export_embeddings,
                                     merge_embeddings, modeldiff, repl_component)
from tests import torch_serve_helpers as helpers
from tests.test_subj_basis_interop import synth_bg_flat, synth_fg_flat

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")


def run_jax(monkeypatch, capsys, name, argv):
    """`python scripts/<name>.py argv`, in-process; its standard output."""
    monkeypatch.setattr(sys, "argv", [name] + list(argv))
    monkeypatch.setattr(sys, "path", list(sys.path))
    capsys.readouterr()
    try:
        runpy.run_path(os.path.join(SCRIPTS, f"{name}.py"), run_name="__main__")
    except SystemExit as e:
        assert e.code in (0, None), e.code
    return capsys.readouterr().out


def run_port(capsys, main, argv):
    capsys.readouterr()
    assert main(list(argv)) == 0
    return capsys.readouterr().out


def _npz(path, seed, strings=("z",), K=2, D=32, bg=(), conv_ks=-1, scores=None):
    mgr = EmbeddingManager()
    for i, s in enumerate(strings):
        mgr.add_placeholder(s, token_id=49408 + i, num_vectors=K, emb_dim=D, rank=4,
                            generator=torch.Generator().manual_seed(seed + i),
                            is_background=s in bg)
        mgr.emb_global_scale_scores[s] = float((scores or {}).get(s, 0.0))
    mgr.use_conv_attn_kernel_size = conv_ks
    mgr.save_native(str(path))
    return str(path)


def _same_npz(a, b):
    za, zb = np.load(a), np.load(b)
    assert sorted(za.files) == sorted(zb.files)
    assert json.loads(bytes(za["__header__"])) == json.loads(bytes(zb["__header__"]))
    for k in za.files:
        assert za[k].dtype == zb[k].dtype and np.array_equal(za[k], zb[k]), k


# ------------------------------------------------------------------ export
@pytest.mark.parametrize("conv_ks", [0, 3])
def test_export_static_equals_jax(tmp_path, monkeypatch, capsys, conv_ks):
    src = _npz(tmp_path / "e.npz", 1, strings=("z", "y"), K=3, bg=("y",), conv_ks=conv_ks,
               scores={"z": 0.25, "y": -1.5})
    jpt, tpt = str(tmp_path / "jax.pt"), str(tmp_path / "port.pt")
    jout = run_jax(monkeypatch, capsys, "export_embeddings", [src, "--out", jpt])
    tout = run_port(capsys, export_embeddings.main, [src, "--out", tpt])
    assert tout.replace(tpt, "<o>") == jout.replace(jpt, "<o>")
    j, t = torch.load(jpt, weights_only=False), torch.load(tpt, weights_only=False)
    assert sorted(t) == sorted(j)
    assert {k: int(v) for k, v in t["string_to_token"].items()} == \
        {k: int(v) for k, v in j["string_to_token"].items()} == {"z": 49408, "y": 49409}
    assert t["token2num_vectors"] == j["token2num_vectors"] == {"z": 3, "y": 3}
    assert t["background_strings"] == j["background_strings"] == ["y"]
    assert t["use_conv_attn_kernel_size"] == j["use_conv_attn_kernel_size"] == \
        (None if conv_ks == 0 else conv_ks)  # 0 is written as None
    assert torch.equal(t["emb_global_scale_scores"], j["emb_global_scale_scores"])
    assert isinstance(t["string_to_static_embedder"], torch.nn.ParameterDict)
    mgr = EmbeddingManager.load_native(src)
    for s in ("z", "y"):
        got = t["string_to_static_embedder"][s].detach()
        np.testing.assert_allclose(got.numpy(), j["string_to_static_embedder"][s].detach().numpy(),
                                   rtol=0, atol=1e-6)
        # the computed embeddings [16, K, D], not the embedder's parameters
        assert torch.equal(got, compute_static_embedding(mgr.embedders[s]))
        assert got.shape == (16, 3, 32)
        assert not any(tuple(p.shape) == tuple(got.shape) and torch.allclose(p, got)
                       for _, p in embedder_leaves(mgr.embedders[s]))
    back = EmbeddingManager().load_reference_checkpoint(tpt)  # ids in the dict's order
    assert {s: (i.num_vectors, i.is_background) for s, i in back.placeholders.items()} \
        == {"z": (3, False), "y": (3, True)}
    assert sorted(i.token_id for i in back.placeholders.values()) == [49408, 49409]
    assert back.use_conv_attn_kernel_size == (-1 if conv_ks == 0 else conv_ks)


def test_export_zs_equals_jax(tmp_path, monkeypatch, capsys):
    flats = {"z": synth_fg_flat(), "y": synth_bg_flat()}
    pkl = str(tmp_path / "subj_basis_gs-9.pkl")
    with open(pkl, "wb") as f:
        pickle.dump({"generator_params": {n: jmap_sbg(fl)[0] for n, fl in flats.items()},
                     "global_step": 9}, f)
    port_ckpt = str(tmp_path / "subj_basis_gs-9.pt")
    torch.save({"generators": {n: map_subj_basis_generator(fl)[0] for n, fl in flats.items()},
                "global_step": 9, "use_prodigy": True}, port_ckpt)
    jpt, tpt = str(tmp_path / "jax.pt"), str(tmp_path / "port.pt")
    jout = run_jax(monkeypatch, capsys, "export_embeddings", [pkl, "--zs", "--out", jpt])
    tout = run_port(capsys, export_embeddings.main, [port_ckpt, "--zs", "--out", tpt])
    assert tout.replace(tpt, "<o>") == jout.replace(jpt, "<o>")
    j, t = torch.load(jpt, weights_only=False), torch.load(tpt, weights_only=True)
    for k in ("placeholder_strings", "background_strings", "global_step", "do_zero_shot"):
        assert t[k] == j[k], k
    assert t["background_strings"] == ["y"]
    js, ts = (c["string_to_subj_basis_generator_state_dicts"] for c in (j, t))
    assert sorted(ts) == sorted(js) == ["y", "z"]
    for n in ts:
        assert sorted(ts[n]) == sorted(js[n]) == sorted(flats[n]), n
        for k in ts[n]:
            assert torch.equal(ts[n][k], js[n][k]), (n, k)


# -------------------------------------------------------- merge, avg, chk
def test_merge_equals_jax(tmp_path, monkeypatch, capsys):
    a = _npz(tmp_path / "a.npz", 0, strings=("z",))
    b = _npz(tmp_path / "b.npz", 3, strings=("y", "z"), scores={"y": 0.5})
    g = np.random.default_rng(4)
    ref = str(tmp_path / "c.pt")
    helpers.save_reference_embeddings(ref, {"z": {
        "basis_rand_weights": g.standard_normal((16, 2, 4)).astype(np.float32),
        "basis_comm_weights": g.standard_normal((1, 2, 4)).astype(np.float32),
        "basis_vecs": g.standard_normal((2, 4, 32)).astype(np.float32),
        "pre_vecs": None, "bias": g.standard_normal((16, 2, 32)).astype(np.float32)}},
        scores={"z": 0.75})
    jnpz, tnpz = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    argv = [a, b, ref]
    jout = run_jax(monkeypatch, capsys, "merge_embeddings", argv + ["--out", jnpz])
    tout = run_port(capsys, merge_embeddings.main, argv + ["--out", tnpz])
    assert tout.replace(tnpz, "<o>") == jout.replace(jnpz, "<o>")
    assert "z -> z2 (collision)" in tout and "z -> z3 (collision)" in tout
    _same_npz(tnpz, jnpz)
    m = EmbeddingManager.load_native(tnpz)
    # every placeholder renumbered in input order, not only the colliding ones
    assert [(s, i.token_id) for s, i in m.placeholders.items()] == \
        [("z", 49408), ("y", 49409), ("z2", 49410), ("z3", 49411)]
    assert m.emb_global_scale_scores["z3"] == 0.75


def test_avgemb_equals_jax(tmp_path, monkeypatch, capsys):
    paths = [_npz(tmp_path / f"embeddings_gs-{n}.npz", n, K=2) for n in (100, 200, 300)]
    for p, mtime in zip(paths, (30, 10, 20)):  # mtime order: 200, 300, 100
        os.utime(p, (mtime, mtime))
    glob_arg = str(tmp_path / "embeddings_gs-*.npz")
    jnpz, tnpz = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jout = run_jax(monkeypatch, capsys, "avgemb", [glob_arg, "--last_n", "2", "--out", jnpz])
    tout = run_port(capsys, avgemb.main, [glob_arg, "--last_n", "2", "--out", tnpz])
    assert tout.replace(tnpz, "<o>") == jout.replace(jnpz, "<o>")
    _same_npz(tnpz, jnpz)
    newest = [EmbeddingManager.load_native(p).embedders["z"] for p in (paths[2], paths[0])]
    got = EmbeddingManager.load_native(tnpz).embedders["z"]
    want = (newest[0].bias.numpy() + newest[1].bias.numpy()) / 2
    np.testing.assert_allclose(got.bias.numpy(), want, rtol=0, atol=1e-7)


def test_chk_ckpt_weights_equals_jax(tmp_path, monkeypatch, capsys):
    paths = [_npz(tmp_path / name, i, strings=("z", "y"))
             for i, name in enumerate(["embeddings_gs-100.npz", "embeddings_gs-20.npz",
                                       "embeddings_last.npz"])]
    jout = run_jax(monkeypatch, capsys, "chk_ckpt_weights", [str(tmp_path / "*.npz")])
    tout = run_port(capsys, chk_ckpt_weights.main, [str(tmp_path / "*.npz")])
    assert tout == jout
    # gs-20 before gs-100: the step read as a number, not the name's order
    names = [ln.split(":")[0] for ln in tout.splitlines()]
    assert names.index("embeddings_gs-20.npz") < names.index("embeddings_gs-100.npz")
    assert sorted(os.path.basename(p) for p in paths)[0] == "embeddings_gs-100.npz"


def _ckpt(path, sd, extra=None):
    torch.save({"state_dict": sd, "global_step": 3, **(extra or {})}, path)
    return str(path)


def test_modeldiff_equals_jax(tmp_path, monkeypatch, capsys):
    g = torch.Generator().manual_seed(0)
    a = {f"model.layer{i}.weight": torch.randn(8, 4, generator=g) for i in range(6)}
    a["model.half"] = torch.randn(5, generator=g).to(torch.bfloat16)
    b = {k: v + (0.1 * i) * torch.ones_like(v) for i, (k, v) in enumerate(a.items())}
    a["model.only_a"], b["model.only_b"], b["model.only_b2"] = (torch.ones(2),) * 3
    b["model.layer5.weight"] = torch.zeros(3)  # a shape mismatch is left out
    pa, pb = _ckpt(tmp_path / "a.ckpt", a), _ckpt(tmp_path / "b.ckpt", b)
    outs = []
    for argv in ([pa, pb, "--top", "4"], [pa, pb],
                 [_npz(tmp_path / "x.npz", 0), _npz(tmp_path / "y.npz", 5), "--top", "3"]):
        jout = run_jax(monkeypatch, capsys, "modeldiff", argv)
        outs.append(run_port(capsys, modeldiff.main, argv))
        assert outs[-1] == jout and outs[-1].strip()
    lines = outs[1].splitlines()
    assert lines[-2:] == ["only in A: 1 keys", "only in B: 2 keys"]
    assert len(lines) == 6 + 2 and "layer5" not in outs[1]  # the shape mismatch left out
    assert len(outs[0].splitlines()) == 4 + 2


# ------------------------------------------------------------- repl_component
UNET_KW = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
               attention_levels=(0, 1), num_heads=4, context_dim=64)
VAE_KW = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=4, embed_dim=4)
CLIP_KW = dict(vocab_size=1000, hidden_size=64, num_layers=12, num_heads=4,
               intermediate_size=128, max_position_embeddings=77, num_extra_tokens=0)


def _pipeline(seed):
    return StableDiffusionPipeline.from_random(
        seed, HashTokenizer(), UNetConfig(**UNET_KW), VAEConfig(**VAE_KW),
        CLIPTextConfig(**CLIP_KW), device="cpu")


def _unflatten(flat, part):
    tree = {}
    for k, v in flat.items():
        if not k.startswith(part + "/"):
            continue
        node = tree
        *path, leaf = k[len(part) + 1:].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def test_repl_component_equals_jax(tmp_path, monkeypatch, capsys):
    """The bundle of a base `.ckpt` with an HF text tower spliced in, array for
    array JAX's; `--vae` (a bare bf16 VAE `.safetensors`) splices the other
    VAE in, where JAX's script raises (it calls `map_vae_params` without
    its config)."""
    base, other = _pipeline(1), _pipeline(2)
    base_ckpt = _ckpt(tmp_path / "base.ckpt", {k: v.float() for k, v in
                                                base.ldm_state_dict().items()},
                      {"callbacks": {"c": helpers.LightningCallbackState()}})
    text_pt = str(tmp_path / "text.pt")  # an HF text encoder state dict
    torch.save(hf_clip_text_state_dict(other.clip.state_dict(), 12), text_pt)
    vae_st = str(tmp_path / "vae.safetensors")
    save_safetensors({k: v.to(torch.bfloat16).contiguous() for k, v in ldm_vae_state_dict(
        other.vae.state_dict(), other.vae.cfg, prefix="").items()}, vae_st)
    tiny_unet = classmethod(lambda cls, **kw: cls(**UNET_KW))
    tiny_vae = classmethod(lambda cls, **kw: cls(**VAE_KW))
    for cls, tiny in ((JUNetConfig, tiny_unet), (UNetConfig, tiny_unet),
                      (JVAEConfig, tiny_vae), (VAEConfig, tiny_vae)):
        monkeypatch.setattr(cls, "sd_v1", tiny)
    jnpz, tnpz = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    argv = ["--base", base_ckpt, "--textencoder", text_pt]
    jout = run_jax(monkeypatch, capsys, "repl_component", argv + ["--out", jnpz])
    tout = run_port(capsys, repl_component.main, argv + ["--out", tnpz])
    assert helpers.RAN == []  # no pickled code ran
    assert tout.replace(tnpz, "<o>") == jout.replace(jnpz, "<o>")
    j, t = np.load(jnpz), np.load(tnpz)
    assert len(t.files) == len(j.files)
    jflat = {k: j[k] for k in j.files}
    want = {"unet": from_jax.unet_state_dict_from_jax(_unflatten(jflat, "unet")),
            "vae": from_jax.vae_state_dict_from_jax(_unflatten(jflat, "vae")),
            "clip": from_jax.clip_state_dict_from_jax(_unflatten(jflat, "clip"))}
    for part, sd in want.items():
        keys = sorted(k[len(part) + 1:] for k in t.files if k.startswith(part + "."))
        assert keys == sorted(sd), part
        for k, v in sd.items():
            got = t[f"{part}.{k}"]
            assert got.dtype == np.float32 and np.array_equal(got, v.numpy()), (part, k)
    for part, src in (("clip", other.clip), ("unet", base.unet), ("vae", base.vae)):
        for k, v in src.state_dict().items():
            if f"{part}.{k}" in t.files:
                assert np.array_equal(t[f"{part}.{k}"], v.numpy()), (part, k)
    # --vae
    with pytest.raises(TypeError, match="cfg"):
        run_jax(monkeypatch, capsys, "repl_component", argv + ["--vae", vae_st, "--out", jnpz])
    out = run_port(capsys, repl_component.main, argv + ["--vae", vae_st, "--out", tnpz])
    assert f"replaced VAE from {vae_st}" in out
    t = np.load(tnpz)
    vae_sd = other.vae.state_dict()
    assert sorted(k[4:] for k in t.files if k.startswith("vae.")) == sorted(vae_sd)
    for k, v in vae_sd.items():  # bf16 read as fp32
        assert np.array_equal(t["vae." + k], v.to(torch.bfloat16).float().numpy()), k


# --------------------------------------------------------------------- utils
def test_calc_stats_and_count_params_equal_jax(capsys):
    x = np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32)
    want = jutils.calc_stats("x", jnp.asarray(x))
    jline = capsys.readouterr().out
    got = tutils.calc_stats("x", torch.from_numpy(x))
    assert capsys.readouterr().out == jline
    np.testing.assert_allclose(got, [float(v) for v in want], rtol=0, atol=1e-6)
    # torch's default std is ddof 1: 15 values put it 3.5% above
    assert abs(float(torch.from_numpy(x).std()) - float(want[1])) > 1e-2
    assert tutils.calc_stats("i", np.arange(4), verbose=False) == (1.5, pytest.approx(1.118034),
                                                                   0.0, 3.0)
    pipe = _pipeline(0)
    for m in (pipe.unet, pipe.clip):
        tree = from_jax.jax_tree_from_module(m)
        assert tutils.count_params(m) == pytest.approx(jutils.count_params(tree), rel=1e-12)
        assert tutils.count_params(tree, unit=1) == sum(p.numel() for p in m.parameters())
    sd = {k: v.numpy() for k, v in pipe.vae.state_dict().items()}
    assert tutils.count_params(sd, 1e3) == jutils.count_params(sd, 1e3)
    assert dataclasses.is_dataclass(pipe.unet.cfg)
