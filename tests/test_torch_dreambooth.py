"""DreamBooth in the port (`data/personalized_db.py`, `train_step.
make_dreambooth_train_step`, `train.run_dreambooth`) against the JAX
package's, fp32 on the CPU.

- `DreamBoothDataset`: from one seed, the same pairs (images bit for bit,
  captions), in the JAX draw order (subject index, reg index, a flip each).
- The step: `loss_fn` on a (train, reg) pair of B1 recon batches, with and
  without a per-iteration clip-skip draw, against JAX's step on the tiny
  pipelines of `test_torch_train_step.py`: `loss`, `recon` and `db_reg` at
  rtol 1e-5, every embedder gradient at 2e-4 of its leaf's largest value
  (JAX's gradients read by an optax transformation that returns them as its
  state).
- The loop: both `run_dreambooth`s on the same pipelines and folders, their
  steps replaced by recorders, build the same batches for three steps
  (latents within 1e-4; ids, slot maps, timesteps, noise and the shared
  Dirichlet draw bit for bit).
- The entry point reads the options as JAX's does (the trap kept on
  purpose): with `configs/finetune-db.yaml` the optimizer is clip 0.5 then
  AdamW at the default 7e-4, not the file's 1e-6; `db_reg_weight` is the
  flag's, never the file's; one pair a step whatever `batch_size` says.
- `main([--dreambooth ... --tiny --max_steps 2 --size 32])` on PNGs trains
  and writes `embeddings_last.npz`, which JAX's loader reads."""

import os
import sys

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from adaface_tpu.data.personalized_db import DreamBoothDataset as JDataset
from adaface_tpu.personalization.embedding_manager import EmbeddingManager as JEM
from adaface_tpu.pipeline import StableDiffusionPipeline as JPipeline
from adaface_tpu.training import train_step as jts

import adaface_tpu_torch.train as ttrain
from adaface_tpu_torch.data import png
from adaface_tpu_torch.data.personalized_db import DreamBoothDataset
from adaface_tpu_torch.personalization.static_embedding import embedder_leaves
from adaface_tpu_torch.training import train_step as tts

from test_torch_cli import _cached_jax_pipeline, jax_script  # noqa: F401
from test_torch_train_step import _assert_grads_close, _port_embedders, pipes  # noqa: F401

torch.set_num_threads(2)
DB_CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs", "finetune-db.yaml")


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """(subject folder, class folder): PNGs of different sizes, a mask file
    the scan skips."""
    root = tmp_path_factory.mktemp("db")
    rng = np.random.default_rng(0)
    for name, n in (("subj", 3), ("reg", 4)):
        os.makedirs(root / name)
        for i in range(n):
            png.write(str(root / name / f"{i}.png"),
                      rng.integers(0, 256, (40 + 4 * i, 36, 3), dtype=np.uint8))
    png.write(str(root / "subj" / "0_mask.png"), np.zeros((40, 36), np.uint8))
    return str(root / "subj"), str(root / "reg")


def test_dataset_draws_match_jax(folders):
    j = JDataset(*folders, placeholder="z", class_word="dog", size=32, seed=7)
    t = DreamBoothDataset(*folders, placeholder="z", class_word="dog", size=32, seed=7)
    assert t.subject_paths == j.subject_paths and len(t.subject_paths) == 3
    for _ in range(8):
        for je, te in zip(j.draw_pair(), t.draw_pair()):
            assert te["caption"] == je["caption"]
            np.testing.assert_array_equal(te["image"], je["image"])
    assert (t.train_caption, t.reg_caption) == ("a photo of a z dog", "a photo of a dog")


def _capture_grads():
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def _pair(jp, rng, sw):
    """A (JAX, port) DreamBoothBatch pair of B1 halves from the same arrays."""
    out_j, out_t = [], []
    for caption, t in (("a photo of a z , , , , , , , , person", 640),
                       ("a photo of a person", 75)):
        ids = jp.tokenizer([caption])
        slots = jp.embedding_manager.build_slot_maps(ids)
        lat = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
        noise = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
        out_j.append(jts.ReconBatch(
            latents=jnp.asarray(lat), token_ids=jnp.asarray(ids),
            slot_maps={k: jnp.asarray(v) for k, v in slots.items()}, fg_mask=None,
            timesteps=jnp.asarray([t], jnp.int32), noise=jnp.asarray(noise),
            skip_weights=None if sw is None else jnp.asarray(sw, jnp.float32)))
        out_t.append(tts.ReconBatch(
            latents=torch.from_numpy(lat), token_ids=ids, slot_maps=slots, fg_mask=None,
            timesteps=torch.tensor([t], dtype=torch.int32), noise=torch.from_numpy(noise),
            skip_weights=None if sw is None else torch.tensor(sw, dtype=torch.float32)))
    return jts.DreamBoothBatch(*out_j), tts.DreamBoothBatch(*out_t)


@pytest.mark.parametrize("skip_weights", [None, (0.3, 0.7)])
def test_step_matches_jax(pipes, skip_weights):
    jp, tp = pipes
    jb, tb = _pair(jp, np.random.default_rng(1), skip_weights)
    jstep = jts.make_dreambooth_train_step(jp.clip, jp.clip_params, jp.unet, jp.unet_params,
                                           jp.base_sched, _capture_grads(), db_reg_weight=0.5)
    emb = jp.embedding_manager.embedders
    _, jgrads, jmetrics = jax.jit(jstep)(emb, jax.tree_util.tree_map(jnp.zeros_like, emb), jb)
    step = tts.make_dreambooth_train_step(tp.clip, tp.unet, tp.base_sched, None,
                                          db_reg_weight=0.5)
    temb = _port_embedders(tp)
    loss, metrics = step.loss_fn(temb, tb)
    loss.backward()
    assert sorted(metrics) == sorted(jmetrics) == ["db_reg", "loss", "recon"]
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), rtol=1e-5, err_msg=k)
    assert metrics["loss"].item() == pytest.approx(
        metrics["recon"].item() + 0.5 * metrics["db_reg"].item(), rel=1e-6)
    # the class prompt holds no placeholder: only the subject's leaves move,
    # the bg embedder's gradient is zero on both sides
    assert all(float(jnp.abs(g).max()) == 0 for g in jax.tree_util.tree_leaves(jgrads["y"]))
    assert all(t.grad is None or float(t.grad.abs().max()) == 0
               for _, t in embedder_leaves(temb["y"]))
    _assert_grads_close({"z": temb["z"]}, {"z": jgrads["z"]})


def _recording_jax_step(store):
    def make(*a, **kw):
        store["db_reg_weight"] = kw["db_reg_weight"]

        def step(emb, opt_state, batch):
            store.setdefault("batches", []).append(batch)
            zero = jnp.zeros(())
            return emb, opt_state, {"loss": zero, "recon": zero, "db_reg": zero}
        return step
    return make


def _recording_port_step(store):
    def make(*a, **kw):
        store["db_reg_weight"] = kw["db_reg_weight"]
        store["optimizer"] = a[3]

        def step(emb, batch):
            store.setdefault("batches", []).append(batch)
            return {"loss": torch.zeros(()), "recon": torch.zeros(()), "db_reg": torch.zeros(())}
        return step
    return make


def _restore(tp):
    for m in (tp.clip, tp.unet, tp.vae):
        m.requires_grad_(False)
    for e in tp.embedding_manager.embedders.values():
        for _, t in embedder_leaves(e):
            t.requires_grad_(False)


def test_loop_builds_the_batches_of_jax(monkeypatch, jax_script, pipes, folders, tmp_path):
    jp, tp = pipes
    argv = ["--dreambooth", "--data_root", folders[0], "--reg_data_root", folders[1],
            "--max_steps", "3", "--size", "32", "--seed", "4", "--cls_delta_string", "dog",
            "--randomize_clip_skip_weights", "--clip_last_layers_skip_weights", "1", "2"]
    got_j, got_t = {}, {}
    with monkeypatch.context() as m:
        m.setattr(jts, "make_dreambooth_train_step", _recording_jax_step(got_j))
        m.setattr(jax, "jit", lambda f, *a, **k: f)  # the recorder keeps concrete arrays
        jopt = jax_script.parse_args(argv + ["--logdir", str(tmp_path / "j")])
        assert jax_script.run_dreambooth(jopt, jp, jp.tokenizer) == 0
    monkeypatch.setattr(ttrain, "make_dreambooth_train_step", _recording_port_step(got_t))
    try:
        topt = ttrain.parse_args(argv + ["--logdir", str(tmp_path / "t")])
        assert ttrain.run_dreambooth(topt, tp) == 0
    finally:
        _restore(tp)
    assert len(got_j["batches"]) == len(got_t["batches"]) == 3
    for jb, tb in zip(got_j["batches"], got_t["batches"]):
        for half in ("train", "reg"):
            j, t = getattr(jb, half), getattr(tb, half)
            np.testing.assert_allclose(t.latents.numpy(), np.asarray(j.latents), atol=1e-4,
                                       rtol=0)
            for name in ("token_ids", "timesteps", "noise", "skip_weights"):
                np.testing.assert_array_equal(np.asarray(getattr(t, name)),
                                              np.asarray(getattr(j, name)), err_msg=name)
            assert t.fg_mask is None and j.fg_mask is None
            assert sorted(t.slot_maps) == sorted(j.slot_maps)
            for k in t.slot_maps:
                np.testing.assert_array_equal(t.slot_maps[k], np.asarray(j.slot_maps[k]))
        assert tb.train.latents.shape[0] == tb.reg.latents.shape[0] == 1
        assert torch.equal(tb.train.skip_weights, tb.reg.skip_weights)
    for side in ("j", "t"):
        assert os.path.exists(tmp_path / side / "embeddings_last.npz")


@pytest.mark.parametrize("flags,want_w", [([], 1.0), (["--db_reg_weight", "0.25"], 0.25)])
def test_entry_reads_the_options_as_jax(monkeypatch, jax_script, folders, tmp_path, flags,
                                        want_w):
    """The file's `learning_rate: 1.0e-6` and `dreambooth.db_reg_weight`
    (raised to 3.0 here) are never read, `batch_size: 2` neither."""
    argv = (["--dreambooth", "--base", DB_CONFIG, "--data_root", folders[0], "--reg_data_root",
             folders[1], "--tiny", "--max_steps", "2", "--size", "32"] + flags
            + ["dreambooth.db_reg_weight=3.0"])
    seen = {}
    real_adamw, real_clip = optax.adamw, optax.clip_by_global_norm
    got_j, got_t = {}, {}
    with monkeypatch.context() as m:
        m.setattr(JPipeline, "from_random", _cached_jax_pipeline(JPipeline.from_random))
        m.setattr(optax, "adamw", lambda lr, **k: seen.setdefault("j_lr", lr) and real_adamw(lr))
        m.setattr(optax, "clip_by_global_norm",
                  lambda c: seen.setdefault("j_clip", c) and real_clip(c))
        m.setattr(jts, "make_dreambooth_train_step", _recording_jax_step(got_j))
        m.setattr(sys, "argv", ["train.py"] + argv)
        a = argv + ["--logdir", str(tmp_path / "j")]
        assert jax_script.main(jax_script.parse_args(a)) == 0
    monkeypatch.setattr(ttrain, "make_dreambooth_train_step", _recording_port_step(got_t))
    assert ttrain.main(argv + ["--logdir", str(tmp_path / "t")], device="cpu") == 0
    opt = got_t["optimizer"]
    assert (opt.max_norm, opt.every_k, type(opt.inner).__name__) == (0.5, 1, "AdamW")
    assert opt.inner.lr == seen["j_lr"] == 7e-4
    assert seen["j_clip"] == 0.5
    assert got_t["db_reg_weight"] == got_j["db_reg_weight"] == want_w
    assert [b.train.latents.shape[0] for b in got_t["batches"]] == [1, 1]
    # JAX's jitted recorder sees the traced batch once
    assert {b.train.latents.shape[0] for b in got_j["batches"]} == {1}
    jm = got_j["batches"][0].train.slot_maps
    assert sorted(got_t["batches"][0].train.slot_maps) == sorted(jm) == ["z"]


def test_cli_trains_and_writes_embeddings(folders, tmp_path):
    argv = ["--dreambooth", "--base", DB_CONFIG, "--data_root", folders[0], "--reg_data_root",
            folders[1], "--tiny", "--max_steps", "2", "--size", "32", "--logdir", str(tmp_path)]
    assert ttrain.main(argv, device="cpu") == 0
    path = str(tmp_path / "embeddings_last.npz")
    jm = JEM.load_native(path)
    assert sorted(jm.placeholders) == ["z"] and jm.placeholders["z"].num_vectors == 1
    leaves = jax.tree_util.tree_leaves(jm.embedders["z"])
    assert all(np.isfinite(np.asarray(x)).all() for x in leaves)
    with pytest.raises(SystemExit, match="reg_data_root"):
        ttrain.main(argv[:5] + argv[7:], device="cpu")
