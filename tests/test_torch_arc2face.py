"""Port parity of Arc2Face distillation in per-subject training and of the
teacher's weight readers, fp32 on the CPU.

- The Arc2Face distillation step (static embedders): loss and metrics
  against JAX's own step at rtol 1e-5, every embedder gradient at 1e-4 of
  its leaf's largest value (S 1 with fg and augmentation masks; S 3 on a
  random face, no masks).
- `Trainer.fit(arc2face_teacher=...)`: from one seed the port's trainer
  builds the same `Arc2FaceBatch` arrays as JAX's over a plan mixing S 1
  and S > 1, random and real faces (the teacher's own rng giving the same
  contexts), and a port `fit` with a real teacher trains.
- The weight readers: the diffusers UNet map against JAX's on the
  independently enumerated synthetic state dict of
  `tests/test_diffusers_unet.py` (1x1-conv and Linear projections; an
  unconsumed key fails), the HF CLIP text map against JAX's, safetensors
  written and read in F32, F16 and BF16 (and read by JAX's reader), and
  `load_arc2face_teacher` against JAX's on the same files (the teacher's
  context and eps).
- `python -m adaface_tpu_torch.train --tiny --arc2face_unet ...
  --arc2face_text_encoder ...` end to end on those files.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from adaface_tpu.data.personalized import PersonalizedDataset as JDataset
from adaface_tpu.data.personalized import SubjectSpec as JSpec
from adaface_tpu.interop import torch_pickle as jpickle
from adaface_tpu.interop.diffusers_unet import map_diffusers_unet_params
from adaface_tpu.interop.hf_clip import map_clip_text_params
from adaface_tpu.models.unet import UNetConfig as JUNetConfig
from adaface_tpu.training import train_step as jts
from adaface_tpu.training.arc2face_teacher import load_arc2face_teacher as j_load_teacher
from adaface_tpu.training.iter_plan import IterPlan as JIterPlan
from adaface_tpu.training.iter_plan import IterPlanConfig as JPlanConfig
from adaface_tpu.training.trainer import Trainer as JTrainer
from adaface_tpu.training.trainer import TrainerConfig as JTrainerConfig

from adaface_tpu_torch.data.personalized import PersonalizedDataset, SubjectSpec
from adaface_tpu_torch.data.tokenizer import HashTokenizer
from adaface_tpu_torch.interop import checkpoint_io, from_jax
from adaface_tpu_torch.interop.diffusers_unet import map_diffusers_unet_state_dict
from adaface_tpu_torch.interop.hf_clip import map_clip_text_state_dict
from adaface_tpu_torch.models.unet import UNetConfig, UNetModel
from adaface_tpu_torch.personalization.static_embedding import embedder_leaves
from adaface_tpu_torch.training import train_step as tts
from adaface_tpu_torch.training.arc2face_teacher import load_arc2face_teacher
from adaface_tpu_torch.training.iter_plan import ARC2FACE_DISTILL, IterPlan, IterPlanConfig
from adaface_tpu_torch.training.trainer import Trainer, TrainerConfig

from test_diffusers_unet import synth_diffusers_sd
from test_torch_train_step import (  # noqa: F401
    PROMPTS,
    UNET_KW,
    _assert_grads_close,
    _np_tree,
    _port_embedders,
    pipes,
    subject_dir,
)

torch.set_num_threads(2)
D = 64


@pytest.fixture(scope="module")
def teacher(pipes):
    """A second UNet of the pipelines' config: JAX params and the port's."""
    jp, _ = pipes
    params = _np_tree(jp.unet.init(jax.random.PRNGKey(9), jnp.zeros((1, 16, 16, 4)),
                                   jnp.zeros((1,), jnp.int32), jnp.zeros((1, 1, 77, D)))["params"])
    port = UNetModel(UNetConfig(**UNET_KW))
    port.load_state_dict(from_jax.unet_state_dict_from_jax(params), strict=True)
    return params, port.eval()


def _capture_grads():
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def _batches(jp, S, rand_face, seed):
    rng = np.random.default_rng(seed)
    b = 2
    ids = jp.tokenizer(PROMPTS)
    slots = jp.embedding_manager.build_slot_maps(ids)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    lat, ctx, noises = f32(b, 16, 16, 4), f32(b, 77, D) * 0.5, f32(S, b, 16, 16, 4)
    rel = rng.uniform(size=(max(S - 1, 1), b)).astype(np.float32)
    t = np.array([870, 430], np.int32)
    fg = np.zeros((b, 16, 16, 1), np.float32)
    fg[:, 3:12, 4:13] = 1
    img = np.ones((b, 16, 16, 1), np.float32)
    img[:, :, :2] = 0
    img_mask = None if rand_face else img
    j = jts.Arc2FaceBatch(latents=jnp.asarray(lat), teacher_context=jnp.asarray(ctx),
                          token_ids=jnp.asarray(ids),
                          slot_maps={k: jnp.asarray(v) for k, v in slots.items()},
                          timesteps=jnp.asarray(t), noises=jnp.asarray(noises),
                          relative_ts=jnp.asarray(rel), fg_mask=jnp.asarray(fg),
                          img_mask=None if img_mask is None else jnp.asarray(img_mask))
    tt = lambda a: torch.from_numpy(np.array(a))
    p = tts.Arc2FaceBatch(latents=tt(lat), teacher_context=tt(ctx), token_ids=ids,
                          slot_maps=slots, timesteps=torch.tensor(t), noises=tt(noises),
                          relative_ts=tt(rel), fg_mask=tt(fg),
                          img_mask=None if img_mask is None else tt(img_mask))
    return j, p


@pytest.mark.parametrize("S,rand_face", [(1, False), (3, True)])
def test_arc2face_step_matches_jax(pipes, teacher, S, rand_face):
    jp, tp = pipes
    tparams, tunet = teacher
    jb, pb = _batches(jp, S, rand_face, seed=S)
    jstep = jts.make_arc2face_distill_step(
        jp.clip, jp.clip_params, jp.unet, jp.unet_params, jp.unet, tparams, jp.base_sched,
        _capture_grads(), num_denoising_steps=S, use_fg_mask=not rand_face)
    emb0 = jp.embedding_manager.embedders
    _, jgrads, jmetrics = jax.jit(jstep)(emb0, jax.tree_util.tree_map(jnp.zeros_like, emb0),
                                         jb, None)
    step = tts.make_arc2face_distill_step(tp.clip, tp.unet, tunet, tp.base_sched, None,
                                          num_denoising_steps=S, use_fg_mask=not rand_face)
    emb = _port_embedders(tp)
    loss, metrics = step.loss_fn(emb, pb)
    loss.backward()
    assert set(metrics) == set(jmetrics) == {"loss", "n_loss_steps"}
    assert float(metrics["n_loss_steps"]) == S
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k].detach()), float(jmetrics[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    _assert_grads_close(emb, jgrads, tol=1e-4)


PLAN_KW = dict(composition_regs_iter_gap=0, do_zero_shot=False,
               prompt_emb_delta_reg_weight=2e-4, arc2face_distill_iter_prob=1.0,
               max_num_denoising_steps=3)


def _face_fn(img):
    if int(img.sum()) % 4 == 0:
        return None
    return np.random.default_rng(int(img.sum())).standard_normal(512).astype(np.float32)


class _Ctx:
    """The teacher's ctx: identity embeddings from the face embedder or the
    teacher's own rng (the JAX teacher's `_id_embs`), then a fixed linear
    map to the context, so both packages' trainers get the same numbers."""

    def __init__(self, jax_side):
        self.rng = np.random.default_rng(0)
        self.jax_side = jax_side
        self.w = np.random.default_rng(1).standard_normal((512, 77 * D)).astype(np.float32) / 30

    def __call__(self, examples, plan):
        B = len(examples)
        if plan.gen_arc2face_rand_face:
            e = self.rng.standard_normal((B, 512)).astype(np.float32)
        else:
            rows = [_face_fn(x["image_unnorm"]) for x in examples]
            e = np.stack([r if r is not None else
                          self.rng.standard_normal(512).astype(np.float32) for r in rows])
        ctx = (e @ self.w).reshape(B, 77, D)
        return jnp.asarray(ctx) if self.jax_side else torch.from_numpy(ctx)


def test_trainers_build_the_same_arc2face_batches(pipes, teacher, subject_dir, tmp_path):
    jp, tp = pipes
    tparams, tunet = teacher
    cfg = dict(batch_size=3, max_steps=100, seed=1, log_every_steps=1000, ckpt_every_steps=1000)
    jtr = JTrainer(jp, JDataset([JSpec("s", subject_dir)], size=32, seed=0),
                   JTrainerConfig(logdir=str(tmp_path / "j"), **cfg), JPlanConfig(**PLAN_KW))
    ttr = Trainer(tp, PersonalizedDataset([SubjectSpec("s", subject_dir)], size=32, seed=0),
                  TrainerConfig(logdir=str(tmp_path / "t"), **cfg), IterPlanConfig(**PLAN_KW))
    jrec, trec = [], []

    def jcall(step, params, opt_state, batch, frozen=None):
        jrec.append(batch)
        return params, opt_state, {}
    jtr._call_step = jcall
    ttr._get_arc2face_step = lambda *a: (lambda e, b: trec.append(b) or {})
    jtr.fit(6, arc2face_teacher=(jp.unet, tparams, _Ctx(True)))
    ttr.fit(6, arc2face_teacher=(tunet, _Ctx(False)))
    ttr.close()
    assert len(jrec) == len(trec) == 6
    kinds = set()
    for jb, tb in zip(jrec, trec):
        S, B = tb.noises.shape[:2]
        kinds.add((S > 1, tb.img_mask is None))
        assert B == (3 if S == 1 else -(-3 // S))
        np.testing.assert_allclose(tb.latents.numpy(), np.asarray(jb.latents), atol=1e-4)
        for name in ("token_ids", "timesteps", "noises", "relative_ts", "fg_mask", "img_mask",
                     "teacher_context"):
            a, b = getattr(tb, name), getattr(jb, name)
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)
        for k in tb.slot_maps:
            np.testing.assert_array_equal(tb.slot_maps[k], np.asarray(jb.slot_maps[k]))
    assert kinds == {(False, False), (False, True), (True, False), (True, True)}, kinds


def test_fit_with_a_teacher_trains(pipes, teacher, subject_dir, tmp_path):
    """A port `fit(3)` on Arc2Face plans alone (a real distillation step
    each): finite losses logged as arc2face iterations, the embedders move."""
    import json

    _, tp = pipes
    _, tunet = teacher
    before = {s: {n: t.detach().clone() for n, t in embedder_leaves(p)}
              for s, p in tp.embedding_manager.embedders.items()}
    tr = Trainer(tp, PersonalizedDataset([SubjectSpec("s", subject_dir)], size=32, seed=0),
                 TrainerConfig(batch_size=2, max_steps=3, seed=0, log_every_steps=1000,
                               accumulate_grad_batches=1, logdir=str(tmp_path)),
                 IterPlanConfig(**PLAN_KW))
    try:
        tr.fit(arc2face_teacher=(tunet, _Ctx(False)))
    finally:
        tr.close()
    recs = [json.loads(line) for line in open(tmp_path / "metrics.jsonl") if "loss" in line]
    assert [r["iter_type"] for r in recs] == ["arc2face_distill"] * 3
    assert all(np.isfinite(r["loss"]) and r["loss"] > 0 for r in recs)
    moved = 0.0
    with torch.no_grad():
        for s, p in tp.embedding_manager.embedders.items():
            for n, t in embedder_leaves(p):
                moved = max(moved, float((t - before[s][n]).abs().max()))
                t.copy_(before[s][n])
                t.requires_grad_(False)
    assert moved > 0


# ------------------------------------------------------------ weight readers
def _torch_sd(sd):
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


@pytest.mark.parametrize("linear_proj", [False, True])
def test_diffusers_map_matches_jax(linear_proj):
    cfg = dict(model_channels=32, context_dim=16)
    sd = synth_diffusers_sd(JUNetConfig.sd_v1(**cfg), seed=3, linear_proj=linear_proj)
    want = from_jax.unet_state_dict_from_jax(
        map_diffusers_unet_params(sd, JUNetConfig.sd_v1(**cfg), strict=True))
    got = map_diffusers_unet_state_dict(_torch_sd(sd), UNetConfig.sd_v1(**cfg))
    assert set(got) == set(want) == set(UNetModel(UNetConfig.sd_v1(**cfg)).state_dict())
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


def test_diffusers_map_is_strict():
    sd = _torch_sd(synth_diffusers_sd(JUNetConfig.tiny()))
    map_diffusers_unet_state_dict(sd, UNetConfig.tiny())
    sd["down_blocks.9.resnets.0.norm1.weight"] = torch.zeros(4)
    with pytest.raises(ValueError, match="not consumed"):
        map_diffusers_unet_state_dict(sd, UNetConfig.tiny())
    del sd["down_blocks.9.resnets.0.norm1.weight"], sd["conv_in.bias"]
    with pytest.raises(KeyError, match="conv_in.bias"):
        map_diffusers_unet_state_dict(sd, UNetConfig.tiny())


def synth_hf_clip(vocab, layers=2, width=D, inter=128, prefix="text_model.", seed=0):
    """An HF CLIPTextModel state dict, names enumerated from the HF layout."""
    rng = np.random.default_rng(seed)
    r = lambda *s: (rng.standard_normal(s) * 0.02).astype(np.float32)
    sd = {prefix + "embeddings.token_embedding.weight": r(vocab, width),
          prefix + "embeddings.position_embedding.weight": r(77, width),
          prefix + "embeddings.position_ids": np.arange(77)[None],
          prefix + "final_layer_norm.weight": r(width) + 1,
          prefix + "final_layer_norm.bias": r(width)}
    for i in range(layers):
        lp = f"{prefix}encoder.layers.{i}."
        for nm in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[lp + f"self_attn.{nm}.weight"] = r(width, width)
            sd[lp + f"self_attn.{nm}.bias"] = r(width)
        sd[lp + "mlp.fc1.weight"], sd[lp + "mlp.fc1.bias"] = r(inter, width), r(inter)
        sd[lp + "mlp.fc2.weight"], sd[lp + "mlp.fc2.bias"] = r(width, inter), r(width)
        for nm in ("layer_norm1", "layer_norm2"):
            sd[lp + nm + ".weight"], sd[lp + nm + ".bias"] = r(width) + 1, r(width)
    return sd


def test_inverse_maps_round_trip():
    """The port's weights written in the diffusers and HF layouts (what
    chip_smoke writes for the CLI's teacher) map back to themselves."""
    from adaface_tpu_torch.interop.diffusers_unet import diffusers_unet_state_dict
    from adaface_tpu_torch.interop.hf_clip import hf_clip_text_state_dict

    cfg = UNetConfig.sd_v1(model_channels=32, context_dim=16)
    g = torch.Generator().manual_seed(0)
    sd = {k: torch.randn(v.shape, generator=g) for k, v in UNetModel(cfg).state_dict().items()}
    back = map_diffusers_unet_state_dict(diffusers_unet_state_dict(sd, cfg), cfg)
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    want = synth_diffusers_sd(JUNetConfig.sd_v1(model_channels=32, context_dim=16))
    assert set(diffusers_unet_state_dict(sd, cfg)) == set(want)
    enc = _torch_sd(synth_hf_clip(300))
    del enc["text_model.embeddings.position_ids"]
    port = map_clip_text_state_dict(enc, 2)
    assert hf_clip_text_state_dict(port, 2).keys() == enc.keys()


@pytest.mark.parametrize("prefix", ["text_model.", "cond_stage_model.transformer.text_model."])
def test_hf_clip_map_matches_jax(prefix):
    sd = synth_hf_clip(300, prefix=prefix)
    want = from_jax.clip_state_dict_from_jax(map_clip_text_params(sd, 2, prefix=prefix))
    got = map_clip_text_state_dict(_torch_sd(sd), 2, prefix=prefix)
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_safetensors_round_trip(tmp_path, dtype):
    g = torch.Generator().manual_seed(0)
    tensors = {"a.weight": torch.randn(3, 5, generator=g).to(dtype),
               "b": torch.randn(7, generator=g).to(dtype), "empty": torch.zeros(0, 4, dtype=dtype),
               "ids": torch.arange(6, dtype=torch.int64).reshape(2, 3)}
    path = str(tmp_path / "w.safetensors")
    checkpoint_io.save_safetensors(tensors, path)
    back = checkpoint_io.load_safetensors(path)
    assert list(back) == list(tensors)
    for k, t in tensors.items():
        assert back[k].dtype == t.dtype and back[k].shape == t.shape
        assert torch.equal(back[k], t), k
    # JAX's reader takes the file (widening bf16 to fp32)
    jback = jpickle.load_safetensors(path)
    for k, t in tensors.items():
        np.testing.assert_array_equal(jback[k], t.float().numpy() if t.is_floating_point()
                                      else t.numpy())
    # and the port reads JAX's writer's file, its metadata skipped
    if dtype != torch.bfloat16:
        jpath = str(tmp_path / "j.safetensors")
        jpickle.save_safetensors({k: t.numpy() for k, t in tensors.items()}, jpath,
                                 metadata={"format": "pt"})
        for k, t in checkpoint_io.load_safetensors(jpath).items():
            assert torch.equal(t, tensors[k]), k


# ------------------------------------------------------------------ teacher
@pytest.fixture(scope="module")
def teacher_files(tmp_path_factory):
    """The teacher on disk: a diffusers UNet (fp16 safetensors) of the tiny
    training UNet's config and an HF text encoder (.bin), both synthetic."""
    tmp = tmp_path_factory.mktemp("a2f")
    ucfg = {k: v for k, v in UNET_KW.items() if k != "use_flash_attention"}
    sd = synth_diffusers_sd(JUNetConfig(**ucfg), seed=5)
    unet_dir = tmp / "arc2face"
    unet_dir.mkdir()
    checkpoint_io.save_safetensors(
        {k: torch.from_numpy(v).half() for k, v in sd.items()},
        str(unet_dir / "diffusion_pytorch_model.safetensors"))
    enc = tmp / "encoder"
    enc.mkdir()
    torch.save(_torch_sd(synth_hf_clip(HashTokenizer().vocab_size, seed=6)),
               str(enc / "pytorch_model.bin"))
    return str(unet_dir), str(enc), ucfg


def test_teacher_matches_jax(teacher_files):
    unet_dir, enc_dir, ucfg = teacher_files
    from adaface_tpu.data.tokenizer import HashTokenizer as JTok

    jt = j_load_teacher(unet_dir + "/diffusion_pytorch_model.safetensors",
                        enc_dir + "/pytorch_model.bin", JTok(), unet_cfg=JUNetConfig(**ucfg))
    pt = load_arc2face_teacher(unet_dir, enc_dir, HashTokenizer(), unet_cfg=UNetConfig(**ucfg),
                               device="cpu")
    assert pt.encoder.cfg.num_layers == 2 and pt.encoder.cfg.hidden_size == D
    plan = IterPlan(iter_type=ARC2FACE_DISTILL, gen_arc2face_rand_face=True)
    jplan = JIterPlan(iter_type=ARC2FACE_DISTILL, gen_arc2face_rand_face=True)
    ex = [{"image_unnorm": np.zeros((8, 8, 3), np.uint8)}] * 2
    ctx, jctx = pt.ctx(ex, plan), jt.ctx(ex, jplan)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(jctx), rtol=0, atol=2e-5)
    x = np.random.default_rng(0).standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.array([10, 700], np.int32)
    want = jt.unet.apply({"params": jt.unet_params}, jnp.asarray(x), jnp.asarray(t),
                         jctx[None])
    with torch.no_grad():
        got = pt.unet(torch.from_numpy(x), torch.from_numpy(t), ctx[None])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5 * float(np.abs(np.asarray(want)).max()))


def test_bf16_teacher_keeps_an_fp32_encoder(teacher_files):
    """At dtype bf16 only the teacher UNet is bf16: the Arc2Face encoder is
    built in fp32 as JAX builds it (its `CLIPTextEncoder` at the default
    dtype), so the context agrees with JAX's at the fp32 test's 2e-5. With
    the encoder cast to bf16 (the fault this guards) it reads far outside."""
    unet_dir, enc_dir, ucfg = teacher_files
    from adaface_tpu.data.tokenizer import HashTokenizer as JTok

    jt = j_load_teacher(unet_dir + "/diffusion_pytorch_model.safetensors",
                        enc_dir + "/pytorch_model.bin", JTok(), dtype=jnp.bfloat16,
                        unet_cfg=JUNetConfig(**ucfg))
    pt = load_arc2face_teacher(unet_dir, enc_dir, HashTokenizer(), dtype=torch.bfloat16,
                               unet_cfg=UNetConfig(**ucfg), device="cpu")
    assert {p.dtype for p in pt.encoder.parameters()} == {torch.float32}
    assert {p.dtype for p in pt.unet.parameters()} == {torch.bfloat16}
    plan = IterPlan(iter_type=ARC2FACE_DISTILL, gen_arc2face_rand_face=True)
    jplan = JIterPlan(iter_type=ARC2FACE_DISTILL, gen_arc2face_rand_face=True)
    ex = [{"image_unnorm": np.zeros((8, 8, 3), np.uint8)}] * 2
    ctx, jctx = pt.ctx(ex, plan), jt.ctx(ex, jplan)
    assert ctx.dtype == torch.float32 and jctx.dtype == jnp.float32
    jctx = np.asarray(jctx)
    np.testing.assert_allclose(ctx.numpy(), jctx, rtol=0, atol=2e-5)
    pt.encoder.to(torch.bfloat16)
    pt._rng = np.random.default_rng(0)
    faulty = pt.ctx(ex, plan).float().numpy()
    assert np.abs(faulty - jctx).max() > 100 * 2e-5


def test_cli_trains_with_the_teacher(teacher_files, subject_dir, tmp_path):
    import json

    import adaface_tpu_torch.train as ttrain

    unet_dir, enc_dir, _ = teacher_files
    config = os.path.join(os.path.dirname(__file__), "..", "configs", "finetune-ti.yaml")
    argv = ["--base", config, "--data_root", subject_dir, "--tiny",
            "--size", "64", "--max_steps", "3", "--logdir", str(tmp_path),
            "--arc2face_unet", unet_dir, "--arc2face_text_encoder", enc_dir,
            "iter_plan.arc2face_distill_iter_prob=1.0", "iter_plan.composition_regs_iter_gap=0"]
    assert ttrain.main(argv, device="cpu") == 0
    recs = [json.loads(line) for line in open(tmp_path / "metrics.jsonl") if "loss" in line]
    assert [r["iter_type"] for r in recs] == ["arc2face_distill"] * 3
    assert all(np.isfinite(r["loss"]) for r in recs)
