"""Port parity of the recon training slice as a whole, fp32 on the CPU.

The tiny pipeline of `test_torch_models.py` (CLIP over the full tokenizer
vocabulary with 77 positions, so the placeholders land in the extra
table), a 16x16 latent whose level-0 self-attention is L256: JAX runs its
Pallas forward and backward kernels in interpret mode, the port their
plain versions. Placeholders `z` (9 vectors) and background `y` (4), both
initialized from init vectors so that `pre_vecs` train too.

- `loss_fn` of the recon step, every metric and the gradient of every
  embedder leaf, with the complementary, cross-layer and prompt-delta
  terms on (weights raised from the trainer's 2e-4 so that their gradients
  count), a bg token, fg and augmentation masks, no embedding noise;
- one accumulated update (2 micro-steps through the trainer's optimizer
  chain): the parameters and the Prodigy moments;
- the trainers: from one seed the port's `Trainer` builds the same
  `ReconBatch` arrays as JAX's (each handed a recording step);
- a port-only `fit(4)` whose `embeddings_last.npz` JAX's loader reads.

Tolerances: metrics 1e-5 relative; gradients 2e-4 relative to each leaf's
largest entry (fp32 through CLIP, a UNet forward and backward and the
losses, with sums in other orders in XLA and torch); latents 1e-4."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import chip_smoke

from adaface_tpu.data.personalized import PersonalizedDataset as JDataset
from adaface_tpu.data.personalized import SubjectSpec as JSpec
from adaface_tpu.data.tokenizer import HashTokenizer as JTok
from adaface_tpu.models.clip_text import CLIPTextConfig as JCLIPConfig
from adaface_tpu.models.unet import UNetConfig as JUNetConfig
from adaface_tpu.models.vae import VAEConfig as JVAEConfig
from adaface_tpu.personalization.embedding_manager import EmbeddingManager as JEM
from adaface_tpu.personalization.static_embedding import init_static_embedder as j_init
from adaface_tpu.pipeline import StableDiffusionPipeline as JPipeline
from adaface_tpu.training import train_step as jts
from adaface_tpu.training.iter_plan import IterPlanConfig as JPlanConfig
from adaface_tpu.training.prodigy import prodigy as j_prodigy
from adaface_tpu.training.trainer import Trainer as JTrainer
from adaface_tpu.training.trainer import TrainerConfig as JTrainerConfig

from adaface_tpu_torch.data.personalized import PersonalizedDataset, SubjectSpec
from adaface_tpu_torch.data.tokenizer import HashTokenizer
from adaface_tpu_torch.interop import from_jax
from adaface_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
from adaface_tpu_torch.models.unet import UNetConfig, UNetModel
from adaface_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from adaface_tpu_torch.personalization.static_embedding import embedder_leaves
from adaface_tpu_torch.pipeline import StableDiffusionPipeline
from adaface_tpu_torch.training import train_step as tts
from adaface_tpu_torch.training.iter_plan import IterPlanConfig
from adaface_tpu_torch.training.prodigy import AccumulatedClipped, Prodigy
from adaface_tpu_torch.training.trainer import Trainer, TrainerConfig

torch.set_num_threads(2)

UNET_KW = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
               attention_levels=(0, 1), num_heads=4, context_dim=64)
VAE_KW = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=4, embed_dim=4)
STEP_KW = dict(skip_weights=(0.5, 0.5), bg_weight=0.1, emb_reg_weight=0.05,
               complem_weight=0.5, xlayer_weight=0.5, prompt_delta_weight=0.5,
               use_bg_token=True, do_zero_shot=False, bg_placeholders=frozenset({"y"}))
PROMPTS = ["a photo of a z , , , , , , , , with background y , , ,",
           "the close-up z , , , , , , , , with background y , , ,"]
DELTA = (PROMPTS + ["a photo of a z , , , , , , , , riding a bike",
                    "the close-up z , , , , , , , , in the snow",
                    "a photo of a person , , , , , , , ,",
                    "the close-up person , , , , , , , ,",
                    "a photo of a person , , , , , , , , riding a bike",
                    "the close-up person , , , , , , , , in the snow"])


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def pipes():
    """(JAX pipeline, port pipeline) with the same weights, tokenizers and
    placeholders."""
    jtok = JTok()
    clip_kw = dict(vocab_size=jtok.vocab_size, hidden_size=64, num_layers=2, num_heads=4,
                   intermediate_size=128, max_position_embeddings=77, num_extra_tokens=8)
    jp = JPipeline.from_random(jax.random.PRNGKey(0), jtok, JUNetConfig(**UNET_KW),
                               JVAEConfig(**VAE_KW), JCLIPConfig(**clip_kw))
    ttok = HashTokenizer()

    def load(m, tree):
        m.load_state_dict(tree, strict=True)
        return m

    tp = StableDiffusionPipeline(
        ttok,
        load(CLIPTextEncoder(CLIPTextConfig(**clip_kw)),
             from_jax.clip_state_dict_from_jax(_np_tree(jp.clip_params))),
        load(UNetModel(UNetConfig(**UNET_KW)),
             from_jax.unet_state_dict_from_jax(_np_tree(jp.unet_params))),
        load(AutoencoderKL(VAEConfig(**VAE_KW)),
             from_jax.vae_state_dict_from_jax(_np_tree(jp.vae_params))))
    rng = np.random.default_rng(3)
    for i, (s, k, bg) in enumerate((("z", 9, False), ("y", 4, True))):
        tid = jtok.add_placeholder(s)
        assert ttok.add_placeholder(s) == tid
        emb = j_init(jax.random.PRNGKey(10 + i), 16, num_vectors=k, emb_dim=64, rank=5,
                     init_vecs=rng.standard_normal((2, 64)).astype(np.float32) * 0.02)
        jp.embedding_manager.add_placeholder(s, token_id=tid, num_vectors=k,
                                             is_background=bg, embedder=emb)
        tp.embedding_manager.add_placeholder(s, token_id=tid, num_vectors=k,
                                             is_background=bg,
                                             embedder=from_jax.static_embedder_from_jax(emb))
    return jp, tp


def _batch(jp, rng, t):
    """A JAX ReconBatch and the port's, from the same numpy arrays."""
    b = len(PROMPTS)
    ids = jp.tokenizer(PROMPTS)
    slots = jp.embedding_manager.build_slot_maps(ids)
    dids = jp.tokenizer(DELTA)
    dslots = jp.embedding_manager.build_slot_maps(dids)
    lat = rng.standard_normal((b, 16, 16, 4)).astype(np.float32)
    noise = rng.standard_normal((b, 16, 16, 4)).astype(np.float32)
    fg = np.zeros((b, 16, 16, 1), np.float32)
    fg[0, 3:12, 4:13] = 1
    fg[1, 5:15, 2:9] = 1
    img = np.zeros((b, 16, 16, 1), np.float32)
    img[:, 1:15, 2:16] = 1
    have = np.array([1.0, 0.0], np.float32)
    j = jts.ReconBatch(
        latents=jnp.asarray(lat), token_ids=jnp.asarray(ids),
        slot_maps={k: jnp.asarray(v) for k, v in slots.items()}, fg_mask=jnp.asarray(fg),
        timesteps=jnp.asarray(t, jnp.int32), noise=jnp.asarray(noise),
        img_mask=jnp.asarray(img), have_fg_mask=jnp.asarray(have),
        delta_token_ids=jnp.asarray(dids),
        delta_slot_maps={k: jnp.asarray(v) for k, v in dslots.items()})
    tt = lambda a: torch.from_numpy(np.asarray(a))
    p = tts.ReconBatch(latents=tt(lat), token_ids=ids, slot_maps=slots, fg_mask=tt(fg),
                       timesteps=torch.tensor(t, dtype=torch.int32), noise=tt(noise),
                       img_mask=tt(img), have_fg_mask=tt(have), delta_token_ids=dids,
                       delta_slot_maps=dslots)
    return j, p


@pytest.fixture(scope="module")
def jax_value_and_grad(pipes):
    jp, _ = pipes
    step = jts.make_recon_train_step(jp.clip, jp.clip_params, jp.unet, jp.unet_params,
                                     jp.base_sched, None, **STEP_KW)
    vg = jax.jit(jax.value_and_grad(step.loss_fn, has_aux=True))
    fz = {"clip": jp.clip_params, "unet": jp.unet_params}
    return lambda emb, batch: vg(emb, batch, fz)


def _port_embedders(tp):
    """Fresh grad-requiring copies of the port's embedders."""
    return {s: dataclasses.replace(p, **{n: t.detach().clone().requires_grad_(True)
                                         for n, t in embedder_leaves(p)})
            for s, p in tp.embedding_manager.embedders.items()}


def _assert_grads_close(got, ref, tol=2e-4):
    for s in sorted(ref):
        for name, t in embedder_leaves(got[s]):
            r = np.asarray(getattr(ref[s], name))
            scale = np.abs(r).max()
            assert scale > 0, (s, name)
            np.testing.assert_allclose(t.grad.numpy(), r, atol=tol * scale, rtol=0,
                                       err_msg=f"{s}.{name}")


def test_recon_loss_fn_matches(pipes, jax_value_and_grad):
    jp, tp = pipes
    jb, tb = _batch(jp, np.random.default_rng(0), [501, 120])
    (jloss, jmetrics), jgrads = jax_value_and_grad(jp.embedding_manager.embedders, jb)
    step = tts.make_recon_train_step(tp.clip, tp.unet, tp.base_sched, None, **STEP_KW)
    emb = _port_embedders(tp)
    loss, metrics = step.loss_fn(emb, tb)
    loss.backward()
    assert set(metrics) == set(jmetrics)
    assert {"fg_bg_complem", "fg_xlayer_consist", "prompt_delta", "recon"} <= set(metrics)
    for k in sorted(metrics):
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    _assert_grads_close(emb, jgrads)


def test_bf16_recon_loss_sits_as_far_from_fp32_as_jax(pipes):
    """The recon loss in bf16 under the default Upsample (JAX's phase fold,
    its taps summed in bf16) against fp32 on the same bf16-rounded weights
    and batch, in each package: the port's bf16 loss sits no further from
    its fp32 loss than JAX's does (measured 5.4e-5 against 2.7e-4), both
    within chip_smoke's TRAIN_LOSS_TOL. JAX's Pallas kernels run in
    interpret mode, the port's wrappers their plain versions."""
    import copy

    from adaface_tpu.models.clip_text import CLIPTextEncoder as JCLIP
    from adaface_tpu.models.unet import UNetModel as JUNet

    jp, tp = pipes
    jb, tb = _batch(jp, np.random.default_rng(0), [501, 120])
    rounded = {n: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), t)
               for n, t in (("clip", jp.clip_params), ("unet", jp.unet_params))}
    gaps = {}
    for who in ("jax", "port"):
        loss = {}
        for dt in ("bf16", "fp32"):
            if who == "jax":
                jdt = jnp.bfloat16 if dt == "bf16" else jnp.float32
                fz = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), rounded)
                step = jts.make_recon_train_step(JCLIP(jp.clip.cfg, jdt), fz["clip"],
                                                 JUNet(jp.unet.cfg, jdt), fz["unet"],
                                                 jp.base_sched, None, **STEP_KW)
                loss[dt] = float(step.loss_fn(jp.embedding_manager.embedders, jb, fz)[0])
            else:
                tdt = torch.bfloat16 if dt == "bf16" else torch.float32
                clip, unet = (copy.deepcopy(m).to(torch.bfloat16).to(tdt)
                              for m in (tp.clip, tp.unet))
                step = tts.make_recon_train_step(clip, unet, tp.base_sched, None, **STEP_KW)
                with torch.no_grad():
                    loss[dt] = step.loss_fn(_port_embedders(tp), tb)[0].item()
        gaps[who] = abs(loss["bf16"] - loss["fp32"]) / abs(loss["fp32"])
    assert 0 < gaps["port"] <= max(gaps["jax"], 1e-4), gaps
    assert gaps["jax"] <= chip_smoke.TRAIN_LOSS_TOL, gaps


def test_accumulated_update_matches(pipes, jax_value_and_grad):
    """Two micro-steps through MultiSteps(chain(clip 0.5, prodigy d_coef
    10), 2) on the JAX side (its gradients from the same loss_fn) and
    through the port's step: the parameters and the Prodigy first moment
    (d-scaled clipped mean gradient) after the update."""
    jp, tp = pipes
    rng = np.random.default_rng(1)
    batches = [_batch(jp, rng, t) for t in ([900, 30], [250, 610])]
    opt = optax.MultiSteps(optax.chain(optax.clip_by_global_norm(0.5),
                                       j_prodigy(learning_rate=1.0, d_coef=10.0)), 2)
    jemb = jp.embedding_manager.embedders
    state = opt.init(jemb)
    for jb, _ in batches:
        _, g = jax_value_and_grad(jemb, jb)
        upd, state = opt.update(g, state, jemb)
        jemb = optax.apply_updates(jemb, upd)

    emb = _port_embedders(tp)
    params = [t for s in sorted(emb) for _, t in embedder_leaves(emb[s])]
    chain = AccumulatedClipped(Prodigy(params, lr=1.0, d_coef=10.0), 0.5, every_k=2)
    step = tts.make_recon_train_step(tp.clip, tp.unet, tp.base_sched, chain, **STEP_KW)
    for _, tb in batches:
        step(emb, tb)
    assert chain.mini_step == 0 and chain.inner.step_count == 1
    ref_m = jax.tree_util.tree_leaves(state.inner_opt_state[1].exp_avg)
    for t, m, r in zip(params, chain.inner.exp_avg, ref_m):
        r = np.asarray(r)
        np.testing.assert_allclose(m.numpy(), r, atol=2e-4 * np.abs(r).max(), rtol=0)
    for s in sorted(emb):
        for name, t in embedder_leaves(emb[s]):
            before = getattr(jp.embedding_manager.embedders[s], name)
            after = np.asarray(getattr(jemb[s], name))
            assert np.abs(after - np.asarray(before)).max() > 0, (s, name)
            np.testing.assert_allclose(t.detach().numpy(), after, rtol=1e-6, atol=1e-6,
                                       err_msg=f"{s}.{name}")


@pytest.fixture(scope="module")
def subject_dir(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("subj")
    rng = np.random.default_rng(0)
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (48, 48, 3)).astype(np.uint8)).save(d / f"{i}.png")
        if i != 1:  # one image without a mask: has_fg_mask False
            m = np.zeros((48, 48), np.uint8)
            m[10:38, 12:36] = 255
            Image.fromarray(m).save(d / f"{i}_mask.png")
    return str(d)


PLAN_KW = dict(composition_regs_iter_gap=0, do_zero_shot=False,
               prompt_emb_delta_reg_weight=2e-4, mix_prompt_distill_weight=2e-4,
               arc2face_distill_iter_prob=0.0)


def test_trainer_builds_the_same_batches(pipes, subject_dir, tmp_path):
    jp, tp = pipes
    cfg = dict(batch_size=2, max_steps=100, seed=3, log_every_steps=1000,
               ckpt_every_steps=1000)
    jtr = JTrainer(jp, JDataset([JSpec("s", subject_dir)], size=32, seed=0),
                   JTrainerConfig(logdir=str(tmp_path / "j"), **cfg), JPlanConfig(**PLAN_KW))
    ttr = Trainer(tp, PersonalizedDataset([SubjectSpec("s", subject_dir)], size=32, seed=0),
                  TrainerConfig(logdir=str(tmp_path / "t"), **cfg), IterPlanConfig(**PLAN_KW))
    jrec, trec = [], []
    jtr._get_recon_step = lambda *a: (lambda e, o, b, f=None: (jrec.append(b) or (e, o, {})))
    ttr._get_recon_step = lambda *a: (lambda e, b: (trec.append(b) or {}))
    jtr.fit(4)
    ttr.fit(4)
    ttr.close()
    assert len(jrec) == len(trec) == 4
    noise_steps = 0
    for jb, tb in zip(jrec, trec):
        np.testing.assert_allclose(tb.latents.numpy(), np.asarray(jb.latents), atol=1e-4)
        for name in ("token_ids", "fg_mask", "timesteps", "noise", "img_mask",
                     "have_fg_mask", "delta_token_ids"):
            np.testing.assert_array_equal(np.asarray(getattr(tb, name)),
                                          np.asarray(getattr(jb, name)), err_msg=name)
        for maps in ("slot_maps", "delta_slot_maps"):
            a, b = getattr(tb, maps), getattr(jb, maps)
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
        if jb.emb_noise_std is None:
            assert tb.emb_noise_std is None
        else:
            noise_steps += 1
            assert tb.emb_noise_std == pytest.approx(float(jb.emb_noise_std))
            assert tb.emb_noise_seed == int(np.asarray(jb.emb_noise_key)[-1])
    assert 0 < noise_steps < 4  # both kinds of step were drawn
    assert any(np.asarray(b.have_fg_mask).min() == 0 for b in jrec)


def test_port_fit_writes_a_checkpoint_jax_reads(pipes, subject_dir, tmp_path):
    _, tp = pipes
    before = {s: {n: t.detach().clone() for n, t in embedder_leaves(p)}
              for s, p in tp.embedding_manager.embedders.items()}
    tr = Trainer(tp, PersonalizedDataset([SubjectSpec("s", subject_dir)], size=32, seed=0),
                 TrainerConfig(batch_size=2, max_steps=4, seed=0, log_every_steps=1000,
                               logdir=str(tmp_path)), IterPlanConfig(**PLAN_KW))
    try:
        tr.fit()
    finally:
        tr.close()
        # leave the shared pipeline as the other tests expect it
        for s, p in tp.embedding_manager.embedders.items():
            for n, t in embedder_leaves(p):
                t.requires_grad_(False)
    assert tr.global_step == 4 and tr.optimizer.inner.step_count == 2
    mgr = JEM.load_native(str(tmp_path / "embeddings_last.npz"))
    moved = 0.0
    for s, p in tp.embedding_manager.embedders.items():
        for n, t in embedder_leaves(p):
            np.testing.assert_array_equal(np.asarray(getattr(mgr.embedders[s], n)),
                                          t.detach().numpy())
            assert np.isfinite(t.detach().numpy()).all()
            moved = max(moved, float((t.detach() - before[s][n]).abs().max()))
    assert moved > 0
    with torch.no_grad():  # restore the shared embedders
        for s, p in tp.embedding_manager.embedders.items():
            for n, t in embedder_leaves(p):
                t.copy_(before[s][n])


def test_port_fit_on_the_shipped_gap_writes_a_checkpoint_jax_reads(pipes, subject_dir, tmp_path):
    """`fit(4)` at the shipped `composition_regs_iter_gap: 3`: steps 0 and 3
    are compositional (one block, 4 UNet rows), 1 and 2 recon; both kinds
    log finite metrics, the embedders move, and JAX's loader reads the
    checkpoint."""
    import json

    _, tp = pipes
    before = {s: {n: t.detach().clone() for n, t in embedder_leaves(p)}
              for s, p in tp.embedding_manager.embedders.items()}
    tr = Trainer(tp, PersonalizedDataset([SubjectSpec("s", subject_dir)], size=32, seed=0),
                 TrainerConfig(batch_size=2, max_steps=4, seed=1, log_every_steps=1000,
                               logdir=str(tmp_path)),
                 IterPlanConfig(**dict(PLAN_KW, composition_regs_iter_gap=3)))
    try:
        tr.fit()
    finally:
        tr.close()
        for s, p in tp.embedding_manager.embedders.items():
            for n, t in embedder_leaves(p):
                t.requires_grad_(False)
    assert tr.global_step == 4 and tr.optimizer.inner.step_count == 2
    recs = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    kinds = [r["iter_type"] for r in recs if "loss" in r]
    assert kinds == ["compos_distill", "recon", "recon", "compos_distill"], kinds
    assert all(np.isfinite(v) for r in recs for v in r.values() if isinstance(v, float))
    assert all(r["feat_align"] > 0 and r["prompt_delta"] > 0 for r in recs
               if r.get("iter_type") == "compos_distill")
    mgr = JEM.load_native(str(tmp_path / "embeddings_last.npz"))
    moved = 0.0
    for s, p in tp.embedding_manager.embedders.items():
        for n, t in embedder_leaves(p):
            np.testing.assert_array_equal(np.asarray(getattr(mgr.embedders[s], n)),
                                          t.detach().numpy())
            moved = max(moved, float((t.detach() - before[s][n]).abs().max()))
    assert moved > 0
    with torch.no_grad():  # restore the shared embedders
        for s, p in tp.embedding_manager.embedders.items():
            for n, t in embedder_leaves(p):
                t.copy_(before[s][n])
