"""The webdataset compositor in the port (`data/wds.py`, the trainers' wds
paths, the fg vs comp-extra loss battery) against the JAX package's, on the
same synthetic tar shards, fp32 on the CPU.

- The stream, the filters (human/animal words, placeholder tokens, aspect,
  too-small sources), `next_background`, `composite` (every key, arrays bit
  for bit, with and without the dedicated `w` substitution) and
  `repl_bg_as_wbg` equal JAX's; PNG members decode through `data/png.py`,
  a JPEG member through PIL.
- The trainers' wds helpers on stub trainers seeded alike: the recon swap
  (images, captions, the class flavor, the bg-token upgrade, the plan's
  flags), the compos swap and its prompts, the bg-only x_start kept intact,
  the comp-extra mask (with the class token absorbed), the gating of the
  `w` substitution, and the wds recon t decrease, all equal to JAX's.
- The losses: `fg_bg_complementary_loss(do_sqrt_norm=True)` (values and
  score gradients); the recon step
  and the zero-shot recon step with the wds battery on (loss, every metric
  at rtol 1e-5, gradients at the train-step tests' tolerances).
- The integration: from one seed, JAX's and the port's `Trainer` and
  `ZeroShotTrainer` with the compositor forced on build the same recon and
  compos batches (the comp-extra mask included); a port `ZeroShotTrainer`
  run logs a nonzero `fg_wds_complem` on every recon step."""

import io
import json
import os
import tarfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaface_tpu.data import wds as jwds
from adaface_tpu.data.personalized import PersonalizedDataset as JDataset
from adaface_tpu.data.personalized import SubjectSpec as JSpec
from adaface_tpu.training import losses as jl
from adaface_tpu.training import train_step as jts
from adaface_tpu.training.iter_plan import IterPlan as JIterPlan
from adaface_tpu.training.iter_plan import IterPlanConfig as JPlanConfig
from adaface_tpu.training.iter_plan import sample_timesteps as j_sample_timesteps
from adaface_tpu.training.trainer import Trainer as JTrainer
from adaface_tpu.training.trainer import TrainerConfig as JTrainerConfig

from adaface_tpu_torch.data import wds as twds
from adaface_tpu_torch.data.personalized import PersonalizedDataset, SubjectSpec
from adaface_tpu_torch.training import losses as tl
from adaface_tpu_torch.training import train_step as tts
from adaface_tpu_torch.training.iter_plan import IterPlan, IterPlanConfig, sample_timesteps
from adaface_tpu_torch.training.trainer import Trainer, TrainerConfig

from test_torch_train_step import (  # noqa: F401
    STEP_KW,
    _assert_grads_close,
    _batch,
    _port_embedders,
    jax_value_and_grad,
    pipes,
    subject_dir,
)

torch.set_num_threads(2)


def _add(tf, name, data: bytes):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def _img_bytes(rng, h, w, fmt="PNG"):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (h, w, 3)).astype(np.uint8)).save(buf, format=fmt)
    return buf.getvalue()


def _meta(caption, w=64, h=64, ow=640, oh=640):
    return json.dumps({"caption": caption, "width": w, "height": h,
                       "original_width": ow, "original_height": oh}).encode()


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    """A shard with good and filtered samples of every kind, a .txt caption,
    a JPEG member and a padded (letterboxed) source."""
    rng = np.random.default_rng(0)
    path = tmp_path_factory.mktemp("wds") / "shard-000.tar"
    with tarfile.open(path, "w") as tf:
        _add(tf, "000.png", _img_bytes(rng, 64, 64))
        _add(tf, "000.json", _meta("a sunny mountain landscape with trees"))
        _add(tf, "001.png", _img_bytes(rng, 64, 64))
        _add(tf, "001.json", _meta("a man walking on the beach"))  # human
        _add(tf, "002.png", _img_bytes(rng, 64, 64))
        _add(tf, "002.json", _meta("a quiet forest clearing at dawn", ow=64, oh=64))  # small
        _add(tf, "003.png", _img_bytes(rng, 64, 64))
        _add(tf, "003.txt", b"an empty cobblestone alley in the rain")
        _add(tf, "004.jpg", _img_bytes(rng, 48, 64, "JPEG"))
        _add(tf, "004.json", _meta("old red barn under a grey sky", w=64, h=48, ow=800, oh=600))
        _add(tf, "005.png", _img_bytes(rng, 64, 64))
        _add(tf, "005.json", _meta("a wide panorama of dunes", w=64, h=32, ow=1280, oh=640))
        _add(tf, "006.png", _img_bytes(rng, 64, 64))
        _add(tf, "006.json", _meta("the letter z carved into stone"))  # placeholder
        _add(tf, "007.png", _img_bytes(rng, 70, 64))
        _add(tf, "007.json", _meta("a lake at dusk", w=64, h=70, ow=640, oh=700))
    return str(path)


def _same_example(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(b[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def test_stream_matches_jax(shard):
    jg, tg = jwds.stream_tar_shards([shard]), twds.stream_tar_shards([shard])
    for _ in range(11):  # past the shard's end: it loops
        (ji, jm), (ti, tm) = next(jg), next(tg)
        np.testing.assert_array_equal(ti, ji)
        assert tm == jm


@pytest.mark.parametrize("size,max_tries", [(96, 100), (48, 100), (32, 2)])
def test_filters_match_jax(shard, size, max_tries):
    j = jwds.BackgroundCompositor([shard], size=size, max_tries=max_tries)
    t = twds.BackgroundCompositor([shard], size=size, max_tries=max_tries)
    seen = set()
    for _ in range(6):
        jb, tb = j.next_background(), t.next_background()
        assert (jb is None) == (tb is None)
        if jb is not None:
            np.testing.assert_array_equal(tb[0], jb[0])
            assert tb[1] == jb[1] and not twds.HUMAN_ANIMAL_PAT.search(tb[1])
            seen.add(tb[1])
    if max_tries == 100:
        assert "old red barn under a grey sky" in seen and "a man walking on the beach" not in seen


def _example(rng, size=48, name="s"):
    img = rng.integers(0, 255, (size, size, 3)).astype(np.uint8)
    fg = np.zeros((size, size), np.uint8)
    fg[10:30, 10:30] = 1
    return {"subject_name": name, "caption": "a photo of a z",
            "caption_bg": "a photo of a z with background y", "image_unnorm": img,
            "image": (img / 127.5 - 1.0).astype(np.float32), "fg_mask": fg,
            "aug_mask": np.ones((size, size), np.uint8)}


@pytest.mark.parametrize("strings", [(None, None), ("y", "w")])
def test_composite_matches_jax(shard, strings):
    j = jwds.BackgroundCompositor([shard], size=48)
    t = twds.BackgroundCompositor([shard], size=48)
    for i in range(3):
        je = j.composite(_example(np.random.default_rng(i)), "person", *strings)
        te = t.composite(_example(np.random.default_rng(i)), "person", *strings)
        assert te["has_wds_comp"]
        _same_example(te, je)
    assert ("background w" in te["wds_caption_bg"]) == (strings[1] == "w")
    none = twds.BackgroundCompositor([shard], size=32, max_tries=1)
    next(none.stream)  # the next sample is filtered, so one try finds nothing
    jnone = jwds.BackgroundCompositor([shard], size=32, max_tries=1)
    next(jnone.stream)
    _same_example(none.composite(_example(np.random.default_rng(5), 32), "person"),
                  jnone.composite(_example(np.random.default_rng(5), 32), "person"))


@pytest.mark.parametrize("args", [("a z with background y, , ,", "y", "w"),
                                  ("a z with background y", None, "w"),
                                  ("a z with background y", "y", None),
                                  ("yellow barn", "y", "w"), ("y y. (y)", "y", "w")])
def test_repl_bg_as_wbg_matches_jax(args):
    assert twds.repl_bg_as_wbg(*args) == jwds.repl_bg_as_wbg(*args)


# ------------------------------------------------------------- trainer helpers
class _Spec:
    name, cls_delta_string, background_string = "s", "person", "y"


class _Tok:
    bos_id, eos_id = 0, 1


class _Ph:
    def __init__(self, is_background):
        self.is_background = is_background


def _stub(cls, cfg_cls, shard, placeholders=("z", "y"), **cfg_kw):
    """A trainer of class `cls` without its models: what the wds helpers read."""
    tr = cls.__new__(cls)
    tr.cfg = cfg_cls(**cfg_kw)
    tr.plan_cfg = (JPlanConfig if cls is JTrainer else IterPlanConfig)()
    tr.rng = np.random.default_rng(0)
    tr.compositor = (jwds if cls is JTrainer else twds).BackgroundCompositor([shard], size=48)
    tr.cached_inits = None
    tr.dataset = type("DS", (), {"subjects": [_Spec()]})()
    tr.pipe = type("Pipe", (), {"tokenizer": _Tok()})()
    tr.mgr = type("Mgr", (), {"placeholders": {s: _Ph(s != "z") for s in placeholders}})()
    return tr


def _stubs(shard, **kw):
    return (_stub(JTrainer, JTrainerConfig, shard, **kw),
            _stub(Trainer, TrainerConfig, shard, **kw))


def _plans(**kw):
    return JIterPlan(**kw), IterPlan(**kw)


@pytest.mark.parametrize("p,tp,bg", [(1.0, 0.0, False), (1.0, 0.9, True), (0.5, 0.3, False),
                                     (0.0, 0.0, False)])
def test_wds_recon_swap_matches_jax(shard, p, tp, bg):
    """Over 12 iterations: the same rolls, the class flavor, the bg-token
    upgrade, and the same examples after the swap."""
    jtr, ttr = _stubs(shard, placeholders=("z", "y", "w"), p_wds_comp_recon=p)
    rng_j, rng_t = np.random.default_rng(3), np.random.default_rng(3)
    outcomes = set()
    for _ in range(12):
        jex, tex = [_example(rng_j), _example(rng_j)], [_example(rng_t), _example(rng_t)]
        jplan, tplan = _plans(iter_type="recon", training_percent=tp, use_background_token=bg)
        jplan, *jflags = jtr._wds_recon_swap(jplan, jex)
        tplan, *tflags = ttr._wds_recon_swap(tplan, tex)
        assert tflags == jflags
        assert (tplan.use_background_token, tplan.use_wds_comp) == \
            (jplan.use_background_token, jplan.use_wds_comp)
        for a, b in zip(tex, jex):
            _same_example(a, b)
        outcomes.add((tuple(tflags), tplan.use_background_token))
    assert ttr.rng.bit_generator.state == jtr.rng.bit_generator.state
    if p == 1.0 and tp == 0.0:  # both flavors and both upgrade outcomes drawn
        assert {o[0][1] for o in outcomes} == {False, True}
        assert {o[1] for o in outcomes} == {False, True}
    if p == 0.0:
        assert outcomes == {((False, False), False)}


@pytest.mark.parametrize("p", [1.0, 0.0])
def test_wds_compos_swap_matches_jax(shard, p):
    jtr, ttr = _stubs(shard, p_wds_comp_compos=p)
    je, te = _example(np.random.default_rng(5)), _example(np.random.default_rng(5))
    jplan, tplan = _plans(iter_type="compos_distill")
    jtr._wds_compos_swap(jplan, [je])
    ttr._wds_compos_swap(tplan, [te])
    _same_example(te, je)
    assert (tplan.use_wds_comp, tplan.comp_init_fg_from_training_image) == \
        (jplan.use_wds_comp, jplan.comp_init_fg_from_training_image) == (p > 0, p > 0)
    prompts = ["a z", "a z riding a bike", "a person", "a person riding a bike"]
    assert ttr._wds_comp_prompts(tplan, te, prompts) == jtr._wds_comp_prompts(jplan, je, prompts)
    if p > 0:
        np.testing.assert_array_equal(te["image"], te["wds_image_bgonly"])
        lat = torch.randn(1, 4, 4, 4)
        out = ttr._compos_x_start(tplan, [te], lat, np.ones((1, 4, 4, 1), np.float32), prompts)
        assert out[0] is lat and out[3] is None  # x_start kept intact, no prev t


def test_wds_extra_mask_matches_jax(shard):
    jtr, ttr = _stubs(shard)
    rng = np.random.default_rng(6)
    ids = rng.integers(2, 50, (3, 12))
    ids[:, 0] = 0
    ids[0, 8:], ids[1, 10:], ids[2, 6:] = 1, 1, 1
    slots = {"z": -np.ones((3, 12), np.int64), "y": -np.ones((3, 12), np.int64)}
    slots["z"][:, 2:4] = [0, 1]
    slots["y"][:2, 6] = 0
    for ext in (False, True):
        want = jtr._wds_extra_mask(ids, slots, extend_subj_by_one=ext)
        got = ttr._wds_extra_mask(ids, slots, extend_subj_by_one=ext)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ttr._wds_extra_mask(ids[:1, :8], {k: v[:1, :8] for k, v in
                                                                    slots.items()}, True)[0],
                                  [0, 1, 0, 0, 0, 1, 0, 1])


@pytest.mark.parametrize("registered", [False, True])
def test_w_substitution_only_when_registered(shard, registered):
    names = ("z", "y", "w") if registered else ("z", "y")
    jtr, ttr = _stubs(shard, placeholders=names)
    je, te = _example(np.random.default_rng(10)), _example(np.random.default_rng(10))
    jtr._composite(je)
    ttr._composite(te)
    _same_example(te, je)
    assert ("background w" in te["wds_caption_bg"]) == registered


def test_wds_recon_t_decrease_matches_jax():
    cfg, jcfg = IterPlanConfig(do_zero_shot=True), JPlanConfig(do_zero_shot=True)
    for wds in (True, False):
        plan, jplan = IterPlan(iter_type="recon", use_wds_comp=wds, training_percent=1.0), \
            JIterPlan(iter_type="recon", use_wds_comp=wds, training_percent=1.0)
        rt, rj = np.random.default_rng(8), np.random.default_rng(8)
        ts = np.concatenate([sample_timesteps(rt, plan, 64, cfg) for _ in range(5)])
        tj = np.concatenate([j_sample_timesteps(rj, jplan, 64, jcfg) for _ in range(5)])
        np.testing.assert_array_equal(ts, tj)
        if wds:
            assert ts.max() < cfg.num_timesteps
            wds_mean = ts.mean()
    assert wds_mean < ts.mean()  # the plain zero-shot path shifts t up


# -------------------------------------------------------------------- losses
def _scores(rng, B=2, H=2, T=12):
    """Cross-attention scores of two distillation layers (Q 64 and 16)."""
    return {i: rng.standard_normal((B, H, q, T)).astype(np.float32)
            for i, q in ((7, 64), (8, 16))}


def test_wds_complementary_loss_matches_jax():
    rng = np.random.default_rng(11)
    scores = _scores(rng)
    subj = np.zeros((2, 12), np.float32)
    subj[:, 2:5] = 1
    extra = np.zeros((2, 12), np.float32)
    extra[0, 6:11], extra[1, 6:9] = 1, 1  # different counts: the sqrt norms differ
    fg = np.zeros((2, 8, 8, 1), np.float32)
    fg[:, 2:6, 1:5] = 1
    inst = np.array([1.0, 0.0], np.float32)

    def jfn(sc):
        out = jl.fg_bg_complementary_loss(sc, jnp.asarray(subj), jnp.asarray(extra),
                                          jnp.asarray(fg), instance_mask=jnp.asarray(inst),
                                          fg_grad_scale=0.1, do_sqrt_norm=True)
        return sum(out), out

    (_, jout), jgrad = jax.value_and_grad(jfn, has_aux=True)(
        {k: jnp.asarray(v) for k, v in scores.items()})
    ts = {k: torch.tensor(v, requires_grad=True) for k, v in scores.items()}
    out = tl.fg_bg_complementary_loss(ts, torch.tensor(subj), torch.tensor(extra),
                                      torch.tensor(fg), instance_mask=torch.tensor(inst),
                                      fg_grad_scale=0.1, do_sqrt_norm=True)
    sum(out).backward()
    for a, b in zip(out, jout):
        np.testing.assert_allclose(a.item(), float(b), rtol=1e-5, atol=1e-7)
    plain = tl.fg_bg_complementary_loss({k: v.detach() for k, v in ts.items()},
                                        torch.tensor(subj), torch.tensor(extra), torch.tensor(fg))
    # the cosine term is blind to a per-instance scale; the margins are not
    assert abs(sum(plain[1:]).item() - sum(out[1:]).item()) > 1e-3
    for k in ts:
        g = np.asarray(jgrad[k])
        np.testing.assert_allclose(ts[k].grad.numpy(), g, atol=1e-5 * np.abs(g).max(), rtol=0)


def _extra_mask(jp, ids, slots):
    tok = jp.tokenizer
    real = ((ids != tok.bos_id) & (ids != tok.eos_id)).astype(np.float32)
    for m in slots.values():
        real = real * (np.asarray(m) < 0)
    return real


def test_recon_step_with_the_wds_battery_matches_jax(pipes):
    jp, tp = pipes
    jb, tb = _batch(jp, np.random.default_rng(0), [501, 120])
    mask = _extra_mask(jp, np.asarray(tb.token_ids), tb.slot_maps)
    assert mask.sum() > 4
    jb = jb._replace(wds_extra_token_mask=jnp.asarray(mask))
    tb = tb._replace(wds_extra_token_mask=torch.from_numpy(mask))
    kw = dict(STEP_KW, bg_weight=0.05, wds_complem_weight=0.5)
    jstep = jts.make_recon_train_step(jp.clip, jp.clip_params, jp.unet, jp.unet_params,
                                      jp.base_sched, None, **kw)
    fz = {"clip": jp.clip_params, "unet": jp.unet_params}
    (_, jmetrics), jgrads = jax.jit(jax.value_and_grad(jstep.loss_fn, has_aux=True))(
        jp.embedding_manager.embedders, jb, fz)
    step = tts.make_recon_train_step(tp.clip, tp.unet, tp.base_sched, None, **kw)
    emb = _port_embedders(tp)
    loss, metrics = step.loss_fn(emb, tb)
    loss.backward()
    assert set(metrics) == set(jmetrics) and {"fg_wds_complem", "wds_mask_align"} <= set(metrics)
    assert abs(metrics["fg_wds_complem"].item()) > 0
    for k in sorted(metrics):
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    _assert_grads_close(emb, jgrads)


def test_zs_recon_step_with_the_wds_battery_matches_jax(zs):
    import test_torch_zs_train as z

    jp, tp = zs["jp"], zs["tp"]
    jb, pb = z._recon_batches(zs, True)
    mask = _extra_mask(jp, np.asarray(pb.token_ids), pb.slot_maps)
    jb = jb._replace(wds_extra_token_mask=jnp.asarray(mask))
    pb = pb._replace(wds_extra_token_mask=torch.from_numpy(mask))
    kw = dict(z.RECON_KW, wds_complem_weight=0.5)
    jstep = jts.make_zero_shot_recon_step(
        jp.clip, jp.clip_params, jp.unet, jp.unet_params, jp.base_sched, z._capture_grads(),
        **z._jax_kw(zs), bg_weight=0.05, use_bg_token=True, **kw)
    jmetrics, jgrads = z._jax_step(jstep, zs, jb, {"clip": jp.clip_params,
                                                   "unet": jp.unet_params,
                                                   "arc": zs["arc_params"]})
    gens = zs["port_gens"](zs["gparams"])
    step = tts.make_zero_shot_recon_step(tp.clip, tp.unet, tp.base_sched, None,
                                         **z._port_kw(zs), bg_weight=0.05, use_bg_token=True,
                                         **kw)
    loss, metrics = step.loss_fn(gens, pb)
    assert "fg_wds_complem" in metrics and abs(metrics["fg_wds_complem"].item()) > 0
    z._check(metrics, loss, jmetrics, jgrads, gens)


# --------------------------------------------------------------- integration
from test_torch_zs_train import zs  # noqa: E402,F401

WDS_CFG = dict(p_wds_comp_recon=1.0, p_wds_comp_compos=1.0,
               fg_wds_complementary_loss_weight=2e-4)
PLAN_KW = dict(composition_regs_iter_gap=3, do_zero_shot=False,
               prompt_emb_delta_reg_weight=2e-4, arc2face_distill_iter_prob=0.0)
RECON_FIELDS = ("token_ids", "fg_mask", "timesteps", "noise", "img_mask", "have_fg_mask",
                "delta_token_ids", "wds_extra_token_mask")
COMPOS_FIELDS = ("token_ids", "subj_slot_map", "fg_mask", "timesteps", "noise", "t_frac")


def _compare(jrec, trec):
    assert [type(b).__name__ for b in trec] == [type(b).__name__ for b in jrec]
    masks = 0
    for jb, tb in zip(jrec, trec):
        np.testing.assert_allclose(tb.latents.numpy(), np.asarray(jb.latents), atol=1e-4)
        fields = COMPOS_FIELDS if "Compos" in type(tb).__name__ else RECON_FIELDS
        for name in fields:
            a, b = getattr(tb, name), getattr(jb, name)
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_array_equal(np.asarray(a, np.float32),
                                              np.asarray(b, np.float32), err_msg=name)
        masks += getattr(tb, "wds_extra_token_mask", None) is not None
        assert sorted(tb.slot_maps) == sorted(jb.slot_maps)
        for k in tb.slot_maps:
            np.testing.assert_array_equal(tb.slot_maps[k], np.asarray(jb.slot_maps[k]))
    return masks


def test_trainers_build_the_same_wds_batches(pipes, subject_dir, shard, tmp_path):
    jp, tp = pipes
    cfg = dict(batch_size=2, max_steps=100, seed=2, log_every_steps=1000, ckpt_every_steps=1000,
               wds_shards=(shard,), **WDS_CFG)
    jtr = JTrainer(jp, JDataset([JSpec("s", subject_dir)], size=32, seed=0),
                   JTrainerConfig(logdir=str(tmp_path / "j"), **cfg), JPlanConfig(**PLAN_KW))
    ttr = Trainer(tp, PersonalizedDataset([SubjectSpec("s", subject_dir)], size=32, seed=0),
                  TrainerConfig(logdir=str(tmp_path / "t"), **cfg), IterPlanConfig(**PLAN_KW))
    jrec, trec, keys = [], [], []
    jtr._get_recon_step = lambda *a: (lambda e, o, b, f=None: (jrec.append(b) or (e, o, {})))
    jtr._get_compos_step = jtr._get_recon_step
    ttr._get_recon_step = lambda *a: (keys.append(a) or (lambda e, b: (trec.append(b) or {})))
    ttr._get_compos_step = lambda: (lambda e, b: (trec.append(b) or {}))
    jtr.fit(5)
    ttr.fit(5)
    ttr.close()
    assert len(trec) == 5 and _compare(jrec, trec) == 3
    assert all(use_wds for _, use_wds in keys)
    recs = [json.loads(line) for line in open(tmp_path / "t" / "metrics.jsonl")]
    assert [r["wds_comp"] for r in recs if "iter_type" in r] == [1.0] * 5
    compos = [b for b in trec if isinstance(b, tts.ComposBatch)]
    assert compos and all(b.preserve_loss_scale == 0.5 for b in compos)  # fg-init forced


def test_zs_trainers_build_the_same_wds_batches_and_train(zs, subject_dir, shard, tmp_path):
    import test_torch_zs_train as z

    cfg = dict(wds_shards=(shard,), **WDS_CFG)
    jtr, ttr = z._trainers(zs, subject_dir, tmp_path, **cfg)
    jtr.plan_cfg.arc2face_distill_iter_prob = ttr.plan_cfg.arc2face_distill_iter_prob = 0.0
    jrec, trec = z._recording(jtr, ttr)
    jtr.fit(4)
    ttr.fit(4)
    ttr.close()
    assert _compare(jrec, trec) == 2  # compos at steps 0 and 3
    # a real port run: every recon step takes the composite and its battery
    _, run = z._trainers(zs, subject_dir, tmp_path / "run", **cfg)
    run.plan_cfg.arc2face_distill_iter_prob = 0.0
    run.fit(3)
    run.close()
    recs = [json.loads(line) for line in open(os.path.join(run.cfg.logdir, "metrics.jsonl"))]
    recon = [r for r in recs if r.get("iter_type") == "recon"]
    assert len(recon) == 2 and all(r["wds_comp"] == 1.0 for r in recon)
    assert all(abs(r["fg_wds_complem"]) > 0 for r in recon)
    assert all(np.isfinite(r["loss"]) for r in recs if "loss" in r)
