"""The port's trainers over two gloo ranks on the CPU, fp32: data parallelism
as the JAX trainers run it (`adaface_tpu/training/trainer.py`, `zs_trainer.py`,
`scripts/train.py`'s DreamBooth loop).

The ranks run once for the whole file (`ranks`: one launch, started in the
background while the tests compute their one-process references; one thread
a rank, the join bounded), each part below against one process:

- `train.main --num_devices 2 --device cpu` in the ranks (they train on
  their own group) at batch 1 a rank against one process at batch 2,
  after 2 recon-only steps: the static embedders (`Trainer`, AdamW at
  1e-3, which moves them by ~1e-3 a step, so the 3e-5 gate sees a wrong
  gradient) and, with `--zeroshot`, the generators (`ZeroShotTrainer`
  under the file's Prodigy, as JAX's certificate runs it; the state
  ZeRO-1-sharded and saved whole) within JAX's 3e-5
  (`tests/test_trainer_mesh.py`), Prodigy's d numerator (gradient products
  summed over the ranks) within 1e-4 relative, and the logged losses (the
  global ones) within 1e-5 relative; rank 0 alone writes the metrics and
  the checkpoints. (Under AdamW the generators' token table holds entries
  whose gradient is a cancellation of large terms; Adam's normalisation
  turns their last-bit differences into steps of the learning rate's
  size.) `test_torch_cli.py` starts ranks through the entry point itself.
- One compos micro-step at CB 2 (one block a rank; the four prompt types
  sliced by block) against JAX's compos loss at CB 2, with the shipped-off
  regularizers on (the K/V orthogonality reads block 0, on rank 0 only):
  every metric 1e-5 relative, every embedder gradient 2e-4 of its leaf's
  largest entry (the single-process compos test's tolerances).
- `--dreambooth --num_devices 2`: one (train, reg) pair a rank, against one
  process running both pairs (3e-5).
- The zero-shot compos step at CB 2, the embedding noise and the bg
  generator's dropout on, against one process (1e-5 metrics, 1e-4
  gradients), on a port-only zero-shot stack at `test_torch_zs_train`'s
  sizes.
- A filtered compos iteration at CB 2 (each rank denoises its own block's
  candidates, the CLIP losses gathered): the one process's chosen noise and
  timesteps exactly, its cached reconstructions (CFG x0 at scales 5-6, from
  UNet calls of other batch sizes) within 1e-5 of the largest entry.
- A dp-2 trainer's resumable state after 2 of 4 steps, resumed at dp 1
  (batch 2), ends where the dp-2 run ends (3e-5).
"""

import concurrent.futures
import copy
import functools
import json
import os
import types

import numpy as np
import pytest
import torch

import jax

from adaface_tpu_torch import train as ttrain
from adaface_tpu_torch.parallel import mesh as pmesh
from adaface_tpu_torch.training import train_step as tts
from adaface_tpu_torch.training import x_init as tx

import torch_dp_workers as w
from test_torch_compos import REG_KW, RTOL, STEP_KW, _jax_compos_value_and_grad
from test_torch_train_step import pipes  # noqa: F401
from test_torch_zs_train import (D, TXT_KW, UNET_KW, VAE_KW, Y_SLOTS, Z_SLOTS, _gen_kw, _inputs,
                                  _masks)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADA = os.path.join(ROOT, "configs", "finetune-ada.yaml")
DB = os.path.join(ROOT, "configs", "finetune-db.yaml")
TOL = 3e-5


@pytest.fixture(autouse=True)
def bounded_launch(monkeypatch):
    """The entry points start their ranks with no time limit and a share of
    the cores each; here a hung rank fails the test after 600 s, and a rank
    takes one thread."""
    monkeypatch.setattr(pmesh, "launch", functools.partial(pmesh.launch, timeout=600,
                                                           threads=1))


@pytest.fixture(scope="module")
def subject(tmp_path_factory):
    return w.write_subject(str(tmp_path_factory.mktemp("subject")))


@pytest.fixture(scope="module")
def reg(tmp_path_factory):
    return w.write_subject(str(tmp_path_factory.mktemp("reg")), n=2)


ADAMW = ("--optimizer", "adamw", "--lr", "0.001")


def _recon_argv(subject, logdir, batch, extra=()):
    return (["--base", ADA, "--data_root", subject, "--tiny", "--size", "32",
             "--max_steps", "2", "--composition_regs_iter_gap", "0",
             "--accumulate_grad_batches", "1", "--batch_size", str(batch),
             "--logdir", logdir] + list(extra))


def _iter_records(logdir):
    return [json.loads(line) for line in open(os.path.join(logdir, "metrics.jsonl"))
            if "iter_type" in json.loads(line)]


def _compos_batches(jp, rng, CB=2):
    """JAX's and the port's ComposBatch at CB blocks from the same numpy
    arrays (type-major prompts, fg-initialized x_start, compel on the mix
    rows)."""
    import jax.numpy as jnp

    from adaface_tpu.training import train_step as jts

    single = ["a photo of a z , , , , , , , , with background y , , ,",
              "the close-up z , , , , , , , , with background y , , ,"][:CB]
    prompts = (single + [p + " riding a bike" for p in single]
               + [p.replace(" z ", " person ") for p in single]
               + [p.replace(" z ", " person ") + " riding a bike" for p in single])
    ids = jp.tokenizer(prompts)
    slots = jp.embedding_manager.build_slot_maps(ids)
    lat = rng.standard_normal((CB, 16, 16, 4)).astype(np.float32)
    fg = np.zeros((CB, 16, 16, 1), np.float32)
    fg[0, 2:14, 3:12] = 1
    fg[1, 5:16, 1:9] = 1
    lat, fg = tx.init_x_with_fg_from_training_image(np.random.default_rng(5), lat, fg, 0.3)
    noise = rng.standard_normal((CB, 16, 16, 4)).astype(np.float32)
    t = np.asarray([850, 700][:CB])
    mask = np.repeat(np.asarray([0, 0, 1, 1], np.float32), CB)
    ranges = np.asarray([1.0, 1.0, 1.0, 0.85], np.float32)
    j = jts.ComposBatch(
        token_ids=jnp.asarray(ids), slot_maps={k: jnp.asarray(v) for k, v in slots.items()},
        subj_slot_map=jnp.asarray(slots["z"]), latents=jnp.asarray(lat),
        fg_mask=jnp.asarray(fg), timesteps=jnp.asarray(t, jnp.int32),
        noise=jnp.asarray(noise), t_frac=jnp.asarray(t / 1000, jnp.float32),
        training_percent=jnp.float32(0.3), compel_level=2.0,
        compel_batch_mask=jnp.asarray(mask), cls_mix_ranges=jnp.asarray(ranges),
        preserve_loss_scale=jnp.float32(0.5))
    f = lambda a: torch.tensor(np.asarray(a, np.float32))
    p = tts.ComposBatch(
        token_ids=ids, slot_maps=slots, subj_slot_map=slots["z"], latents=f(lat),
        fg_mask=f(fg), timesteps=torch.tensor(t, dtype=torch.int32), noise=f(noise),
        t_frac=f(t / 1000), training_percent=0.3, compel_level=2.0,
        compel_batch_mask=f(mask), cls_mix_ranges=tuple(float(v) for v in ranges),
        preserve_loss_scale=0.5)
    return j, p


def _zs_compos_batch(pipe):
    """A zero-shot compos batch at CB 2 with annealed embedding noise and the
    bg generator's dropout on."""
    rng = np.random.default_rng(4)
    bases = [f"a photo of a z{Z_SLOTS} with background y{Y_SLOTS}",
             f"the close-up z{Z_SLOTS} in a garden y{Y_SLOTS}"]
    cls = [b.replace(" z", " person") for b in bases]
    prompts = bases + [b + " riding a bike" for b in bases] + cls + [c + " riding a bike"
                                                                     for c in cls]
    ids = pipe.tokenizer(prompts)
    slots = pipe.embedding_manager.build_slot_maps(ids)
    x = _inputs(rng, 2)
    fg, _ = _masks(2)
    t = np.array([880, 640])
    f = lambda a: torch.tensor(np.asarray(a, np.float32))
    return tts.ZeroShotComposBatch(
        token_ids=ids, slot_maps=slots, subj_slot_map=slots["z"], latents=f(x["lat"]),
        fg_mask=f(fg), timesteps=torch.tensor(t, dtype=torch.int32), noise=f(x["noise"]),
        t_frac=f(t / 1000.0), training_percent=0.3, clip_fg=f(x["clip_fg"]),
        clip_bg=f(x["clip_bg"]), id_embs=f(x["ids"]), emb_noise_std=0.05, emb_noise_seed=7,
        dropout_seed=11, cls_mix_ranges=(1.0, 0.8, 1.0, 0.6), preserve_loss_scale=0.5)


@pytest.fixture(scope="module")
def zs_args():
    """The zero-shot compos step's arguments on a port-only stack at
    `test_torch_zs_train`'s sizes, from seeded weights (the test holds the
    port against itself): the pipeline with the fg `z` and bg `y`
    generators, the live generators (the bg one's latent queries scaled up
    x30, so that its gradients are not noise), a frozen copy perturbed by
    20%, the Arc2Face text encoder, the templates, the batch and the
    step's weights."""
    from adaface_tpu_torch.data.tokenizer import HashTokenizer
    from adaface_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
    from adaface_tpu_torch.models.unet import UNetConfig
    from adaface_tpu_torch.models.vae import VAEConfig
    from adaface_tpu_torch.personalization.arc2face import (FORWARD_TEMPLATE, INVERSE_TEMPLATE,
                                                            make_template_ids)
    from adaface_tpu_torch.personalization.subj_basis_generator import SubjBasisGenerator
    from adaface_tpu_torch.pipeline import StableDiffusionPipeline, build_random

    tok = HashTokenizer()
    clip_cfg = CLIPTextConfig(**dict(TXT_KW, vocab_size=tok.vocab_size, num_extra_tokens=8))
    pipe = StableDiffusionPipeline.from_random(0, tok, UNetConfig(**UNET_KW),
                                               VAEConfig(**VAE_KW), clip_cfg, device="cpu")
    gens = {"z": build_random(lambda: SubjBasisGenerator(
                **_gen_kw(False), proj_cfg=CLIPTextConfig(**TXT_KW)), 2, "cpu"),
            "y": build_random(lambda: SubjBasisGenerator(**_gen_kw(True)), 3, "cpu")}
    with torch.no_grad():
        gens["y"].latent_queries.mul_(30.0)
    frozen = copy.deepcopy(gens)
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for s in sorted(frozen):
            for p in frozen[s].parameters():
                p.mul_(1 + 0.2 * torch.randn(p.shape, generator=g))
            frozen[s].requires_grad_(False)
    for s, bg in (("z", False), ("y", True)):
        pipe.embedding_manager.add_zero_shot_placeholder(s, tok.add_placeholder(s), gens[s],
                                                         is_background=bg)
    arc = build_random(lambda: CLIPTextEncoder(CLIPTextConfig(**TXT_KW)), 1, "cpu")
    templates = tts.ZeroShotTemplates(make_template_ids(tok, FORWARD_TEMPLATE),
                                      make_template_ids(tok, INVERSE_TEMPLATE),
                                      int(tok.encode("id")[0]))
    batch = _zs_compos_batch(pipe)
    kw = dict(prompt_delta_weight=0.5, mix_prompt_distill_weight=0.5, xlayer_weight=0.5)
    assert D == pipe.clip.cfg.hidden_size
    return (pipe, gens, frozen, arc, templates, batch, kw)


def _logdir(argv):
    return argv[argv.index("--logdir") + 1]


def _runs(subject, reg, root):
    """The `train.main` runs of the ranks (name -> argv at dp 2) and of one
    process (name -> argv at batch 2, or both DreamBooth pairs)."""
    db = ["--dreambooth", "--base", DB, "--data_root", subject, "--reg_data_root", reg,
          "--tiny", "--max_steps", "2", "--size", "32", "--lr", "0.001"]
    dp = {"recon": _recon_argv(subject, os.path.join(root, "recon2"), 1,
                               ADAMW + ("--num_devices", "2")),
          "zeroshot": _recon_argv(subject, os.path.join(root, "zs2"), 1,
                                  ["--zeroshot", "--num_devices", "2"]),
          "dreambooth": db + ["--num_devices", "2", "--logdir", os.path.join(root, "db2")]}
    one = {"recon": _recon_argv(subject, os.path.join(root, "recon1"), 2, ADAMW),
           "zeroshot": _recon_argv(subject, os.path.join(root, "zs1"), 2, ["--zeroshot"]),
           "dreambooth": db + ["--logdir", os.path.join(root, "db1")]}
    return dp, one


@pytest.fixture(scope="module")
def ranks(pipes, subject, reg, zs_args, tmp_path_factory):  # noqa: F811
    """The two ranks of `torch_dp_workers.suite_trainer`, started in the
    background: the compos step at CB 2 on the port pipeline (the JAX
    pipeline's weights), the zero-shot compos step, a filtered compos
    iteration, a dp-2 trainer to its resumable state and on, and the
    `train.main` runs. `.result()` waits for them (one thread a rank, the
    launch bounded at 600 s); `.runs` are the ranks' argvs."""
    jp, tp = pipes
    _, pb = _compos_batches(jp, np.random.default_rng(21))
    root = str(tmp_path_factory.mktemp("dp2"))
    kw = dict(STEP_KW, **REG_KW)
    dp, _ = _runs(subject, reg, root)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(pmesh.launch, w.suite_trainer, 2, (tp, pb, kw, zs_args, subject, root, dp),
                      device="cpu", threads=1, timeout=600)
    yield types.SimpleNamespace(result=fut.result, runs=dp)
    pool.shutdown(wait=True)


def test_trainer_dp2_matches_dp1(subject, reg, ranks, tmp_path):
    _, one_runs = _runs(subject, reg, str(tmp_path))
    assert ttrain.main(one_runs["recon"], device="cpu") == 0
    r0 = ranks.result()[0]
    assert r0["main"]["recon"] == 0
    one, two = _logdir(one_runs["recon"]), _logdir(ranks.runs["recon"])
    a = np.load(os.path.join(one, "embeddings_last.npz"))
    b = np.load(os.path.join(two, "embeddings_last.npz"))
    keys = [k for k in a.files if a[k].dtype.kind == "f"]
    assert sorted(keys) == sorted(k for k in b.files if b[k].dtype.kind == "f")
    assert max(float(np.abs(a[k] - b[k]).max()) for k in keys) < TOL
    assert max(float(np.abs(a[k]).max()) for k in keys) > 0
    # rank 0 alone wrote the metrics: 2 records, the global losses of dp 1
    ra, rb = _iter_records(one), _iter_records(two)
    assert [r["step"] for r in rb] == [0, 1]
    for x, y in zip(ra, rb):
        assert y["recon"] == pytest.approx(x["recon"], rel=1e-5)
        assert y["loss"] == pytest.approx(x["loss"], rel=1e-5)


def test_zero_shot_trainer_dp2_matches_dp1(subject, reg, ranks, tmp_path):
    _, one_runs = _runs(subject, reg, str(tmp_path))
    assert ttrain.main(one_runs["zeroshot"], device="cpu") == 0
    r0 = ranks.result()[0]
    assert r0["main"]["zeroshot"] == 0
    one, two = _logdir(one_runs["zeroshot"]), _logdir(ranks.runs["zeroshot"])
    a = torch.load(os.path.join(one, "subj_basis_last.pt"), weights_only=True)
    b = torch.load(os.path.join(two, "subj_basis_last.pt"), weights_only=True)
    assert a["global_step"] == b["global_step"] == 2
    moved = 0.0
    for s in a["generators"]:
        for k, v in a["generators"][s].items():
            np.testing.assert_allclose(b["generators"][s][k].numpy(), v.numpy(), rtol=0,
                                       atol=TOL, err_msg=f"{s}/{k}")
            moved = max(moved, float((v - a["frozen_generators"][s][k]).abs().max()))
    assert moved > 0
    ia, ib = a["optimizer"]["inner"], b["optimizer"]["inner"]
    # Prodigy's d numerator: gradient products summed over every element
    # of every rank (0 after the first step, where p == p0)
    assert abs(float(ia["d_numerator"])) > 0
    np.testing.assert_allclose(float(ib["d_numerator"]), float(ia["d_numerator"]), rtol=1e-4)
    # the ZeRO-1 state is gathered whole into the checkpoint
    for n in ("exp_avg", "exp_avg_sq", "s", "p0"):
        for x, y in zip(ia[n], ib[n]):
            assert x.shape == y.shape
    ra, rb = _iter_records(one), _iter_records(two)
    assert len(rb) == 2
    for x, y in zip(ra, rb):
        assert y["loss"] == pytest.approx(x["loss"], rel=1e-5)


def test_compos_step_at_cb2_over_two_ranks_matches_jax(pipes, ranks):  # noqa: F811
    jp, _ = pipes
    jb, _ = _compos_batches(jp, np.random.default_rng(21))
    kw = dict(STEP_KW, **REG_KW)
    (_, jmetrics), jgrads = _jax_compos_value_and_grad(jp, kw, True)(
        jp.embedding_manager.embedders, jb)
    for r in ranks.result():
        metrics, grads = r["compos"]
        assert set(metrics) == set(jmetrics)
        for k in sorted(metrics):
            assert abs(float(jmetrics[k])) > 0, k
            np.testing.assert_allclose(metrics[k], float(jmetrics[k]), rtol=RTOL, atol=1e-7,
                                       err_msg=k)
        for k, g in grads.items():
            s, name = k.split("/")
            ref = np.asarray(getattr(jgrads[s], name))
            scale = float(np.abs(ref).max())
            assert scale > 0, k
            assert float(np.abs(g - ref).max()) <= 2e-4 * scale, k


def test_zero_shot_compos_step_at_cb2_over_two_ranks(zs_args, ranks):
    """The zero-shot compos step at CB 2 over 2 ranks (one block a rank),
    with annealed embedding noise and the bg generator's dropout on (both
    drawn at the global batch: the noise's std over it too), against one
    process's step on both blocks: every metric 1e-5 relative, every
    generator gradient 1e-4 of its leaf's largest entry (the zero-shot
    step tests' tolerances)."""
    ref_metrics, ref_grads = w.zs_compos_value_and_grad(*zs_args)
    top = max(float(np.abs(g).max()) for g in ref_grads.values())
    assert top > 0
    for r in ranks.result():
        metrics, grads = r["zs_compos"]
        assert set(metrics) == set(ref_metrics)
        for k, v in ref_metrics.items():
            np.testing.assert_allclose(metrics[k], v, rtol=RTOL, atol=1e-7, err_msg=k)
        for k, ref in ref_grads.items():
            scale = float(np.abs(ref).max())
            if scale < 1e-6 * top:  # zero but for round-off on both sides
                assert float(np.abs(grads[k]).max()) < 1e-6 * top, k
                continue
            assert float(np.abs(grads[k] - ref).max()) <= 1e-4 * scale, k


def test_teacher_filter_over_two_ranks(subject, ranks, tmp_path):
    """A filtered compos iteration at CB 2: each rank denoises and scores its
    own block's candidates; the gathered CLIP losses give every rank the
    one process's verdicts, chosen noise and timesteps, and the same
    reuse-init cache (the stand-in scorer reads each image's mean)."""
    ref_choice, ref_cache = w.filtered_compos(subject, str(tmp_path))
    for r in ranks.result():
        choice, cache = r["filter"]
        assert (choice is None) == (ref_choice is None)
        if choice is not None:
            np.testing.assert_array_equal(choice[1], ref_choice[1])
            np.testing.assert_allclose(choice[0], ref_choice[0], rtol=0, atol=0)
        assert sorted(cache) == sorted(ref_cache) and ref_cache
        for k in cache:
            scale = float(np.abs(ref_cache[k]).max())
            np.testing.assert_allclose(cache[k], ref_cache[k], rtol=0, atol=1e-5 * scale)


def test_dp2_state_resumes_at_dp1(subject, ranks, tmp_path):
    """The dp-2 run's state (step 2 of 4; whole optimizer state, written
    once by rank 0) resumed by one process at batch 2 ends where the dp-2
    run ended."""
    r0, r1 = ranks.result()
    assert r0["state"] == r1["state"] and os.path.exists(r0["state"])
    tr = w.build_trainer(subject, str(tmp_path), batch_size=2)
    tr.load_state(r0["state"])
    assert tr.global_step == 2
    tr.fit(4)
    tr.close()
    got = w.leaves(tr.mgr.embedders)
    for k, v in r0["leaves"].items():
        assert float(np.abs(got[k] - v).max()) < TOL, k
        np.testing.assert_array_equal(r1["leaves"][k], v)  # replicated


def test_dreambooth_over_two_ranks(subject, reg, ranks, tmp_path, monkeypatch):
    _, one_runs = _runs(subject, reg, str(tmp_path))
    # one process running the ranks' two (train, reg) pairs a step: the
    # loop draws a pair a device, and here sees two devices without a mesh
    shim = types.SimpleNamespace(**{k: getattr(pmesh, k) for k in dir(pmesh)
                                    if not k.startswith("__")})
    shim.dp_of = lambda mesh: 2 if mesh is None else mesh.dp
    monkeypatch.setattr(ttrain, "pmesh", shim)
    assert ttrain.main(one_runs["dreambooth"], device="cpu") == 0
    assert ranks.result()[0]["main"]["dreambooth"] == 0
    a = np.load(os.path.join(_logdir(one_runs["dreambooth"]), "embeddings_last.npz"))
    b = np.load(os.path.join(_logdir(ranks.runs["dreambooth"]), "embeddings_last.npz"))
    keys = [k for k in a.files if a[k].dtype.kind == "f"]
    assert keys and max(float(np.abs(a[k] - b[k]).max()) for k in keys) < TOL


def test_more_ranks_than_cards_exit_naming_the_count(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="has 1 CUDA device"):
        ttrain.num_ranks(2, torch.device("cuda"))
    assert ttrain.num_ranks(-1, torch.device("cuda")) == 1
    assert ttrain.num_ranks(-1, torch.device("cpu")) == 1
    assert jax.devices()  # the JAX side of this file runs on conftest's CPU devices
