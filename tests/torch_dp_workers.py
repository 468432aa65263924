"""Rank functions and tiny builders of the port's data- and tensor-parallel
tests (`test_torch_parallel.py`, `test_torch_trainer_dp.py`). Spawned ranks
import this module by name, so it imports torch, numpy and the port only
(never jax)."""

import os

import numpy as np
import torch

from adaface_tpu_torch.data import png
from adaface_tpu_torch.data.personalized import PersonalizedDataset, SubjectSpec
from adaface_tpu_torch.data.tokenizer import HashTokenizer
from adaface_tpu_torch.parallel import mesh as pmesh
from adaface_tpu_torch.personalization.static_embedding import embedder_leaves
from adaface_tpu_torch.pipeline import StableDiffusionPipeline
from adaface_tpu_torch.training import losses as tl
from adaface_tpu_torch.training import train_step as tts
from adaface_tpu_torch.training.iter_plan import IterPlanConfig
from adaface_tpu_torch.training.prodigy import Prodigy
from adaface_tpu_torch.training.trainer import Trainer, TrainerConfig

# recon-only plans (no compos, no Arc2Face iteration)
RECON_PLAN = dict(composition_regs_iter_gap=0, do_zero_shot=False,
                  prompt_emb_delta_reg_weight=2e-4, arc2face_distill_iter_prob=0.0)
SERVE_PROMPTS = ["a photo of a cat", "a dog on a beach", "a red car", "a bowl of soup"]


def write_subject(folder: str, n: int = 3, size: int = 48) -> str:
    """n random PNGs, all but the second with a box mask (unequal mask sums
    across instances, and one instance without a real mask)."""
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        png.write(os.path.join(folder, f"{i}.png"),
                  rng.integers(0, 255, (size, size, 3)).astype(np.uint8))
        if i != 1:
            m = np.zeros((size, size), np.uint8)
            m[4 + 3 * i:size - 6, 6:size - 4 - 5 * i] = 255
            png.write(os.path.join(folder, f"{i}_mask.png"), np.repeat(m[:, :, None], 3, 2))
    return folder


def tiny_pipeline(seed: int = 0, placeholders: bool = True) -> StableDiffusionPipeline:
    """The entry points' `--tiny` pipeline on the CPU, with a subject `z` (9
    vectors) and a background `y` (4) drawn from fixed seeds."""
    from adaface_tpu_torch.txt2img import tiny_configs

    tok = HashTokenizer()
    pipe = StableDiffusionPipeline.from_random(seed, tok, device="cpu", **tiny_configs(tok))
    if placeholders:
        D = pipe.clip.cfg.hidden_size
        for i, (s, k, bg) in enumerate((("z", 9, False), ("y", 4, True))):
            pipe.embedding_manager.add_placeholder(
                s, token_id=tok.add_placeholder(s), num_vectors=k, is_background=bg,
                generator=torch.Generator().manual_seed(20 + i), emb_dim=D, rank=4)
    return pipe


def build_trainer(folder: str, logdir: str, batch_size: int, num_devices: int = 1,
                  max_steps: int = 4, **cfg_kw) -> Trainer:
    pipe = tiny_pipeline()
    ds = PersonalizedDataset([SubjectSpec("s", folder)], size=32, seed=0)
    cfg = TrainerConfig(batch_size=batch_size, num_devices=num_devices, max_steps=max_steps,
                        accumulate_grad_batches=1, seed=3, log_every_steps=1000,
                        ckpt_every_steps=1000, logdir=logdir, **cfg_kw)
    return Trainer(pipe, ds, cfg, IterPlanConfig(**RECON_PLAN))


def leaves(embedders) -> dict:
    return {f"{s}/{n}": t.detach().float().numpy().copy()
            for s in sorted(embedders) for n, t in embedder_leaves(embedders[s])}


# ------------------------------------------------------------------- losses
def recon_inputs(b: int = 4, hw: int = 8):
    """(eps_pred, target, fg_mask, img_mask) numpy arrays whose masks differ
    in their sums per instance."""
    rng = np.random.default_rng(7)
    pred = rng.standard_normal((b, hw, hw, 4)).astype(np.float32)
    target = rng.standard_normal((b, hw, hw, 4)).astype(np.float32)
    fg = np.zeros((b, hw, hw, 1), np.float32)
    img = np.ones((b, hw, hw, 1), np.float32)
    for i in range(b):
        fg[i, :2 + 2 * i, :3 + i] = 1.0
        img[i, hw - i:] = 0.0
    return pred, target, fg, img


def recon_value_and_grad(pred, target, fg, img, bg_weight: float = 0.1, mesh=None):
    """masked_recon_loss and its gradient w.r.t. eps_pred, on this rank's
    rows under a dp `mesh` (the gradient averaged over the ranks and
    scattered back into the whole batch, as the trainer's all-reduce does)."""
    idx = None if mesh is None else mesh.local_rows(len(pred))
    sel = (lambda a: a) if idx is None else (lambda a: a[idx])
    p = torch.tensor(sel(pred), requires_grad=True)
    loss = tl.masked_recon_loss(p, torch.tensor(sel(target)), torch.tensor(sel(fg)),
                                bg_weight=bg_weight, img_mask=torch.tensor(sel(img)), mesh=mesh)
    loss.backward()
    g = p.grad
    if idx is not None:
        full = torch.zeros(pred.shape)
        full[torch.as_tensor(idx)] = g
        mesh.all_reduce_mean_([full])
        g = full
    return float(loss.detach()), g.numpy()


# ------------------------------------------------------------------- suites
def prodigy_problem():
    """The JAX mesh test's problem: w [1024, 256] from seed 0, loss
    mean((w - 1)^2)."""
    return np.random.default_rng(0).standard_normal((1024, 256)).astype(np.float32)


def prodigy_step(w0: np.ndarray, steps: int = 2, mesh=None):
    """`steps` Prodigy updates (d_coef 10) of the problem; returns (w, the
    bytes of this rank's state slabs, its state_dict's exp_avg shape)."""
    w = torch.tensor(w0, requires_grad=True)
    opt = Prodigy([w], lr=1.0, d_coef=10.0, mesh=mesh)
    for _ in range(steps):
        w.grad = None
        torch.mean((w - 1.0) ** 2).backward()
        opt.step()
    nbytes = sum(t.numel() * t.element_size()
                 for n in ("exp_avg", "exp_avg_sq", "s", "p0") for t in getattr(opt, n))
    return (w.detach().numpy().copy(), nbytes, tuple(opt.state_dict()["exp_avg"][0].shape),
            float(opt.d))


def chain_steps(w0: np.ndarray, micro_steps: int = 4, mesh=None):
    """AdamW (lr 1e-2) behind the clip (0.01: it clips) and 2-step
    accumulation, `micro_steps` micro-steps of the Prodigy problem with a
    gradient that differs per micro-step; returns (w, the accumulation's
    local slab shape, the state_dict's exp_avg shape)."""
    from adaface_tpu_torch.training.adamw import AdamW
    from adaface_tpu_torch.training.prodigy import AccumulatedClipped

    w = torch.tensor(w0, requires_grad=True)
    opt = AccumulatedClipped(AdamW([w], lr=1e-2, mesh=mesh), 0.01, every_k=2)
    for i in range(micro_steps):
        torch.mean((w - 1.0 - 0.1 * i) ** 2).backward()
        opt.step()
    st = opt.state_dict()
    return (w.detach().numpy().copy(), tuple(opt.acc[0].shape),
            tuple(st["inner"]["exp_avg"][0].shape))


def serve(pipe, **kw):
    return pipe.generate(SERVE_PROMPTS, num_steps=2, height=32, width=32, seed=0, **kw)


def suite_parallel():
    """The rank side of `test_torch_parallel.py` over 2 ranks: ZeRO-1
    Prodigy, the global masked recon loss and its gradient, and generate /
    img2img / inpaint at dp 2 and at tp 2."""
    from adaface_tpu_torch.img2img import inpaint

    mesh = pmesh.make_mesh(2)
    out = {"rank": mesh.rank}
    out["prodigy"] = prodigy_step(prodigy_problem(), mesh=mesh)
    out["chain"] = chain_steps(prodigy_problem(), mesh=mesh)
    out["recon"] = recon_value_and_grad(*recon_inputs(), mesh=mesh)
    pipe = tiny_pipeline(placeholders=False)
    pipe.use_mesh(mesh=mesh)
    init = np.random.default_rng(4).integers(0, 255, (32, 32, 3)).astype(np.uint8)
    mask = np.zeros((32, 32), np.float32)
    mask[8:24, 8:24] = 1.0
    out["dp"] = {"generate": serve(pipe),
                 "img2img": pipe.img2img(init, SERVE_PROMPTS, strength=0.5, num_steps=4),
                 "inpaint": inpaint(pipe, init, mask, SERVE_PROMPTS, num_steps=2)}
    pipe = tiny_pipeline(placeholders=False)
    pipe.use_mesh(2, dp=1, tp=2)
    out["tp"] = {"generate": serve(pipe),
                 "heads": pipe.unet.down_0_attn_0.block_0.attn1.num_heads}
    return out


def fails_on_rank1():
    mesh = pmesh.make_mesh(2)
    if mesh.rank == 1:
        raise RuntimeError("planted failure")
    return mesh.rank


def compos_value_and_grad(pipe, batch, step_kw: dict, mesh=None):
    """The compos loss_fn and the embedders' gradients on this rank's blocks
    under a dp `mesh`, the gradients averaged over dp (as `_with_optimizer`
    does) and the metrics the global ones."""
    step = tts.make_compos_distill_step(pipe.clip, pipe.unet, pipe.base_sched, None,
                                        empty_ctx=pipe.encode_negative("", 1)[0, 0].clone(),
                                        mesh=mesh, **step_kw)
    emb = pipe.embedding_manager.embedders
    params = [t.requires_grad_(True) for s in sorted(emb) for _, t in embedder_leaves(emb[s])]
    loss, metrics = step.loss_fn(emb, pmesh.shard_train_batch(mesh, batch))
    loss.backward()
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
    if mesh is not None:
        mesh.all_reduce_mean_(grads)
    names = [f"{s}/{n}" for s in sorted(emb) for n, _ in embedder_leaves(emb[s])]
    return ({k: float(v.detach()) for k, v in pmesh.metrics_mean(metrics, mesh).items()},
            {n: g.numpy().copy() for n, g in zip(names, grads)})


def zs_compos_value_and_grad(pipe, gens, frozen, arc, templates, batch, step_kw, mesh=None):
    """The zero-shot compos loss and the generators' gradients on this
    rank's blocks under a dp `mesh` (averaged over dp), with the embedding
    noise and the bg generator's dropout drawn at the global batch."""
    for g in gens.values():
        g.zero_grad(set_to_none=True)
    step = tts.make_zero_shot_compos_step(pipe.clip, pipe.unet, pipe.base_sched, None, frozen,
                                          bg_placeholders=frozenset({"y"}), arc2face_encoder=arc,
                                          templates=templates, mesh=mesh, **step_kw)
    loss, metrics = step.loss_fn(gens, pmesh.shard_train_batch(mesh, batch))
    loss.backward()
    names = [(s, n) for s in sorted(gens) for n, _ in gens[s].named_parameters()]
    params = dict(((s, n), p) for s in sorted(gens) for n, p in gens[s].named_parameters())
    grads = [torch.zeros_like(params[k]) if params[k].grad is None else params[k].grad
             for k in names]
    if mesh is not None:
        mesh.all_reduce_mean_(grads)
    return ({k: float(v.detach()) for k, v in pmesh.metrics_mean(metrics, mesh).items()},
            {f"{s}/{n}": g.numpy().copy() for (s, n), g in zip(names, grads)})


class MeanScorer:
    """CLIP-T stand-in, a smooth function of each image's mean (so a rank
    scores its own images as one process scores them): 0.25 + 0.1 sin(3e4
    mean / 255), steep enough that the tiny UNet's subject and class images,
    a few 1e-6 apart in their means, fall on both sides of the filter's
    thresholds."""

    def txt_to_img_similarity(self, prompts, images, reduction="diag"):
        assert reduction == "diag" and len(prompts) == len(images)
        m = np.asarray(images, np.float64).reshape(len(images), -1).mean(1) / 255
        return 0.25 + 0.1 * np.sin(3e4 * m)


def filtered_compos(folder, logdir, blocks: int = 2, mesh=None):
    """A compos iteration of `blocks` blocks through the teacher filter (the
    stand-in scorer): over a dp `mesh`'s ranks (one block a rank), or in one
    process with the trainer's block count set to `blocks`. Returns
    the global batch's chosen noise and timesteps, or None when no block is
    teachable, and the cached reconstructions."""
    from adaface_tpu_torch.training.iter_plan import COMPOS_DISTILL, IterPlan

    dp = pmesh.dp_of(mesh)
    tr = build_trainer(folder, logdir, batch_size=1, num_devices=dp)
    tr.set_teacher_filter(MeanScorer())
    if dp == 1:
        tr._dp = blocks
    plan = IterPlan(iter_type=COMPOS_DISTILL, training_percent=0.3, do_teacher_filter=True,
                    comp_init_fg_from_training_image=True)
    batch = tr.build_compos_batch(plan)
    tr.close()
    cache = {k: v["x_start"] for k, v in tr.cached_inits._store.items()}
    if batch is None:
        return None, cache
    return (batch.noise.numpy(), batch.timesteps.numpy()), cache


def suite_trainer(pipe, batch, step_kw, zs_args, folder, logdir, runs):
    """The rank side of `test_torch_trainer_dp.py` over 2 ranks, in one
    launch: the compos step at CB 2 (one block a rank), the zero-shot compos
    step at CB 2 (`zs_args`), a filtered compos iteration, a dp-2 trainer's
    2 steps, its resumable state and 2 more steps, then `train.main` on
    each argv of `runs` (name -> argv; `--num_devices 2` in a rank trains on
    the ranks' own group). Returns each part's result."""
    from adaface_tpu_torch import train as ttrain

    mesh = pmesh.make_mesh(2)
    out = {"compos": compos_value_and_grad(pipe, batch, step_kw, mesh),
           "zs_compos": zs_compos_value_and_grad(*zs_args, mesh=mesh),
           "filter": filtered_compos(folder, logdir, mesh=mesh)}
    tr = build_trainer(folder, logdir, batch_size=1, num_devices=2)
    tr.fit(2)
    out["state"] = tr.save_state(os.path.join(logdir, "state_2.pt"))
    out["zero1_acc_local"] = [tuple(a.shape) for a in tr.optimizer.acc]
    tr.fit(4)
    tr.close()
    out["leaves"] = leaves(tr.mgr.embedders)
    out["main"] = {name: ttrain.main(argv, device="cpu") for name, argv in runs.items()}
    return out
