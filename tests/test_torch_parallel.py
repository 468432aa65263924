"""Data and tensor parallelism of the port (`adaface_tpu_torch/parallel/mesh.py`)
against the JAX package's `parallel/mesh.py`, fp32 on the CPU.

- The rules, on the same trees: ZeRO-1 (`zero1_sharding_rules`: the dim each
  optimizer-state leaf shards on), batch slicing (`train_batch_shardings`
  on JAX's and the port's batch NamedTuples, DreamBooth's nested one
  included), and tensor parallelism (`param_sharding_rules` on the tiny
  UNet); JAX's meshes come from conftest's 8 virtual CPU devices.
- Two gloo ranks (`mesh.launch`, spawn context, a FileStore in a temporary
  directory, one thread each, a bounded join) run, in one launch: two
  ZeRO-1 Prodigy steps of the JAX mesh test's 1024x256 problem (against
  JAX's replicated `prodigy`; each rank keeps half the state);
  `masked_recon_loss` with unequal mask sums per rank (its value and
  gradient against one process; each rank's own ratio, averaged, reads
  outside the tolerance); `generate`, `img2img` and `inpaint` at dp 2 and
  `generate` at tp 2 against one device.

Tolerances: Prodigy 1e-6 (the JAX mesh test's); the recon loss 1e-6
relative, its gradient 1e-6 of the largest entry (sums in another order);
images 1 uint8 level (the JAX mesh test's: float reassociation across
shards)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from adaface_tpu.parallel import mesh as jmesh
from adaface_tpu.training import train_step as jts
from adaface_tpu.training.prodigy import prodigy as j_prodigy

from adaface_tpu_torch.img2img import inpaint
from adaface_tpu_torch.parallel import mesh as pmesh
from adaface_tpu_torch.training import losses as tl
from adaface_tpu_torch.training import train_step as tts

import torch_dp_workers as w

torch.set_num_threads(2)


def _port_mesh(dp, tp=1):
    """A port mesh object for the rules alone (no process group)."""
    return pmesh.Mesh(dp, tp, 0, torch.device("cpu"))


def _jax_dim(sharding, axis="dp"):
    spec = tuple(sharding.spec)
    return spec.index(axis) if axis in spec else None


@pytest.fixture(scope="module")
def ranks():
    """The two ranks' results of `torch_dp_workers.suite_parallel`."""
    return pmesh.launch(w.suite_parallel, 2, device="cpu", threads=1, timeout=300)


# ------------------------------------------------------------------- rules
@pytest.mark.parametrize("n", [2, 4, 8])
def test_zero1_rules_match_jax(n):
    state = {"big": np.zeros((1024, 384)), "odd": np.zeros((1023, 8 * 13)),
             "tiny": np.zeros((4, 4)), "scalar": np.zeros(()),
             "tie": np.zeros((512, 512)), "gen": np.zeros((768, 96, 4)),
             "row": np.zeros((65536,)), "under": np.zeros((255, 257))}
    jr = jmesh.zero1_sharding_rules(jmesh.make_mesh(n), {k: jnp.asarray(v)
                                                         for k, v in state.items()})
    pr = pmesh.zero1_sharding_rules(_port_mesh(n), state)
    assert {k: _jax_dim(v) for k, v in jr.items()} == pr
    assert pr["tie"] == 1 and pr["tiny"] is None  # JAX's max picks the last of equals


def _jax_batches(B):
    """JAX train batches of every kind at global batch B (CB = B blocks)."""
    z = lambda *s: jnp.zeros(s)
    slots = {"z": z(B, 77), "y": z(B, 77)}
    recon = jts.ReconBatch(latents=z(B, 4, 4, 4), token_ids=z(B, 77), slot_maps=slots,
                           fg_mask=z(B, 4, 4, 1), timesteps=z(B), noise=z(B, 4, 4, 4),
                           img_mask=z(B, 4, 4, 1), skip_weights=z(2),
                           emb_noise_std=jnp.float32(0.1), emb_noise_key=z(2),
                           delta_token_ids=z(4 * B, 77),
                           delta_slot_maps={"z": z(4 * B, 77)})
    compos = jts.ComposBatch(
        token_ids=z(4 * B, 77), slot_maps={"z": z(4 * B, 77)}, subj_slot_map=z(4 * B, 77),
        latents=z(B, 4, 4, 4), fg_mask=z(B, 4, 4, 1), timesteps=z(B), noise=z(B, 4, 4, 4),
        t_frac=z(B), training_percent=jnp.float32(0.3), compel_level=jnp.float32(2.0),
        compel_batch_mask=z(4 * B), cls_mix_ranges=z(4), preserve_loss_scale=0.5)
    a2f = jts.Arc2FaceBatch(latents=z(B, 4, 4, 4), teacher_context=z(B, 77, 8),
                            token_ids=z(B, 77), slot_maps=slots, timesteps=z(B),
                            noises=z(3, B, 4, 4, 4), relative_ts=z(2, B),
                            fg_mask=z(B, 4, 4, 1))
    db = jts.DreamBoothBatch(train=recon, reg=recon)
    return {"recon": recon, "compos": compos, "a2f": a2f, "db": db}


def _dims_tree(tree):
    """A NamedTuple of shardings / dims as nested dicts of dims."""
    out = {}
    for k, v in tree._asdict().items():
        if hasattr(v, "_asdict"):
            out[k] = _dims_tree(v)
        else:
            out[k] = jax.tree_util.tree_map(
                lambda s: _jax_dim(s) if hasattr(s, "spec") else s, v,
                is_leaf=lambda x: x is None)
    return out


@pytest.mark.parametrize("kind", ["recon", "compos", "a2f", "db"])
@pytest.mark.parametrize("B", [1, 2, 4])
def test_batch_slicing_rule_matches_jax(kind, B):
    batch = _jax_batches(B)[kind]
    jr = _dims_tree(jmesh.train_batch_shardings(jmesh.make_mesh(2), batch))
    pr = _dims_tree(pmesh.train_batch_shardings(_port_mesh(2), batch))
    assert jr == pr


def test_port_batches_slice_by_blocks():
    """A compos batch at CB 2 over 2 ranks: each rank keeps its block of
    every prompt type (rows b, CB + b, 2 CB + b, 3 CB + b), not JAX's
    contiguous device layout, and its own noise row; the replicated knobs
    stay whole."""
    CB, T = 2, 5
    ids = np.arange(4 * CB * T).reshape(4 * CB, T)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    b = tts.ComposBatch(token_ids=ids, slot_maps={"z": ids}, subj_slot_map=ids,
                        latents=t(np.arange(CB)[:, None, None, None] * np.ones((1, 2, 2, 4))),
                        fg_mask=None, timesteps=t(np.arange(CB)), noise=t(np.arange(CB)),
                        t_frac=t(np.arange(CB)), training_percent=0.3,
                        compel_batch_mask=t(np.arange(4 * CB)),
                        cls_mix_ranges=(1.0, 1.0, 1.0, 0.85), skip_weights=t([0.3, 0.7]))
    for r in range(2):
        m = pmesh.Mesh(2, 1, r, torch.device("cpu"))
        s = pmesh.shard_train_batch(m, b)
        rows = [r, CB + r, 2 * CB + r, 3 * CB + r]
        np.testing.assert_array_equal(s.token_ids, ids[rows])
        np.testing.assert_array_equal(s.slot_maps["z"], ids[rows])
        np.testing.assert_array_equal(s.compel_batch_mask.numpy(), rows)
        assert s.latents.shape[0] == 1 and float(s.latents[0, 0, 0, 0]) == r
        assert float(s.noise[0]) == r and s.cls_mix_ranges == b.cls_mix_ranges
        assert torch.equal(s.skip_weights, b.skip_weights)


def test_param_rules_match_jax():
    """`param_sharding_rules` on the tiny UNet: JAX's flax tree against the
    port's state dict (a flax kernel [in, out] is a torch weight [out, in]:
    JAX's column split, P(None, 'tp'), is the port's dim 0)."""
    from adaface_tpu.models.unet import UNetConfig as JUNetConfig
    from adaface_tpu.models.unet import UNetModel as JUNet

    from adaface_tpu_torch.interop.from_jax import state_dict_from_jax

    cfg = JUNetConfig(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                      attention_levels=(0, 1), num_heads=4, context_dim=16)
    # the rules read names and ranks alone: the tree's shapes, not its values
    params = jax.eval_shape(lambda: JUNet(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 1, 7, 16))))["params"]
    jr = jmesh.param_sharding_rules(jmesh.make_mesh(2, dp=1, tp=2), params)
    flat = jax.tree_util.tree_flatten_with_path(jr)[0]
    sd = state_dict_from_jax(jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), params))
    pr = pmesh.param_sharding_rules(_port_mesh(1, 2), sd)
    seen = {0: 0, 1: 0}
    for path, sh in flat:
        keys = [str(getattr(p, "key", p)) for p in path]
        name = ".".join(keys[:-1] + ["weight" if keys[-1] == "kernel" else keys[-1]])
        if keys[-1] == "kernel" and sd[name].dim() == 2:
            jd = {0: 1, 1: 0}.get(_jax_dim(sh, "tp"))  # flax [in, out] -> torch [out, in]
            assert pr[name] == jd, name
            if jd is not None:
                seen[jd] += 1
    assert seen[0] > 0 and seen[1] > 0


def test_tp_split_keeps_geglu_halves_together():
    """Rank 1 of tp 2 keeps the second half of the GEGLU value rows AND of
    the gate rows of `ff_in` (a contiguous split would give it every gate),
    and whole heads of q/k/v."""
    from adaface_tpu_torch.models.unet import shard_unet_tp

    pipe = w.tiny_pipeline(placeholders=False)
    blk = pipe.unet.down_0_attn_0.block_0
    w_in, b_in = blk.ff_in.weight.clone(), blk.ff_in.bias.clone()
    q = blk.attn1.to_q.weight.clone()
    shard_unet_tp(pipe.unet, pmesh.Mesh(1, 2, 1, torch.device("cpu")))
    f = w_in.shape[0] // 2
    _, w_l, b_l, w_out = blk.tp_ff
    assert torch.equal(w_l, torch.cat([w_in[f // 2:f], w_in[f + f // 2:]]))
    assert torch.equal(b_l, torch.cat([b_in[f // 2:f], b_in[f + f // 2:]]))
    assert w_out.shape[1] == f // 2
    assert blk.attn1.num_heads == 2 and torch.equal(blk.attn1.to_q.weight, q[q.shape[0] // 2:])
    with pytest.raises(ValueError, match="do not split"):
        shard_unet_tp(w.tiny_pipeline(placeholders=False).unet,
                      pmesh.Mesh(1, 3, 0, torch.device("cpu")))


def test_make_mesh_refuses_as_jax_does():
    with pytest.raises(ValueError, match=r"dp\(2\) \* tp\(2\) != devices\(2\)"):
        pmesh.make_mesh(2, dp=2, tp=2)
    with pytest.raises(ValueError, match="start 2 ranks"):
        pmesh.make_mesh(2)
    assert not pmesh.in_group()  # no group was left behind


# ------------------------------------------------------------- two ranks
def _jax_prodigy(w0, steps=2):
    opt = j_prodigy(learning_rate=1.0, d_coef=10.0)
    p = {"w": jnp.asarray(w0)}
    s = opt.init(p)
    for _ in range(steps):
        g = jax.grad(lambda q: jnp.mean((q["w"] - 1.0) ** 2))(p)
        u, s = opt.update(g, s, p)
        p = optax.apply_updates(p, u)
    return np.asarray(p["w"])


def test_zero1_prodigy_step_matches_jax(ranks):
    """Two ZeRO-1 Prodigy updates over 2 ranks equal JAX's replicated
    `prodigy` (1e-6); each rank holds half of the four state slabs and
    `state_dict` gives the whole ones."""
    ref = _jax_prodigy(w.prodigy_problem())
    _, full_bytes, _, _ = w.prodigy_step(w.prodigy_problem())
    for r in ranks:
        got, nbytes, shape, _ = r["prodigy"]
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
        assert nbytes * 2 == full_bytes and shape == (1024, 256)
    assert ranks[0]["prodigy"][3] == ranks[1]["prodigy"][3]  # the same d on both


def test_zero1_adamw_behind_clip_and_accumulation(ranks):
    """AdamW behind the global-norm clip and the accumulation, ZeRO-1 over
    2 ranks: the accumulation and the moments keep half of the leaf, the
    clip's norm and the update equal one process's (1e-6)."""
    ref, acc_shape, _ = w.chain_steps(w.prodigy_problem())
    assert acc_shape == (1024, 256)
    for r in ranks:
        got, acc, full = r["chain"]
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
        assert acc == (512, 256) and full == (1024, 256)


def test_masked_recon_loss_is_global_at_dp2(ranks):
    """The ranks' masked recon loss and gradient (their halves, unequal mask
    sums) equal one process's over the whole batch; each rank's own ratio,
    averaged as a plain all-reduce of local means would, reads outside."""
    pred, target, fg, img = w.recon_inputs()
    loss, grad = w.recon_value_and_grad(pred, target, fg, img)
    scale = np.abs(grad).max()
    for r in ranks:
        np.testing.assert_allclose(r["recon"][0], loss, rtol=1e-6)
        np.testing.assert_allclose(r["recon"][1], grad, rtol=0, atol=1e-6 * scale)
    halves = [w.recon_value_and_grad(*(a[i:i + 2] for a in (pred, target, fg, img)))
              for i in (0, 2)]
    local_loss = np.mean([h[0] for h in halves])
    local_grad = np.concatenate([h[1] for h in halves]) / 2
    assert abs(local_loss - loss) > 1e-3 * abs(loss)
    assert np.abs(local_grad - grad).max() > 1e-2 * scale
    # the plain mean (no masks) is global too
    t = lambda a: torch.tensor(a)
    assert float(tl.masked_recon_loss(t(pred), t(target))) == pytest.approx(
        float(np.mean((pred - target) ** 2)), rel=1e-6)


def test_generate_dp2_and_tp2_within_one_level(ranks):
    """generate at dp 2 (each rank 2 of the 4 rows of one x_T draw) and at
    tp 2 (2 of the 4 heads a rank, the feed-forward split by GEGLU halves),
    img2img and inpaint at dp 2: within 1 uint8 level of one device, the
    whole batch on every rank."""
    pipe = w.tiny_pipeline(placeholders=False)
    init = np.random.default_rng(4).integers(0, 255, (32, 32, 3)).astype(np.uint8)
    mask = np.zeros((32, 32), np.float32)
    mask[8:24, 8:24] = 1.0
    ref = {"generate": w.serve(pipe),
           "img2img": pipe.img2img(init, w.SERVE_PROMPTS, strength=0.5, num_steps=4),
           "inpaint": inpaint(pipe, init, mask, w.SERVE_PROMPTS, num_steps=2)}
    for r in ranks:
        for k, v in ref.items():
            assert r["dp"][k].shape == v.shape, k
            assert np.abs(r["dp"][k].astype(int) - v.astype(int)).max() <= 1, k
        assert r["tp"]["heads"] == 2
        assert np.abs(r["tp"]["generate"].astype(int) - ref["generate"].astype(int)).max() <= 1
    assert np.array_equal(ranks[0]["dp"]["generate"], ranks[1]["dp"]["generate"])


def test_launch_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 failed:(.|\n)*planted failure"):
        pmesh.launch(w.fails_on_rank1, 2, device="cpu", threads=1, timeout=120)
