"""Port parity of the training building blocks, fp32 on the CPU: the recon
losses (values and gradients), `scale_grad`, `add_noise_to_tensor`,
`distribute_cls_embeddings`, the static-embedder init, the optimizer chain
(Prodigy + global-norm clip + 2-step accumulation against the JAX trainer's
optax chain), AdamW behind the same chain against `optax.adamw`, the EMA
against `adaface_tpu.training.ema`, `perturb_params`, and the native `.npz`
checkpoint read by the other package. Inputs come from numpy with a seed.
Tolerances: 1e-5 absolute on losses of order 0.01..1 and their gradients
(fp32 sums in other orders); Prodigy 1e-5 relative over 6 micro-steps,
AdamW 1e-6 relative over 8, the EMA 1e-6 relative over 20 updates."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from adaface_tpu.ops import grad as jgrad
from adaface_tpu.personalization.embedding_manager import EmbeddingManager as JEM
from adaface_tpu.personalization.static_embedding import (
    StaticEmbedderParams as JParams, init_static_embedder as j_init)
from adaface_tpu.training import losses as jl
from adaface_tpu.training import ema as jema
from adaface_tpu.training.prodigy import prodigy as j_prodigy

from adaface_tpu_torch.ops import grad as tgrad
from adaface_tpu_torch.personalization.embedding_manager import EmbeddingManager
from adaface_tpu_torch.personalization.static_embedding import (
    embedder_leaves, init_static_embedder)
from adaface_tpu_torch.training import losses as tl
from adaface_tpu_torch.training import ema as tema
from adaface_tpu_torch.training.adamw import AdamW
from adaface_tpu_torch.training.prodigy import AccumulatedClipped, Prodigy

torch.set_num_threads(2)
ATOL = 1e-5


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


def _close(got, ref, atol=ATOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(ref), atol=atol, rtol=1e-5, err_msg=msg)


# ------------------------------------------------------------- loss battery
def _scores(rng, b=2, heads=2, t=12):
    """Captured cross-attention scores per distillation layer (grids 8x8,
    4x4 at the mid block, 16x16 on the way up), std 3 like real scores."""
    grid = {7: 8, 8: 8, 12: 4, 16: 8, 17: 8, 18: 8, 19: 16, 20: 16, 21: 16,
            22: 16, 23: 16, 24: 16}
    return {i: (rng.standard_normal((b, heads, s * s, t)) * 3).astype(np.float32)
            for i, s in grid.items()}


def _masks(rng, b=2, t=12):
    subj = np.zeros((b, t), np.float32)
    subj[:, 2:5] = 1
    bg = np.zeros((b, t), np.float32)
    bg[:, 7:9] = 1
    fg = np.zeros((b, 32, 32, 1), np.float32)
    fg[0, 6:20, 8:24] = 1
    fg[1, 10:30, 2:17] = 1
    return subj, bg, fg, np.array([1.0, 0.0], np.float32)


@pytest.mark.parametrize("which", ["complementary", "mb_suppress", "xlayer", "xlayer_no_bg"])
def test_attention_losses_match(rng, which):
    scores = _scores(rng)
    subj, bg, fg, inst = _masks(rng)
    keys = sorted(scores)

    def jfn(*arrs):
        sc = dict(zip(keys, arrs))
        if which == "complementary":
            return jl.fg_bg_complementary_loss(sc, subj, bg, fg, instance_mask=inst)
        if which == "mb_suppress":
            return (jl.fg_mb_suppress_loss(sc, subj, fg, instance_mask=inst),)
        return jl.fg_bg_xlayer_consist_loss(sc, subj, bg if which == "xlayer" else None)

    def tfn(*arrs):
        sc = dict(zip(keys, arrs))
        s_, b_, f_, i_ = (_t(x) for x in (subj, bg, fg, inst))
        if which == "complementary":
            return tl.fg_bg_complementary_loss(sc, s_, b_, f_, instance_mask=i_)
        if which == "mb_suppress":
            return (tl.fg_mb_suppress_loss(sc, s_, f_, instance_mask=i_),)
        return tl.fg_bg_xlayer_consist_loss(sc, s_, b_ if which == "xlayer" else None)

    jargs = [jnp.asarray(scores[k]) for k in keys]
    ref_vals = jfn(*jargs)
    ref_grads = jax.grad(lambda *a: sum(jnp.asarray(v) * (i + 1)
                                        for i, v in enumerate(jfn(*a))),
                         argnums=tuple(range(len(keys))))(*jargs)
    targs = [_t(scores[k], grad=True) for k in keys]
    vals = tfn(*targs)
    for i, (v, r) in enumerate(zip(vals, ref_vals)):
        _close(v, r, msg=f"value {i}")
    total = sum(v * (i + 1) for i, v in enumerate(vals))
    if total.requires_grad:
        total.backward()
    assert any(float(np.abs(np.asarray(g)).max()) > 0 for g in ref_grads)
    for k, a, g in zip(keys, targs, ref_grads):
        got = np.zeros_like(np.asarray(g)) if a.grad is None else a.grad
        _close(got, g, msg=f"grad layer {k}")


def test_recon_and_norm_and_prompt_delta_losses_match(rng):
    b, h, w = 2, 8, 8
    eps = rng.standard_normal((b, h, w, 4)).astype(np.float32)
    tgt = rng.standard_normal((b, h, w, 4)).astype(np.float32)
    fg = (rng.random((b, h, w, 1)) > 0.5).astype(np.float32)
    img = (rng.random((b, h, w, 1)) > 0.2).astype(np.float32)
    ref, ref_g = jax.value_and_grad(lambda e: jl.masked_recon_loss(
        e, tgt, fg, bg_weight=0.1, img_mask=img))(jnp.asarray(eps))
    te = _t(eps, grad=True)
    got = tl.masked_recon_loss(te, _t(tgt), _t(fg), bg_weight=0.1, img_mask=_t(img))
    got.backward()
    _close(got, ref)
    _close(te.grad, ref_g)

    emb = rng.standard_normal((16, 3, 32)).astype(np.float32) * 0.1
    ref, ref_g = jax.value_and_grad(jl.embedding_norm_loss)(jnp.asarray(emb))
    tm = _t(emb, grad=True)
    got = tl.embedding_norm_loss(tm)
    got.backward()
    _close(got, ref)
    _close(tm.grad, ref_g)

    # prompt delta on [L, B, T, D] with per-instance prompt lengths
    L, B, T, D = 4, 3, 10, 16
    arrs = [rng.standard_normal((L, B, T, D)).astype(np.float32) for _ in range(4)]
    single = np.zeros((B, T), np.float32)
    comp = np.zeros((B, T), np.float32)
    for i in range(B):
        single[i, 1:4 + i] = 1
        comp[i, 1:6 + 2 * i] = 1
    ref, ref_g = jax.value_and_grad(
        lambda a, c: jl.prompt_delta_loss(a, c, arrs[2], arrs[3], jnp.asarray(single),
                                          jnp.asarray(comp)),
        argnums=(0, 1))(jnp.asarray(arrs[0]), jnp.asarray(arrs[1]))
    ta, tc = _t(arrs[0], True), _t(arrs[1], True)
    got = tl.prompt_delta_loss(ta, tc, _t(arrs[2]), _t(arrs[3]), _t(single), _t(comp))
    got.backward()
    _close(got, ref)
    _close(ta.grad, ref_g[0])
    _close(tc.grad, ref_g[1])


def test_loss_helpers_match(rng):
    x = rng.standard_normal((2, 5, 6)).astype(np.float32)
    m = rng.random((2, 5, 6)) > 0.4
    iw = np.array([1.0, 0.5], np.float32)
    _close(tl.masked_mean(_t(x), _t(m), axis=(1, 2), keepdims=True, instance_weights=_t(iw)),
           jl.masked_mean(x, m, axis=(1, 2), keepdims=True, instance_weights=iw))
    _close(tl.masked_mean(_t(x), _t(m)), jl.masked_mean(x, m))
    parts = [float(v) for v in rng.random(3) + 0.1]
    _close(tl.normalized_sum([torch.tensor(p) for p in parts]),
           jl.normalized_sum([jnp.asarray(p) for p in parts]))
    grid = rng.random((2, 13, 11)).astype(np.float32)
    _close(tl._bilinear_2tap(_t(grid), 5, 7), jl._bilinear_2tap(grid, 5, 7))
    fg = (rng.random((2, 32, 32, 1)) > 0.9).astype(np.float32)
    for q in (16, 64, 256):
        np.testing.assert_array_equal(tl._resize_fg_mask_to_q(_t(fg), q).numpy(),
                                      np.asarray(jl._resize_fg_mask_to_q(fg, q)))
    a, b = (rng.standard_normal((3, 7)).astype(np.float32) for _ in range(2))
    _close(tl.ortho_subtract(_t(a), _t(b)), jl.ortho_subtract(a, b))


# ---------------------------------------------------------------- ops/grad
def test_scale_grad_matches(rng):
    x = rng.standard_normal((4, 5)).astype(np.float32)
    w = rng.standard_normal((4, 5)).astype(np.float32)
    for alpha in (0.0, 0.4, 1.0):
        ref = jax.grad(lambda a: jnp.sum(jgrad.scale_grad(a, alpha) * w))(jnp.asarray(x))
        tx = _t(x, grad=True)
        out = tgrad.scale_grad(tx, alpha)
        _close(out, x, atol=0)
        if out.requires_grad:
            (out * _t(w)).sum().backward()
        _close(np.zeros_like(x) if tx.grad is None else tx.grad, ref)


def test_add_noise_to_tensor_matches(rng):
    """The same unit noise through both (JAX's from its key, handed to the
    port): relative std from the population std (ddof 0), detached."""
    ts = rng.standard_normal((16, 9, 32)).astype(np.float32) * 0.3
    key = jax.random.PRNGKey(5)
    noise = np.asarray(jax.random.normal(key, ts.shape, jnp.float32))
    w = rng.standard_normal(ts.shape).astype(np.float32)
    ref, ref_g = jax.value_and_grad(lambda a: jnp.sum(
        jgrad.add_noise_to_tensor(key, a, 0.03) * w))(jnp.asarray(ts))
    out_ref = jgrad.add_noise_to_tensor(key, jnp.asarray(ts), 0.03)
    tt = _t(ts, grad=True)
    out = tgrad.add_noise_to_tensor(tt, 0.03, noise=_t(noise))
    _close(out, out_ref)
    (out * _t(w)).sum().backward()
    _close(tt.grad, ref_g)
    # the unbiased std would scale the noise by sqrt(32/31)
    unbiased = ts + noise * 0.03 * ts.std(axis=-1, ddof=1).mean()
    assert np.abs(out.detach().numpy() - unbiased).max() > 1e-7


# ----------------------------------------------------- embedding manager
def test_distribute_cls_embeddings_matches(rng):
    L, B, T, D = 16, 3, 10, 8
    ctx = rng.standard_normal((L, B, T, D)).astype(np.float32)
    sm = np.full((B, T), -1, np.int32)
    sm[0, 2:5] = [0, 1, 2]
    sm[1, 6:9] = [0, 1, 2]   # row 2 has no placeholder: passes through
    ref = JEM.distribute_cls_embeddings(jnp.asarray(ctx), jnp.asarray(sm))
    got = EmbeddingManager.distribute_cls_embeddings(_t(ctx), sm)
    _close(got, ref, atol=0)
    np.testing.assert_array_equal(got[:, 2].numpy(), ctx[:, 2])


@pytest.mark.parametrize("with_words", [False, True])
def test_static_embedder_init_deterministic_parts(rng, with_words):
    """Shapes, pre_vecs, common weights, zero bias, the zeroed last basis
    set and the 1/4 basis norms agree with JAX's init (the random draws
    come from different generators and are not compared)."""
    kw = dict(num_vectors=3, emb_dim=32, rank=5)
    if with_words:
        kw.update(init_vecs=rng.standard_normal((2, 32)).astype(np.float32),
                  init_vec_weights=np.array([0.7, 0.3], np.float32))
    jp = j_init(jax.random.PRNGKey(0), 16, **kw)
    tp = init_static_embedder(torch.Generator().manual_seed(0), 16, **kw)
    for f in dataclasses.fields(JParams):
        a, b = getattr(jp, f.name), getattr(tp, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            assert tuple(b.shape) == a.shape, f.name
    _close(tp.basis_comm_weights, jp.basis_comm_weights, atol=0)
    np.testing.assert_array_equal(tp.bias.numpy(), np.zeros((16, 3, 32)))
    if with_words:
        _close(tp.pre_vecs, jp.pre_vecs, atol=0)
    norms = torch.linalg.norm(tp.basis_vecs, dim=-1)
    np.testing.assert_array_equal(norms[-1].numpy(), 0.0)
    _close(norms[:-1], np.full(norms[:-1].shape, 0.25), atol=1e-6)


def test_native_checkpoint_cross_load(tmp_path):
    jp = j_init(jax.random.PRNGKey(1), 16, num_vectors=3, emb_dim=32, rank=4,
                init_vecs=np.ones((1, 32), np.float32))
    jm = JEM()
    jm.add_placeholder("z", token_id=200, num_vectors=3, embedder=jp)
    jm.add_placeholder("y", token_id=201, num_vectors=2, is_background=True,
                       init_key=jax.random.PRNGKey(2), emb_dim=32, rank=4)
    jm.save_native(str(tmp_path / "jax.npz"))
    tm = EmbeddingManager.load_native(str(tmp_path / "jax.npz"))
    assert tm.placeholders["y"].is_background and not tm.placeholders["z"].is_background
    for s in ("z", "y"):
        assert dataclasses.asdict(tm.placeholders[s]) == dataclasses.asdict(jm.placeholders[s])
        for name, t in embedder_leaves(tm.embedders[s]):
            np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(jm.embedders[s], name)))
    # and back: the port's checkpoint through JAX's loader
    tm.embedders["z"].bias.add_(0.5)
    tm.save_native(str(tmp_path / "port.npz"))
    back = JEM.load_native(str(tmp_path / "port.npz"))
    for s in ("z", "y"):
        assert dataclasses.asdict(back.placeholders[s]) == dataclasses.asdict(jm.placeholders[s])
        for name, t in embedder_leaves(tm.embedders[s]):
            np.testing.assert_array_equal(np.asarray(getattr(back.embedders[s], name)),
                                          t.numpy())
    assert back.embedders["y"].pre_vecs is None


# --------------------------------------------------------------- optimizer
def test_prodigy_clip_accumulate_matches_optax_chain(rng):
    """MultiSteps(chain(clip_by_global_norm(0.5), prodigy(d_coef=10)), 2),
    the JAX trainer's chain, against the port's chain over 6 micro-steps fed
    the same gradients: the parameters after every micro-step."""
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * (0.1 if i % 3 == 0 else 0.6)).astype(np.float32)
              for k, s in shapes.items()} for i in range(6)]
    opt = optax.MultiSteps(optax.chain(optax.clip_by_global_norm(0.5),
                                       j_prodigy(learning_rate=1.0, d_coef=10.0)),
                           every_k_schedule=2)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(jparams)
    tparams = [_t(params[k]) for k in sorted(shapes)]
    topt = AccumulatedClipped(Prodigy(tparams, lr=1.0, d_coef=10.0), 0.5, every_k=2)
    moved = []
    for g in grads:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for p, k in zip(tparams, sorted(shapes)):
            p.grad = _t(g[k])
        moved.append(topt.step())
        for p, k in zip(tparams, sorted(shapes)):
            np.testing.assert_allclose(p.numpy(), np.asarray(jparams[k]), rtol=1e-5,
                                       atol=1e-7)
    assert moved == [False, True] * 3
    assert not np.allclose(tparams[0].numpy(), params["a"])


def test_adamw_clip_accumulate_matches_optax_chain(rng):
    """MultiSteps(chain(clip_by_global_norm(0.5), adamw(lr)), 2), the JAX
    trainer's chain with `use_prodigy` off, against AccumulatedClipped(AdamW)
    over 8 micro-steps fed the same gradients, the rate scaled as `scale_lr`
    scales it (accumulation 2 x 1 device x batch 3 x 4e-3, finetune-ti.yaml's
    rate): the parameters after every micro-step and the moments."""
    lr = 4.0e-3 * 2 * 1 * 3
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * (0.1 if i % 3 == 0 else 0.6)).astype(np.float32)
              for k, s in shapes.items()} for i in range(8)]
    opt = optax.MultiSteps(optax.chain(optax.clip_by_global_norm(0.5), optax.adamw(lr)),
                           every_k_schedule=2)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(jparams)
    keys = sorted(shapes)
    tparams = [_t(params[k]) for k in keys]
    topt = AccumulatedClipped(AdamW(tparams, lr), 0.5, every_k=2)
    moved = []
    for g in grads:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for p, k in zip(tparams, keys):
            p.grad = _t(g[k])
        moved.append(topt.step())
        for p, k in zip(tparams, keys):
            np.testing.assert_allclose(p.numpy(), np.asarray(jparams[k]), rtol=1e-6, atol=0)
    assert moved == [False, True] * 4 and topt.inner.step_count == 4
    adam = state.inner_opt_state[1][0]
    for m, v, k in zip(topt.inner.exp_avg, topt.inner.exp_avg_sq, keys):
        # moments cancel to near 0 in places: 1e-6 of each leaf's largest entry
        for got, ref in ((m, adam.mu[k]), (v, adam.nu[k])):
            ref = np.asarray(ref)
            np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    # optax's weight decay, not torch.optim.AdamW's 1e-2, is in the update
    assert topt.inner.weight_decay == 1e-4


def _embedder_pair(rng, k=3, r=4, d=8):
    arrays = dict(basis_rand_weights=rng.standard_normal((16, k, r)),
                  basis_comm_weights=rng.standard_normal((1, k, r)),
                  basis_vecs=rng.standard_normal((k, r - 1, d)),
                  pre_vecs=rng.standard_normal((k, 1, d)), bias=rng.standard_normal((16, k, d)))
    arrays = {n: a.astype(np.float32) for n, a in arrays.items()}
    from adaface_tpu_torch.personalization.static_embedding import StaticEmbedderParams

    return (JParams(**{n: jnp.asarray(a) for n, a in arrays.items()}),
            StaticEmbedderParams(**{n: _t(a) for n, a in arrays.items()}))


def test_ema_matches_jax(rng):
    """20 updates with the live embedders redrawn each time, decay 0.6 so
    that the warm-up min(decay, (1+n)/(10+n)) gives way to the decay after
    12 updates: the shadow after each update, and the update count."""
    j, t = {}, {}
    for s in ("z", "y"):
        j[s], t[s] = _embedder_pair(rng)
    js, ts = jema.ema_init(j), tema.ema_init(t)
    for _ in range(20):
        for s in ("z", "y"):
            j[s], t[s] = _embedder_pair(rng)
        js, ts = jema.ema_update(js, j, 0.6), tema.ema_update(ts, t, 0.6)
        for s in ("z", "y"):
            for n, v in embedder_leaves(ts.shadow[s]):
                np.testing.assert_allclose(v.numpy(), np.asarray(getattr(js.shadow[s], n)),
                                           rtol=1e-6, atol=1e-7)
    assert ts.num_updates == int(js.num_updates) == 20
    holder = type("Holder", (), {})()
    holder.embedders = t
    with tema.ema_scope(holder, "embedders", ts):
        assert holder.embedders is ts.shadow
    assert holder.embedders is t


def test_perturb_params(rng):
    """Each leaf scaled elementwise by U(1 - r, 1 + r), in place (the
    optimizer's tensors stay the same objects); one seed gives one result,
    another seed another."""
    def fresh():
        r = np.random.default_rng(3)
        return {s: _embedder_pair(r)[1] for s in ("z", "y")}

    ratio = 0.2
    a, b, c, orig = fresh(), fresh(), fresh(), fresh()
    ids = {(s, n): id(v) for s in a for n, v in embedder_leaves(a[s])}
    out = tgrad.perturb_params(torch.Generator().manual_seed(9), a, ratio)
    assert out is a and ids == {(s, n): id(v) for s in a for n, v in embedder_leaves(a[s])}
    tgrad.perturb_params(torch.Generator().manual_seed(9), b, ratio)
    tgrad.perturb_params(torch.Generator().manual_seed(10), c, ratio)
    for s in orig:
        for (n, o), (_, x), (_, y), (_, z) in zip(embedder_leaves(orig[s]), embedder_leaves(a[s]),
                                                   embedder_leaves(b[s]), embedder_leaves(c[s])):
            assert x.shape == o.shape
            f = (x / o).numpy()
            assert f.min() >= 1 - ratio - 1e-6 and f.max() <= 1 + ratio + 1e-6, (s, n)
            assert f.std() > ratio / 4  # spread over the range, not a constant
            torch.testing.assert_close(x, y, rtol=0, atol=0)
            assert not torch.equal(x, z)
