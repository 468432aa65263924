"""Port parity of the UNet's fused-kernel configuration, fp32 on the CPU:
`ADAFACE_GN_MAX_ELEMS` large enough for every GroupNorm+SiLU site and
`ADAFACE_FUSED_FF=1`, on the tiny pipeline of `test_torch_train_step.py`
(same weights on both sides through `interop.from_jax`).

The JAX side reads its GroupNorm threshold once, at import, so the tests set
`adaface_tpu.ops.fused_norm._MAX_BLOCK_ELEMS`; both kernels run in Pallas
interpret mode. The port, on CPU tensors, runs the kernels' plain versions;
spies count them, so the tests also show which sites took the kernels:
the tiny UNet (8 ResBlocks, 7 transformer blocks) has 17 GroupNorm+SiLU
sites and, in a recon step, captures at 2 of its 7 transformer blocks.

Tolerances as in `test_torch_models.py` and `test_torch_train_step.py`: eps
2e-5 absolute; recon metrics 1e-5 relative, embedder gradients 2e-4 of each
leaf's largest entry (fp32 sums in other orders in XLA and torch)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import adaface_tpu.ops.fused_norm as jfn
from adaface_tpu.models.unet import precompute_cross_kv as j_cross_kv

from adaface_tpu_torch.interop import from_jax
from adaface_tpu_torch.models.unet import UNetConfig, UNetModel, precompute_cross_kv
from adaface_tpu_torch.ops import fused_ff as tff
from adaface_tpu_torch.ops import fused_norm as tfn
from adaface_tpu_torch.training import train_step as tts

from test_torch_train_step import (STEP_KW, UNET_KW, _assert_grads_close, _batch,  # noqa: F401
                                   _port_embedders, jax_value_and_grad, pipes)

torch.set_num_threads(2)

GN_MAX = 4194304  # the fused configuration's threshold: every site passes
GN_SITES, FF_BLOCKS = 17, 7


@pytest.fixture(scope="module")
def fused():
    """Both knobs on, for every test of this module that asks."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ADAFACE_GN_MAX_ELEMS", str(GN_MAX))
        mp.setenv("ADAFACE_FUSED_FF", "1")
        mp.setattr(jfn, "_MAX_BLOCK_ELEMS", GN_MAX)
        yield


@pytest.fixture
def spy(monkeypatch):
    """Calls of the port's kernel functions (plain versions on the CPU) and
    of the unfused feed-forward arm, by name."""
    calls = {}
    for mod, name in ((tfn, "group_norm_silu_plain"), (tff, "ln_geglu_ff_plain"),
                      (tff, "ln_geglu_ff_unfused")):
        real = getattr(mod, name)
        calls[name] = 0

        def counted(*a, _r=real, _n=name, **k):
            calls[_n] += 1
            return _r(*a, **k)

        monkeypatch.setattr(mod, name, counted)
    return calls


def _unet_inputs(rng):
    """CFG batch of 2 (cond; uncond) at a 16x16 latent, as generate calls it."""
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.array([981, 981], np.int32)
    ctx = rng.standard_normal((16, 4, 7, 64)).astype(np.float32)
    return x, t, ctx


def _port_eps(tp, x, t, ctx):
    with torch.no_grad():
        ctx_t = torch.from_numpy(ctx)
        return tp.unet(torch.from_numpy(x), torch.from_numpy(t), ctx_t, cfg_dedup=True,
                       cross_kv=precompute_cross_kv(tp.unet, ctx_t)).numpy()


def _jax_eps(jp, x, t, ctx):
    jkv = j_cross_kv(jp.unet_params, jp.unet.cfg, jnp.asarray(ctx), dtype=jnp.float32)
    return np.asarray(jp.unet.apply({"params": jp.unet_params}, jnp.asarray(x),
                                    jnp.asarray(t), jnp.asarray(ctx), cfg_dedup=True,
                                    cross_kv=jkv))


def test_fused_unet_matches_jax(fused, pipes, spy, rng):
    jp, tp = pipes
    x, t, ctx = _unet_inputs(rng)
    ref = _jax_eps(jp, x, t, ctx)
    got = _port_eps(tp, x, t, ctx)
    assert spy == {"group_norm_silu_plain": GN_SITES, "ln_geglu_ff_plain": FF_BLOCKS,
                   "ln_geglu_ff_unfused": 0}
    assert np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(got, ref, atol=2e-5)


def test_knobs_unset_take_the_default_arms(monkeypatch, pipes, spy, rng):
    """Without the knobs no site reaches a kernel function, and the UNet
    agrees with JAX's default arms."""
    monkeypatch.delenv("ADAFACE_GN_MAX_ELEMS", raising=False)
    monkeypatch.delenv("ADAFACE_FUSED_FF", raising=False)
    monkeypatch.setattr(jfn, "_MAX_BLOCK_ELEMS", 0)
    jp, tp = pipes
    x, t, ctx = _unet_inputs(rng)
    got = _port_eps(tp, x, t, ctx)
    assert spy == {"group_norm_silu_plain": 0, "ln_geglu_ff_plain": 0,
                   "ln_geglu_ff_unfused": FF_BLOCKS}
    np.testing.assert_allclose(got, _jax_eps(jp, x, t, ctx), atol=2e-5)


def test_fused_recon_loss_and_grads_match_jax(fused, pipes, jax_value_and_grad, spy):
    """One recon loss, its metrics and every embedder gradient (capture on,
    so 5 of the 7 blocks fuse) against JAX's `loss_fn` under the same knobs.
    The feed-forward's backward recomputes the plain chain once per fused
    block; the GroupNorm's backward recomputes `_plain`, which the spy does
    not count."""
    jp, tp = pipes
    jb, tb = _batch(jp, np.random.default_rng(0), [501, 120])
    (jloss, jmetrics), jgrads = jax_value_and_grad(jp.embedding_manager.embedders, jb)
    step = tts.make_recon_train_step(tp.clip, tp.unet, tp.base_sched, None, **STEP_KW)
    emb = _port_embedders(tp)
    loss, metrics = step.loss_fn(emb, tb)
    loss.backward()
    assert spy == {"group_norm_silu_plain": GN_SITES, "ln_geglu_ff_plain": 2 * 5,
                   "ln_geglu_ff_unfused": 2}
    assert set(metrics) == set(jmetrics)
    for k in sorted(metrics):
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    _assert_grads_close(emb, jgrads)


def test_strict_load_of_tree_initialised_with_knobs_on(fused, pipes):
    """The fused arms keep the flax parameter paths (`norm3`, `ff_in`,
    `ff_out`), so a JAX UNet initialised with both knobs on loads strictly
    into the port and has the default tree's structure."""
    jp, _ = pipes
    shapes = jax.eval_shape(lambda: jp.unet.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 4)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((16, 1, 7, 64))))["params"]
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    default = jax.tree_util.tree_map(np.asarray, jp.unet_params)
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(default)
    UNetModel(UNetConfig(**UNET_KW)).load_state_dict(
        from_jax.unet_state_dict_from_jax(tree), strict=True)
